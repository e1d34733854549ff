"""Host ms of a tracking step's call (the copies into the graph's static
inputs, the replay's launch and the copies of its outputs): the mean over
the window's fused frames after its traced stretch
(`PipelinedFrontend.records[..]["step_host_ms"]`, from `FusedTrackStep.times`)."""


def read(ctx):
    v = [r["step_host_ms"] for r in ctx.res["records"].values()
         if r and r.get("path") == "fused" and "step_host_ms" in r]
    return sum(v) / len(v) if v else None
