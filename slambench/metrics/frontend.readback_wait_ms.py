"""Host ms a fused frame waits for its packed readback, the mean over the
window's fused frames after its traced stretch (`PipelinedFrontend.records[..]["wait_ms"]`)."""


def read(ctx):
    v = [r["wait_ms"] for r in ctx.res["records"].values()
         if r and r.get("path") == "fused" and "wait_ms" in r]
    return sum(v) / len(v) if v else None
