"""Host ms a fused frame waits for the map lock, the mean over the window's
fused frames after its traced stretch (`PipelinedFrontend.records[..]["lock_ms"]`)."""


def read(ctx):
    v = [r["lock_ms"] for r in ctx.res["records"].values()
         if r and r.get("path") == "fused" and "lock_ms" in r]
    return sum(v) / len(v) if v else None
