"""Host ms the tracking thread waits out a busy NMI worker (the front-end's
backpressure after two NMI-due keyframes were skipped), charged to the frame
tracked next: the mean over the window's frames after its traced stretch
(`PipelinedFrontend.records[..]["nmi_wait_ms"]`)."""


def read(ctx):
    v = [r["nmi_wait_ms"] for r in ctx.res["records"].values() if r and "nmi_wait_ms" in r]
    return sum(v) / len(v) if v else None
