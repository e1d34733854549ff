"""Host ms the tracking thread spends making a keyframe (the NMI hand-off,
the keyframe's creation and its insertion in the mapping queue): the mean
over the window's frames after its traced stretch that made one
(`PipelinedFrontend.records[..]["kf_ms"]`)."""


def read(ctx):
    v = [r["kf_ms"] for r in ctx.res["records"].values() if r and "kf_ms" in r]
    return sum(v) / len(v) if v else None
