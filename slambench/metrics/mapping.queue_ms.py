"""Wall ms a keyframe waits in the mapping queue, from its insertion to the
worker taking it: the mean over the keyframes the worker began after the
window's traced stretch and finished in the window
(`LocalMapper.records[..]["queued_ms"]`)."""


def read(ctx):
    v = [r["queued_ms"] for r in ctx.res["mapping"] if "queued_ms" in r]
    return sum(v) / len(v) if v else None
