"""Wall ms the mapping worker spends on a keyframe, the mean over the
keyframes it began after the window's traced stretch and finished in the
window (`LocalMapper.records[..]["total_ms"]`)."""


def read(ctx):
    v = [r["total_ms"] for r in ctx.res["mapping"] if "total_ms" in r]
    return sum(v) / len(v) if v else None
