"""The point splat's share of its roofline, in %: the bytes each sweep must
move (every point's float32 xyz and gray read once, S float32 renders
written once; `splat_work.splat_bytes`) at the HBM peak, over the device
time charged to `render_translation_grid` and its three `render.splat.*`
phases in the trace. Nothing where the cell holds no point cloud or the
trace does not hold one `render_translation_grid` range a sweep."""

from slambench import roofline, splat_work
from slambench.metrics import _common


def read(ctx):
    points = getattr(ctx.cell, "points", None)
    if points is None:
        return None
    n, _ = ctx.trace.range_host.get("render_translation_grid", (0, 0.0))
    sweeps = _common.traced_sweeps(ctx)
    if n == 0 or n != len(sweeps):
        return None
    total = 0
    for s in sweeps:
        S, _, h, w = _common.shape(ctx, s)
        total += splat_work.splat_bytes(len(points), S, h, w)
    return roofline.roofline_share(total, ctx.trace.device_s(splat_work.RANGES))
