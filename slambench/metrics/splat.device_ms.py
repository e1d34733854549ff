"""Device ms a sweep charged to the point splat: `render_translation_grid`
and its three phases (`render.splat.project`, `.scatter`, `.resolve`), by
innermost-range attribution, over the sweeps the window ran. Nothing where
the cell holds no point cloud or the trace none of these ranges."""

from slambench import splat_work
from slambench.metrics import _common


def read(ctx):
    if getattr(ctx.cell, "points", None) is None:
        return None
    if not any(n in ctx.trace.range_host for n in splat_work.RANGES):
        return None
    return _common.per_sweep_device_ms(ctx, splat_work.RANGES)
