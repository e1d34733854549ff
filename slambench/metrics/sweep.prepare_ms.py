"""Host ms a sweep in `NMILocalizer.prepare_sweep` (frame pooling, the
mesh's binning, the uploads), from its `render.prepare_sweep` ranges."""

from slambench.metrics import _common


def read(ctx):
    n, s = ctx.trace.range_host.get(_common.PREPARE, (0, 0.0))
    return 1e3 * s / n if n else None
