"""Device ms a sweep charged to the render's ranges (`render_mesh_grid`,
`render_gray`, `render_translation_grid`), by innermost-range attribution."""

from slambench.metrics import _common


def read(ctx):
    return _common.per_sweep_device_ms(ctx, _common.RENDER)
