"""Device ms a sweep charged to the warp's ranges (`warp_rotation_grid`,
`warp_homographies`)."""

from slambench.metrics import _common


def read(ctx):
    return _common.per_sweep_device_ms(ctx, _common.WARP)
