"""Device ms a sweep charged to the score's ranges (`entropy.nmi_scores`
and the entropy kernels' wrappers)."""

from slambench.metrics import _common


def read(ctx):
    return _common.per_sweep_device_ms(ctx, _common.SCORE)
