"""Kernel B1's share of its roofline, in %: the bytes its sweeps must move
(S + R one-byte images read, S x R scores written; `roofline.
joint_entropy_bytes`) at the HBM peak, over `joint_entropy_kernel`'s device
time in the trace."""

from slambench import roofline
from slambench.metrics import _common


def read(ctx):
    n, t = ctx.trace.kernel("joint_entropy_kernel")
    sweeps = _common.traced_sweeps(ctx)
    if n == 0 or n != len(sweeps):
        return None
    total = 0
    for s in sweeps:
        S, R, h, w = _common.shape(ctx, s)
        total += roofline.joint_entropy_bytes(S, R, h * w)
    return roofline.roofline_share(total, t)
