"""The mesh render kernel's share of its roofline, in %: the bytes each
sweep must move (the mesh's vertices, UVs and faces and the texture read
once, S gray images written; `roofline.render_gray_bytes`) at the HBM
peak, over `render_gray_kernel`'s device time in the trace."""

from slambench import roofline
from slambench.metrics import _common


def read(ctx):
    n, t = ctx.trace.kernel("render_gray_kernel")
    sweeps = _common.traced_sweeps(ctx)
    mesh = ctx.cell.mesh
    if n == 0 or n != len(sweeps) or ctx.cell.points is not None:
        return None
    th, tw = mesh.texture_gray.shape
    total = 0
    for s in sweeps:
        S, _, h, w = _common.shape(ctx, s)
        total += roofline.render_gray_bytes(len(mesh.vertices), len(mesh.faces), th, tw, S, h, w)
    return roofline.roofline_share(total, t)
