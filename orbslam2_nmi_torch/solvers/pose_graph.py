"""Essential-graph Sim(3) pose-graph optimization.

Port of `orbslam2_nmi_tpu/solvers/pose_graph.py`, the replacement for
Optimizer::OptimizeEssentialGraph (reference: src/Optimizer.cc:798, g2o
BlockSolver_7_3 Levenberg with lambda=1e-16 :811, 20 iterations): after a
loop closure, keyframe Sim3 poses are relaxed over the essential graph
(spanning tree + loop edges + strong-covisibility edges >= 100) with the loop
keyframe fixed. Per-edge residuals e = log(S_meas_ji . S_i . S_j^{-1}) with
Jacobians by forward-mode autodiff of the left perturbation, batched over all
edges; the dense [7V, 7V] normal matrix is assembled from the edge blocks and
Cholesky-solved on the device. V is a few hundred keyframes, so dense is
simpler and fast enough.

Where the port differs, or is likely to trip:

* `jax.jacfwd` over a vmap of the edges becomes one forward-mode
  `torch.func.jvp` of the batched residual over 14 copies of the edges, one
  per basis tangent (`_edge_jacobians`). Forward mode, as in the JAX
  package: in reverse mode the untaken branch of a `torch.where` (the
  small-angle limits, 0/0 at a zero perturbation) turns the gradient into
  NaN. Not `torch.func.jacfwd` under `torch.func.vmap`: with torch 2.13 that
  gave NaN Jacobians for every edge but the first of a batch (each edge
  alone was finite), and it computes the tangent of a 0-dim float32 tensor
  times a Python float in float64.
* The scatter of the edge blocks is a sum in a fixed order: every block
  contribution (HII, HJJ, HIJ, HIJ^T, in the JAX package's order of scatters,
  each in edge order) is keyed by its (row, column) block, stably sorted on
  the host, and summed by `torch.segment_reduce` (`_BlockLayout`). With
  `index_add_` the atomics add in no fixed order on the card, and a solve
  would differ from itself from run to run.
* `cho_factor` on an indefinite matrix gives NaN; `torch.linalg.cholesky_ex`
  and `cholesky_solve` give finite garbage. The step is made NaN by
  `torch.where` on `cholesky_ex`'s `info`, as the JAX package's would be (the
  float32 system at lambda 1e-16 can be indefinite).
* Precision: the JAX package's products run at `Precision.HIGHEST`; here the
  4x4 and 7x7 products are elementwise float32 (`se3.mm`), which no TF32 flag
  reaches. Nothing in the loop reads a value back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.utils.readback import to_host
from orbslam2_nmi_torch.utils.profiling import labelled


class PoseGraphProblem(NamedTuple):
    Scw: torch.Tensor  # [V, 4, 4] sim3 world->camera per keyframe
    fixed: torch.Tensor  # [V] bool
    valid: torch.Tensor  # [V] bool
    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_Sji: torch.Tensor  # [E, 4, 4] measured S_j * S_i^{-1}
    edge_valid: torch.Tensor  # [E] bool


def edge_residual(Si: torch.Tensor, Sj: torch.Tensor, Sji: torch.Tensor) -> torch.Tensor:
    """e = log(Sji . Si . Sj^{-1}) in R^7 (g2o EdgeSim3 error)."""
    return se3.sim3_log(se3.mm(se3.mm(Sji, Si), se3.sim3_inverse(Sj)))


def _residual_with_delta(di, dj, Si, Sj, Sji):
    """Edge residuals at left perturbations di, dj [..., 7] of Si and Sj."""
    return edge_residual(se3.mm(se3.sim3_exp(di), Si), se3.mm(se3.sim3_exp(dj), Sj), Sji)


def _edge_jacobians(Si, Sj, Sji):
    """(e [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]): the residuals and their forward-
    mode Jacobians at zero perturbation. One `torch.func.jvp` over 14 copies
    of the edges, copy k carrying the k-th basis tangent of (di, dj), takes
    the place of jacfwd's vmap over the basis (see the module docstring)."""
    E = Si.shape[0]
    rep = lambda x: x.repeat(14, *([1] * (x.dim() - 1)))  # noqa: E731
    Si_r, Sj_r, Sji_r = rep(Si), rep(Sj), rep(Sji)
    basis = torch.eye(14, dtype=Si.dtype, device=Si.device).repeat_interleave(E, 0)
    e, t = torch.func.jvp(lambda d: _residual_with_delta(d[:, :7], d[:, 7:], Si_r, Sj_r, Sji_r),
                          (torch.zeros_like(basis),), (basis,))
    J = t.reshape(14, E, 7).permute(1, 2, 0)  # [E, 7 residuals, 14 perturbations]
    return e[:E], J[..., :7], J[..., 7:]


def _tmm_w(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[e, k, i] w[e] b[e, k, j] -> [E, i, j], in float32."""
    return se3.mm((a * w[:, None, None]).transpose(-1, -2), b)


def edge_blocks(Scw, edge_i, edge_j, edge_Sji, edge_valid):
    """Per-edge GN contributions: HII/HJJ/HIJ [E, 7, 7], bI/bJ [E, 7]."""
    Si = Scw[edge_i.long()]
    Sj = Scw[edge_j.long()]
    e, Ji, Jj = _edge_jacobians(Si, Sj, edge_Sji)
    w = edge_valid.to(Scw.dtype)
    HII = _tmm_w(Ji, w, Ji)
    HJJ = _tmm_w(Jj, w, Jj)
    HIJ = _tmm_w(Ji, w, Jj)
    bI = se3.mv((Ji * w[:, None, None]).transpose(-1, -2), e)
    bJ = se3.mv((Jj * w[:, None, None]).transpose(-1, -2), e)
    return HII, HJJ, HIJ, bI, bJ


class _BlockLayout(NamedTuple):
    """The fixed summation order of `scatter_blocks`: contributions sorted
    stably by target block, and the segment offsets."""

    h_order: torch.Tensor  # [4E] into cat([HII, HJJ, HIJ, HIJ^T])
    h_offsets: torch.Tensor  # [V * V + 1]
    b_order: torch.Tensor  # [2E] into cat([bI, bJ])
    b_offsets: torch.Tensor  # [V + 1]


def block_layout(V: int, edge_i, edge_j, device) -> _BlockLayout:
    """The layout of `scatter_blocks` from host edge lists (numpy, or CPU
    tensors): built once a problem, on the host."""
    ei = np.asarray(edge_i, np.int64)
    ej = np.asarray(edge_j, np.int64)
    hkey = np.concatenate([ei * V + ei, ej * V + ej, ei * V + ej, ej * V + ei])
    bkey = np.concatenate([ei, ej])
    out = []
    for key, n in ((hkey, V * V), (bkey, V)):
        order = np.argsort(key, kind="stable")
        offsets = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=n))])
        out += [torch.from_numpy(order).to(device), torch.from_numpy(offsets).to(device)]
    return _BlockLayout(*out)


def _segment_sum(values, order, offsets):
    return torch.segment_reduce(values[order], "sum", offsets=offsets, axis=0, unsafe=True)


def scatter_blocks(V, edge_i, edge_j, HII, HJJ, HIJ, bI, bJ, layout: _BlockLayout | None = None):
    """Sum the per-edge blocks into dense H [V, V, 7, 7] and b [V, 7], each
    block's contributions in the JAX package's scatter order."""
    if layout is None:
        layout = block_layout(V, to_host(edge_i), to_host(edge_j), HII.device)
    hv = torch.cat([HII, HJJ, HIJ, HIJ.transpose(-1, -2)])
    H = _segment_sum(hv, layout.h_order, layout.h_offsets).reshape(V, V, 7, 7)
    b = _segment_sum(torch.cat([bI, bJ]), layout.b_order, layout.b_offsets)
    return H, b


def assemble_normal_equations(Scw, edge_i, edge_j, edge_Sji, edge_valid, V,
                              layout: _BlockLayout | None = None):
    """Per-edge GN blocks summed into dense H [V, V, 7, 7], b [V, 7]."""
    return scatter_blocks(V, edge_i, edge_j,
                          *edge_blocks(Scw, edge_i, edge_j, edge_Sji, edge_valid), layout=layout)


def solve_and_update(Scw, H, b, free, lam):
    """Solve the gated dense system and apply the sim3 update to free vertices.
    An indefinite system gives a NaN step (see the module docstring)."""
    V = Scw.shape[0]
    Hd = H.permute(0, 2, 1, 3).reshape(V * 7, V * 7)
    free7 = torch.repeat_interleave(free, 7)
    Hd = torch.where(free7[:, None] & free7[None, :], Hd, 0.0)
    eye = torch.eye(V * 7, dtype=Hd.dtype, device=Hd.device)
    Hd = Hd + torch.diag(torch.where(free7, lam, 1.0)) + 1e-6 * eye
    bd = torch.where(free7, -b.reshape(-1), 0.0)
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(bd[:, None], L)[:, 0]
    delta = torch.where(info == 0, delta, float("nan")).reshape(V, 7)
    Scw_new = se3.mm(se3.sim3_exp(delta), Scw)
    return torch.where(free[:, None, None], Scw_new, Scw)


@labelled("pose_graph")
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        lam: float = 1e-16) -> torch.Tensor:
    """Gauss-Newton over all sim3 vertices. Returns optimized Scw [V, 4, 4]."""
    V = prob.Scw.shape[0]
    free = prob.valid & (~prob.fixed)
    layout = block_layout(V, to_host(prob.edge_i), to_host(prob.edge_j), prob.Scw.device)
    Scw = prob.Scw
    for _ in range(iters):
        H, b = assemble_normal_equations(Scw, prob.edge_i, prob.edge_j, prob.edge_Sji,
                                         prob.edge_valid, V, layout)
        Scw = solve_and_update(Scw, H, b, free, lam)
    return Scw
