"""Batched Sim(3) estimation and refinement between two keyframes (loop closing).

Port of `orbslam2_nmi_tpu/solvers/sim3.py`, the replacement for Sim3Solver
(reference: src/Sim3Solver.cc: Horn's closed-form quaternion method on
3-point samples inside a sequential RANSAC, :40 ctor / :143 iterate) and
Optimizer::OptimizeSim3 (src/Optimizer.cc:1063: g2o LM on one Sim3 vertex
with reprojection edges both ways, Huber sqrt(10), chi2-10 outlier removal,
then re-optimization). Every RANSAC hypothesis is Horn-solved in one batch;
inliers are counted by reprojecting each side's points into the OTHER camera
(the reference's CheckInliers); the refinement is a fixed-shape Gauss-Newton
on the 7-DoF tangent. Monocular, so the scale is free (bFixScale=false).

Where the port differs, or is likely to trip:

* The samples are an argument. The JAX package draws each hypothesis's three
  rows inside the solver with `jax.random.choice(..., replace=False,
  p=valid/sum)`, a stream the port cannot reproduce. `sim3_ransac` takes the
  [H, 3] row indices instead; the loop closer draws them on a CPU
  `torch.Generator` (`slam/loop_closing.py`), and the parity tests feed the
  JAX package's own draws.
* The vmap over hypotheses is a leading batch axis. `horn_sim3`'s 4x4
  `eigh` may order or sign the eigenvectors differently on the card; the
  quaternion's sign is free and the rotation it gives is not, so rotations
  are compared, never quaternions.
* `jax.jacfwd` becomes one forward-mode `torch.func.jvp` of the residuals
  over 7 copies of the perturbation, copy k carrying the k-th basis tangent
  (as in `solvers/pose_graph.py`, where `torch.func.jacfwd` misbehaved), and
  `jnp.linalg.solve` becomes `torch.linalg.solve_ex`, which does not wait on
  the device for an error check. Nothing here reads a value back.
* Precision: the JAX package computes `pts2_cam @ R.T` and the normal
  equations at `Precision.HIGHEST`; here every product is an elementwise
  float32 product and sum (`se3.mm`, `se3.mv`), which no TF32 flag reaches.
* The intrinsics are read on the host (numpy, or a CPU tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.utils.profiling import labelled

CHI2_INLIER = 9.21  # chi2(0.99, 2 dof), Sim3Solver::CheckInliers
CHI2_SIM3 = 10.0  # Optimizer.cc:1102 th2 (both edge directions)


class Sim3Result(NamedTuple):
    S12: torch.Tensor  # [4, 4] sim3 mapping frame-2 coords into frame-1
    scale: torch.Tensor
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _intrinsics(K):
    K = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, np.float32)
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity p1 ~ s R p2 + t (Horn 1987), weighted.

    p1, p2: [N, 3]; w: [..., N] 0/1 sample weights (a leading axis solves a
    batch of samples). Returns (R [..., 3, 3], t [..., 3], s [...]).
    """
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    c1 = (p1 * w[..., None]).sum(-2) / wsum[..., None]
    c2 = (p2 * w[..., None]).sum(-2) / wsum[..., None]
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    # cross-covariance M = sum_n w_n q2_n q1_n^T (maps 2 -> 1)
    M = ((q2 * w[..., None])[..., :, :, None] * q1[..., :, None, :]).sum(-3)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    _, vecs = torch.linalg.eigh(N)
    R = se3.quat_to_rot(vecs[..., :, -1])  # [w, x, y, z] of the largest eigenvalue
    # scale (Horn's asymmetric form): s = sum(q1 . R q2) / sum(|q2|^2)
    Rq2 = se3.mv(R[..., None, :, :], q2)
    s = torch.sum(torch.sum(q1 * Rq2, -1) * w, -1) / torch.clamp(
        torch.sum(torch.sum(q2 * q2, -1) * w, -1), min=1e-9)
    if fix_scale:
        s = torch.ones_like(s)
    t = c1 - s[..., None] * se3.mv(R, c2)
    return R, t, s


def _project(K, p: torch.Tensor):
    """(uv [..., 2], depth [...]) of camera-frame points; K as (fx, fy, cx, cy)."""
    fx, fy, cx, cy = K
    z = torch.where(torch.abs(p[..., 2]) > 1e-9, p[..., 2], 1e-9)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1), p[..., 2]


@labelled("sim3_ransac")
def sim3_ransac(
    samples: torch.Tensor,  # [H, 3] row indices of each hypothesis's sample
    K,
    pts1_cam: torch.Tensor,  # [N, 3] matched points in camera-1 frame
    pts2_cam: torch.Tensor,  # [N, 3] same points in camera-2 frame
    uv1: torch.Tensor,  # [N, 2] observed pixels in image 1
    uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """Every hypothesis Horn-solved at once, the one with the most inliers
    refined by one weighted Horn solve on its inliers (sim3.py:80-140 of the
    JAX package, with the samples given)."""
    Kf = _intrinsics(K)
    n = pts1_cam.shape[0]

    def count_inliers(R, t, s):
        # 2's points through S12 into image 1, and 1's through S21 into 2
        p2in1 = s[..., None, None] * se3.mv(R[..., None, :, :], pts2_cam) + t[..., None, :]
        uv1_hat, z1 = _project(Kf, p2in1)
        e1 = torch.sum((uv1_hat - uv1) ** 2, -1) * inv_sigma2_1
        Rt = R.transpose(-1, -2)
        p1in2 = (1.0 / torch.clamp(s, min=1e-9))[..., None, None] * se3.mv(
            Rt[..., None, :, :], pts1_cam - t[..., None, :])
        uv2_hat, z2 = _project(Kf, p1in2)
        e2 = torch.sum((uv2_hat - uv2) ** 2, -1) * inv_sigma2_2
        return (e1 < CHI2_INLIER) & (e2 < CHI2_INLIER) & (z1 > 0) & (z2 > 0) & valid

    H = samples.shape[0]
    w = torch.zeros((H, n), dtype=pts1_cam.dtype, device=pts1_cam.device)
    w.scatter_(1, samples.long(), 1.0)
    Rs, ts, ss = horn_sim3(pts1_cam, pts2_cam, w, fix_scale)
    counts = count_inliers(Rs, ts, ss).sum(-1)
    best = torch.argmax(counts)  # the first of equals, as jnp.argmax
    inl = count_inliers(Rs[best], ts[best], ss[best])
    R, t, s = horn_sim3(pts1_cam, pts2_cam, inl.to(pts1_cam.dtype), fix_scale)
    inl = count_inliers(R, t, s)
    n_inl = torch.sum(inl, dtype=torch.int32)
    return Sim3Result(S12=se3.make_sim3(R, t, s), scale=s, inliers=inl, n_inliers=n_inl,
                      ok=n_inl >= min_inliers)


# --------------------------------------------------------------- OptimizeSim3


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor  # [4, 4] refined sim3 (scale folded into the rotation block)
    scale: torch.Tensor
    inliers: torch.Tensor  # [N] bool: chi2 <= 10 in BOTH directions
    n_inliers: torch.Tensor


@labelled("optimize_sim3")
def optimize_sim3(
    K,
    S12_0: torch.Tensor,  # [4, 4] initial sim3 (e.g. the RANSAC's)
    pts1_cam: torch.Tensor,  # [N, 3] matched points in camera-1 frame
    pts2_cam: torch.Tensor,  # [N, 3] same points in camera-2 frame
    uv1: torch.Tensor,  # [N, 2] observed pixels in image 1
    uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    iters1: int = 5,
    iters2: int = 10,
    fix_scale: bool = False,
) -> Sim3OptResult:
    """Optimizer::OptimizeSim3 (Optimizer.cc:1063) as masked Gauss-Newton.

    Reprojection edges both ways per match (p2 through S12 into image 1, p1
    through S21 into image 2), Huber delta sqrt(10); after `iters1`
    iterations, edges with chi2 > 10 in either direction are dropped (the
    reference removes both directions of a bad pair) and `iters2` more
    iterations run on the survivors. Returns the refined S12 and the final
    inlier set.
    """
    Kf = _intrinsics(K)
    dev = pts1_cam.device
    s0 = torch.linalg.vector_norm(S12_0[:3, 0])
    R_init = S12_0[:3, :3] / s0
    t_init = S12_0[:3, 3]

    def _residuals(delta, R0, t0, ls0):
        """delta [B, 7] = [omega(3), dt(3), dls(1)], applied on the left /
        additively -> (r1, r2) [B, N, 2]."""
        R = se3.mm(se3.so3_exp(delta[:, :3]), R0)
        t = t0 + delta[:, 3:6]
        ls = ls0 + delta[:, 6] * (0.0 if fix_scale else 1.0)
        s = torch.exp(ls)[:, None, None]
        r1 = uv1 - _project(Kf, s * se3.mv(R[:, None], pts2_cam) + t[:, None])[0]
        r2 = uv2 - _project(Kf, (1.0 / s) * se3.mv(R.transpose(-1, -2)[:, None],
                                                   pts1_cam - t[:, None]))[0]
        return r1, r2

    zero = torch.zeros((1, 7), dtype=torch.float32, device=dev)
    basis = torch.eye(7, dtype=torch.float32, device=dev)

    def _chi2(R, t, ls):
        r1, r2 = _residuals(zero, R, t, ls)
        return (torch.sum(r1[0] * r1[0], -1) * inv_sigma2_1,
                torch.sum(r2[0] * r2[0], -1) * inv_sigma2_2)

    huber = float(np.sqrt(np.float32(CHI2_SIM3)))
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def _normal(J, w, r):
        Jw = J * w[:, None, None]
        return ((Jw[..., :, None] * J[..., None, :]).sum((0, 1)),
                (Jw * r[..., None]).sum((0, 1)))

    def _gn_step(state, mask):
        R, t, ls = state
        # forward-mode Jacobians: one jvp over 7 copies, copy k with tangent e_k
        (r1, r2), (t1, t2) = torch.func.jvp(lambda d: _residuals(d, R, t, ls),
                                            (torch.zeros_like(basis),), (basis,))
        r1, r2 = r1[0], r2[0]
        J1, J2 = t1.permute(1, 2, 0), t2.permute(1, 2, 0)  # [N, 2, 7]
        c1 = torch.sum(r1 * r1, -1) * inv_sigma2_1
        c2 = torch.sum(r2 * r2, -1) * inv_sigma2_2
        # IRLS Huber weights per edge direction
        w1 = torch.where(c1 > CHI2_SIM3, huber / torch.sqrt(torch.clamp(c1, min=1e-12)), 1.0)
        w2 = torch.where(c2 > CHI2_SIM3, huber / torch.sqrt(torch.clamp(c2, min=1e-12)), 1.0)
        H1, b1 = _normal(J1, w1 * inv_sigma2_1 * mask, r1)
        H2, b2 = _normal(J2, w2 * inv_sigma2_2 * mask, r2)
        # e(d) ~ e0 + J d  =>  normal equations H d = -J^T W e0
        d = -torch.linalg.solve_ex(H1 + H2 + 1e-6 * eye7, (b1 + b2)[:, None])[0][:, 0]
        R_new = se3.mm(se3.so3_exp(d[:3]), R)
        return R_new, t + d[3:6], (ls if fix_scale else ls + d[6])

    state = (R_init, t_init, torch.log(s0))
    mask = valid.to(torch.float32)
    for _ in range(iters1):
        state = _gn_step(state, mask)
    c1, c2 = _chi2(*state)
    mask = (valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)).to(torch.float32)
    for _ in range(iters2):
        state = _gn_step(state, mask)
    c1, c2 = _chi2(*state)
    inl = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    R, t, ls = state
    s = torch.exp(ls)
    return Sim3OptResult(S12=se3.make_sim3(R, t, s), scale=s, inliers=inl,
                         n_inliers=torch.sum(inl, dtype=torch.int32))
