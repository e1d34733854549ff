"""Pose-only optimization: motion-only bundle adjustment for one frame.

Port of `orbslam2_nmi_tpu/solvers/pose_gn.py`, the replacement for
Optimizer::PoseOptimization (reference: src/Optimizer.cc:251): g2o Levenberg
with one SE3 vertex, monocular reprojection edges, a Huber kernel of delta
sqrt(5.991), 4 rounds x 10 iterations with chi2-5.991 outlier gating between
rounds (Optimizer.cc:380-460). Here it is a fixed-shape IRLS
Levenberg-Marquardt on the 6-DoF tangent, everything masked, no dynamic
shapes.

Where the port differs, or is likely to trip:

* `lax.scan` becomes a Python loop of a fixed length. Every accept and
  reject stays a `torch.where` on the device, so the loop never reads a value
  back and the whole solve can be captured in a CUDA graph.
* The JAX package pins `Precision.HIGHEST` for the Jacobian and the normal
  equations. Here every product is an elementwise product and sum in float32
  (`se3.mm`, `se3.mv`), which no TF32 flag reaches; a caller who turned TF32
  on gets the same pose.
* `cho_factor`/`cho_solve` become `torch.linalg.cholesky_ex` and two
  `torch.linalg.solve_triangular`: `cholesky_ex` does not wait on the device
  to check for errors, as `torch.linalg.cholesky` would, and the triangular
  solves check none. JAX factors the upper triangle and torch the lower
  one, so the steps agree to float32 rounding.
* The intrinsics are read on the host (numpy, or a CPU tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3

CHI2_MONO = 5.991
# sqrt in float32, as the reference takes it (jnp.sqrt of a float32 constant)
HUBER_DELTA = float(np.sqrt(np.float32(CHI2_MONO)))


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [4, 4] optimized pose
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int32
    chi2: torch.Tensor  # [N] float32 final per-edge chi2


def _project(Tcw, pts_w, fx, fy, cx, cy):
    """(uv [N, 2], camera-frame points [N, 3], safe 1/z [N]) of world points."""
    pc = se3.mv(Tcw[:3, :3], pts_w) + Tcw[:3, 3]
    z = pc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    e = torch.stack([fx * pc[..., 0] * iz + cx, fy * pc[..., 1] * iz + cy], dim=-1)
    return e, pc, iz


def _reproj_residuals_jac(Tcw, pts_w, uv, fx, fy, cx, cy):
    """Projections e = proj(T p) and the Jacobian d(proj)/dxi, xi = [rho, phi].

    The analytic monocular Jacobian (the math of g2o types_six_dof_expmap.cpp
    EdgeSE3ProjectXYZOnlyPose::linearizeOplus, with the sign convention
    e = obs - proj and the perturbation T <- exp(xi) * T). Returns (e, J, z).
    """
    e, pc, iz = _project(Tcw, pts_w, fx, fy, cx, cy)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dproj = torch.stack([du, dv], dim=-2)  # [N, 2, 3]
    # d(pc)/dxi with pc = exp(xi) * (R p + t): [I, -hat(pc)]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)  # [N, 3, 6]
    return e, se3.mm(dproj, dpc), z


def pose_optimization_k(
    K,
    Tcw0: torch.Tensor,
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """PoseOptimization with explicit intrinsics (see the module docstring).

    Between rounds, edges with chi2 > 5.991 are marked outliers and excluded;
    previously excluded edges are re-tested and can return
    (Optimizer.cc:418-438). The Huber kernel is active in rounds 0 and 1 and
    off for the inlier-only refinement afterwards.
    """
    K = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, np.float32)
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    dev = pts_w.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def chi2_of(Tcw):
        e, pc, _ = _project(Tcw, pts_w, fx, fy, cx, cy)
        r = uv - e
        return torch.sum(r * r, dim=-1) * inv_sigma2, pc[..., 2]

    def lm_round(Tcw, use_mask, use_huber):
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        for _ in range(iters):
            e_proj, J, z = _reproj_residuals_jac(Tcw, pts_w, uv, fx, fy, cx, cy)
            r = uv - e_proj  # residual [N, 2]
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = inv_sigma2
            if use_huber:  # Huber IRLS weight on top of the information weight
                w = w * torch.where(chi2 > CHI2_MONO, HUBER_DELTA / torch.sqrt(chi2 + 1e-12), 1.0)
            w = w * use_mask * (z > 0)
            # normal equations H = J^T W J, g = J^T W r (r = obs - proj, dr/dxi = -J)
            Jw = J * w[:, None, None]
            H = (Jw[..., :, None] * J[..., None, :]).sum(dim=(0, 1))
            g = (Jw * r[..., None]).sum(dim=(0, 1))
            H_lm = H + lam * torch.diag_embed(torch.diagonal(H)) + 1e-8 * eye6
            L = torch.linalg.cholesky_ex(H_lm)[0]
            y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
            dxi = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
            T_new = se3.mm(se3.se3_exp(dxi), Tcw)
            # accept if the total chi2 decreased (cheap LM accept/reject)
            chi2_new, z2 = chi2_of(T_new)
            chi2_new = torch.sum(chi2_new * use_mask * (z2 > 0))
            improved = chi2_new < torch.sum(chi2 * use_mask)
            Tcw = torch.where(improved, T_new, Tcw)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
        return Tcw

    Tcw = Tcw0
    inlier = valid
    for rnd in range(rounds):
        Tcw = lm_round(Tcw, inlier.to(torch.float32), rnd < 2)
        chi2, z = chi2_of(Tcw)
        # re-gate ALL originally valid edges (outliers may be rescued)
        inlier = valid & (chi2 <= CHI2_MONO) & (z > 0)

    chi2, _ = chi2_of(Tcw)
    return PoseOptResult(Tcw=Tcw, inliers=inlier,
                         n_inliers=torch.sum(inlier, dtype=torch.int32), chi2=chi2)
