"""Bundle adjustment with Schur-complement landmark marginalization.

Port of `orbslam2_nmi_tpu/solvers/local_ba.py`, the replacement for g2o's
BlockSolver_6_3 + Levenberg pipeline as used by
Optimizer::LocalBundleAdjustment (reference: src/Optimizer.cc:472) and
Optimizer::BundleAdjustment (:52). The camera-point coupling B is densified
([6C, 3P]), so the reduced camera system

    S = Hcc - B Hpp^{-1} B^T,   g_s = g_c - B Hpp^{-1} g_p

is two large products, and the landmark marginalization Hpp^{-1} a batched
3x3 adjugate inverse. Fixed cameras (the first keyframe, NMI-relocalized
keyframes, observer-only keyframes: Optimizer.cc:82, :548, :561) are pinned
through `cam_fixed`; Huber delta sqrt(5.991), per-octave weights, and the
5 + 10 iteration schedule with chi2 gating between phases (Optimizer.cc:
679-725) are the JAX package's.

Where the port differs, or is likely to trip:

* Cholesky of an indefinite Schur matrix. `jax.scipy.linalg.cho_factor`
  returns NaN there, `_robust_total` charges the NaN step
  `_DEGENERATE_COST` per observation and the LM loop rejects it: that is
  how the reference's loop heals. `torch.linalg.cholesky_ex` and
  `torch.cholesky_solve` return finite garbage instead, so the step is
  turned into NaN wherever `info != 0`, by `torch.where` on the device.
* Precision. The JAX package pins `Precision.HIGHEST` on every product. The
  Schur product B (Hpp^-1 B^T) ([6C, 3P] x [3P, 6C]) and B (Hpp^-1 g_p) are
  too large for the elementwise products and would follow the process's
  TF32 flags on CUDA as float32 matmuls, so they run in float64 and are
  cast back. The small batched products are elementwise float32 products
  (`se3.mm`, `se3.mv`) or elementwise sums. No flag is set.
* `jax.ops.segment_sum` becomes `torch.segment_reduce` over the valid
  observations sorted (stably) by segment, a layout built on the host once a
  solve (`_segments`). `index_add_` would add with atomics in no fixed order
  on CUDA, and a BA would then differ from itself from run to run; here each
  segment adds in observation order in float32, as the reference's scatter
  does on the CPU, so a solve repeats bit for bit on its device (and TF32 on
  gives the same result). A running sum or a sum over a padded axis is
  deterministic too, but on the CPU accumulates in float64 or pairwise, and
  the BA's poorly conditioned depths then drift 10x further from the
  reference. The card is held against the CPU within stated bars: their
  reductions and factorizations round differently.
* Nothing in the LM loop waits on the device (no `.item()`, no error-checking
  factorization, no data-dependent shape): a wait there would also wait for
  whatever else the card is running, such as the tracking step's graph.
* `lax.scan` becomes a Python loop of a fixed length whose accept and reject
  are `torch.where`: the loop never reads a value back.
* The dense coupling `Hcp_blocks` is [C, P, 6, 3] float32 and B's float64
  copy twice its size (`coupling_bytes`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.utils.readback import to_host
from orbslam2_nmi_torch.utils.profiling import labelled

CHI2_MONO = 5.991
# sqrt in float32, as the reference takes it (jnp.sqrt of a float32 constant)
HUBER_DELTA = float(np.sqrt(np.float32(CHI2_MONO)))


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. O = observation capacity (padded)."""

    K: torch.Tensor  # [3, 3] intrinsics
    cam_Tcw: torch.Tensor  # [C, 4, 4]
    cam_fixed: torch.Tensor  # [C] bool: poses held constant (id0 / NMI-anchored)
    cam_valid: torch.Tensor  # [C] bool
    pts_w: torch.Tensor  # [P, 3]
    pts_valid: torch.Tensor  # [P] bool
    obs_cam: torch.Tensor  # [O] int32 camera index
    obs_pt: torch.Tensor  # [O] int32 point index
    obs_uv: torch.Tensor  # [O, 2] float32
    obs_inv_sigma2: torch.Tensor  # [O] float32
    obs_valid: torch.Tensor  # [O] bool


class BAResult(NamedTuple):
    cam_Tcw: torch.Tensor
    pts_w: torch.Tensor
    obs_inlier: torch.Tensor  # [O] bool: chi2-gated
    chi2: torch.Tensor  # [O] float32


def coupling_bytes(prob: BAProblem) -> int:
    """Bytes of the dense coupling Hcp_blocks [C, P, 6, 3] float32 (B's
    float64 copy in the Schur product is twice that)."""
    return prob.cam_Tcw.shape[0] * prob.pts_w.shape[0] * 18 * 4


def _residuals(K, cam_Tcw, pts_w, obs_cam, obs_pt, obs_uv):
    """Per-observation residual r = uv - proj, Jacobians Jc [O, 2, 6],
    Jp [O, 2, 3], depth z."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T = cam_Tcw[obs_cam.long()]  # [O, 4, 4]
    p = pts_w[obs_pt.long()]  # [O, 3]
    pc = se3.se3_apply(T, p)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = obs_uv - torch.stack([u, v], dim=-1)

    zero = torch.zeros_like(iz)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dproj = torch.stack([du, dv], dim=-2)  # [O, 2, 3]
    # pose perturbation T <- exp(xi) T : d(pc)/dxi = [I | -hat(pc)]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)  # [O, 3, 6]
    Jc = se3.mm(dproj, dpc_dxi)
    # point perturbation: d(pc)/dp = R
    Jp = se3.mm(dproj, T[:, :3, :3])
    return r, Jc, Jp, z


def _spd_inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 SPD inverse via adjugate (fast, no pivoting needed)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    inv = torch.stack(
        [
            torch.stack([A, B, C], dim=-1),
            torch.stack([B, a * f - c * c, c * b - a * e], dim=-1),
            torch.stack([C, c * b - a * e, a * d - b * b], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


class _Segments(NamedTuple):
    """Valid observations grouped by segment: their indices in segment order
    (stable, so each segment keeps observation order) and the offsets."""

    order: torch.Tensor  # [V] observation indices
    offsets: torch.Tensor  # [n + 1]


def _segments(ids_h: np.ndarray, valid_h: np.ndarray, n: int, device) -> _Segments:
    """The segment layout of host ids [O] over n segments, built on the host.
    An invalid (padding) observation adds zero, so it is left out."""
    ids_h = ids_h.astype(np.int64)
    order = np.nonzero(valid_h)[0]
    order = order[np.argsort(ids_h[order], kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(ids_h[order], minlength=n))])
    return _Segments(torch.from_numpy(order).to(device), torch.from_numpy(offsets).to(device))


def _segment_sum(values: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """jax.ops.segment_sum: each segment added in observation order, in
    float32 (the reference's scatter-add order on the CPU), by
    `torch.segment_reduce`: no atomics, and with the layout given (`unsafe`)
    no check that waits on the device."""
    return torch.segment_reduce(values[seg.order], "sum", offsets=seg.offsets, axis=0,
                                unsafe=True)


def problem_segments(prob: BAProblem):
    """The segment layouts of a problem's valid observations by camera, by
    point and by (camera, point), built on the host (one wait)."""
    C, P = prob.cam_Tcw.shape[0], prob.pts_w.shape[0]
    oc, op, ov = to_host(torch.stack([prob.obs_cam, prob.obs_pt,
                                      prob.obs_valid.to(torch.int32)])).astype(np.int64)
    ov = ov.astype(bool)
    dev = prob.cam_Tcw.device
    return (_segments(oc, ov, C, dev), _segments(op, ov, P, dev),
            _segments(oc * P + op, ov, C * P, dev))


def _wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the Schur complement's two large products ([6C, 3P] x
    [3P, 6C] and x [3P]): in float64, cast back, so never TF32."""
    return (a.double() @ b.double()).float()


def _tmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over the last two axes: [O, i, k] x [O, i, l] -> [O, k, l]."""
    return se3.mm(a.transpose(-1, -2), b)


def _ba_iteration(K, cam_Tcw, pts_w, prob: BAProblem, segs, active, lam, use_huber: bool):
    """One damped-GN step. `segs` groups the observations by camera, point
    and (camera, point). Returns (new_cams, new_pts, chi2_total_old)."""
    C = cam_Tcw.shape[0]
    P = pts_w.shape[0]
    r, Jc, Jp, z = _residuals(K, cam_Tcw, pts_w, prob.obs_cam, prob.obs_pt, prob.obs_uv)
    w_info = prob.obs_inv_sigma2
    chi2 = torch.sum(r * r, dim=-1) * w_info
    rho_w = torch.where(use_huber & (chi2 > CHI2_MONO),
                        HUBER_DELTA / torch.sqrt(chi2 + 1e-12), 1.0)
    w = w_info * rho_w * active * (z > 0)

    # zero Jacobians of fixed cameras so their updates vanish
    cam_free = (~prob.cam_fixed) & prob.cam_valid
    Jc = Jc * cam_free[prob.obs_cam.long()].to(Jc.dtype)[:, None, None]

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    # Hcc diagonal blocks [C, 6, 6], gradient [C, 6]; Hpp [P, 3, 3], gp [P, 3]
    by_cam, by_pt, by_pair = segs
    Hcc = _segment_sum(_tmm(wJc, Jc), by_cam)
    gc = _segment_sum(se3.mv(wJc.transpose(-1, -2), r), by_cam)
    Hpp = _segment_sum(_tmm(wJp, Jp), by_pt)
    gp = _segment_sum(se3.mv(wJp.transpose(-1, -2), r), by_pt)
    # camera-point coupling, densified: [C, P, 6, 3] over the combined id
    Hcp_blocks = _segment_sum(_tmm(wJc, Jp), by_pair).reshape(C, P, 6, 3)

    # LM damping
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    Hcc = Hcc + lam * eye6 + 1e-8 * eye6
    Hpp = Hpp + lam * eye3 + 1e-8 * eye3
    Hpp_inv = _spd_inv3(Hpp) * prob.pts_valid[:, None, None]

    # Schur: S = Hcc_full - B Hpp^-1 B^T with B = [6C, 3P]; the two large
    # products in float64, cast back (never TF32)
    B = Hcp_blocks.permute(0, 2, 1, 3).reshape(C * 6, P * 3).double()
    HppinvBT = se3.mm(Hcp_blocks, Hpp_inv.transpose(-1, -2))  # [C, P, 6, 3]
    HppinvBT_m = HppinvBT.permute(1, 3, 0, 2).reshape(P * 3, C * 6)
    S = -_wide(B, HppinvBT_m)
    # + Hcc on the diagonal blocks: [c, i, d, j] += (c == d) Hcc[c, i, j]
    eyeC = torch.eye(C, dtype=S.dtype, device=S.device)
    S = (S.reshape(C, 6, C, 6) + eyeC[:, None, :, None] * Hcc[:, :, None, :]).reshape(C * 6,
                                                                                      C * 6)
    gp_tilde = se3.mv(Hpp_inv, gp)  # Hpp^-1 gp
    g_s = gc.reshape(-1) - _wide(B, gp_tilde.reshape(-1))

    # fixed/invalid cameras: identity rows to pin dx = 0
    free6 = torch.repeat_interleave(cam_free, 6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0))
    g_s = torch.where(free6, g_s, 0.0)

    eye = torch.eye(C * 6, dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S + 1e-8 * eye)
    dxc = torch.cholesky_solve(g_s[:, None], L)[:, 0]
    # an indefinite S: NaN, as cho_factor gives, so the step is rejected
    dxc = torch.where(info == 0, dxc, float("nan")).reshape(C, 6)
    # back-substitute points: dp = Hpp^-1 (gp - B^T dxc)
    Bt_dxc = torch.sum(Hcp_blocks * dxc[:, None, :, None], dim=(0, 2))
    dp = se3.mv(Hpp_inv, gp - Bt_dxc)
    dp = dp * prob.pts_valid[:, None]

    new_cams = torch.where(cam_free[:, None, None],
                           se3.se3_compose(se3.se3_exp(dxc), cam_Tcw), cam_Tcw)
    new_pts = pts_w + dp
    chi2_total = torch.sum(chi2 * active * (z > 0))
    return new_cams, new_pts, chi2_total


def _chi2_of(K, cam_Tcw, pts_w, prob):
    r, _, _, z = _residuals(K, cam_Tcw, pts_w, prob.obs_cam, prob.obs_pt, prob.obs_uv)
    return torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2, z


# robust cost charged per active observation that a candidate state made
# degenerate (behind the camera or non-finite) — far above any healthy rho
_DEGENERATE_COST = 1e4


def _robust_total(chi2, active, z):
    """Huber-robustified chi2 total (g2o robust_kernel_impl.cpp): rho(x) = x
    for x <= delta^2, else 2*delta*sqrt(x) - delta^2. LM accept decisions
    use this, not the raw total. Degenerate observations (z <= 0 or a
    non-finite chi2, e.g. the NaN state of an indefinite Schur matrix) are
    charged `_DEGENERATE_COST` each, so such steps are rejected and the LM
    loop heals by raising the damping (the JAX package's notes,
    local_ba.py:213-232)."""
    d2 = CHI2_MONO
    ok = active & (z > 0) & torch.isfinite(chi2)
    rho = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=0.0)) - d2)
    total = torch.sum(torch.where(ok, rho, 0.0))
    n_degen = torch.sum(active & ~ok)
    return total + n_degen.to(torch.float32) * _DEGENERATE_COST


@labelled("bundle_adjust")
def bundle_adjust(prob: BAProblem, iters1: int = 5, iters2: int = 10) -> BAResult:
    """Two-phase BA mirroring Optimizer::LocalBundleAdjustment: `iters1`
    robust iterations, chi2 gating of outlier observations, then `iters2`
    iterations on inliers with the Huber kernel still active."""
    K = prob.K
    obs_cam, obs_pt = prob.obs_cam.long(), prob.obs_pt.long()
    active0 = prob.obs_valid & prob.pts_valid[obs_pt] & prob.cam_valid[obs_cam]
    segs = problem_segments(prob)  # one wait, before the loop

    def phase(cam, pts, active, n_iters):
        chi2_0, z0 = _chi2_of(K, cam, pts, prob)
        best = _robust_total(chi2_0, active, z0)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=cam.device)
        for _ in range(n_iters):
            new_cam, new_pts, _ = _ba_iteration(K, cam, pts, prob, segs,
                                                active.to(torch.float32), lam, True)
            chi2_new, z = _chi2_of(K, new_cam, new_pts, prob)
            total_new = _robust_total(chi2_new, active, z)
            improved = total_new < best
            cam = torch.where(improved, new_cam, cam)
            pts = torch.where(improved, new_pts, pts)
            lam = torch.where(improved, lam * 0.5, lam * 5.0)
            best = torch.minimum(best, total_new)
        return cam, pts

    cam, pts = phase(prob.cam_Tcw, prob.pts_w, active0, iters1)
    chi2, z = _chi2_of(K, cam, pts, prob)
    active1 = active0 & (chi2 <= CHI2_MONO) & (z > 0)
    cam, pts = phase(cam, pts, active1, iters2)
    chi2, z = _chi2_of(K, cam, pts, prob)
    inlier = active0 & (chi2 <= CHI2_MONO) & (z > 0)
    return BAResult(cam_Tcw=cam, pts_w=pts, obs_inlier=inlier, chi2=chi2)
