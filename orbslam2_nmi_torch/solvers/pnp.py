"""Batched RANSAC PnP for BoW relocalization.

Port of `orbslam2_nmi_tpu/solvers/pnp.py`, the replacement for PnPsolver
(reference: src/PnPsolver.cc: EPnP control points + Gauss-Newton inside a
sequential RANSAC, :167 iterate / :479 compute_pose). All RANSAC hypotheses
are solved in one batch, inliers counted in one [H, N] masked reduction, and
the winner polished with the pose-only LM (`solvers/pose_gn.py`), as the
reference refines with g2o afterwards (Tracking.cc:1669-1720).

Two minimal solvers, batched over a leading axis of sample weights:
  * `epnp_pose`, the reference's algorithm (PnPsolver.cc:479): 4 control
    points (centroid + PCA axes), barycentric coordinates, the 12x12
    eigendecomposition of M^T M, beta cases N = 1/2/3 from the L beta = rho
    distance system (:700-840), 5 Gauss-Newton steps on the betas (:842),
    Procrustes recovery of [R|t]. Minimal sample: 4 points (:128).
  * `_dlt_pose`, a 6-point weighted DLT.

Where the port differs, or is likely to trip:

* The samples are an argument (`samples` [H, sample_size] row indices), as in
  `solvers/sim3.py`: the JAX package draws them with `jax.random.choice`
  inside the solver; the caller draws them on a CPU `torch.Generator`, and
  the parity tests feed the JAX package's draws.
* `eigh`, `svd`, `lstsq` and `solve` are torch's, batched. Eigen- and
  singular vectors may differ in sign (and, at repeated values, in basis)
  between devices; every use here is invariant to the sign (the EPnP betas
  are solved for the vectors given, R = U D V^T takes both factors' signs).
  `lstsq` solves by QR (`gels`) on both devices (the only method CUDA
  offers), exact for the full-rank 6x3 and 6x5 systems: the CPU's default
  (`gelsy`) rounds by the memory alignment of its inputs, so a solve
  differed from itself from run to run. A rank-deficient sample gives a garbage hypothesis,
  which loses the vote.
* A hypothesis that samples a point far enough to overflow the float32
  moments (a map point its BA left unconstrained) returns a NaN pose and so
  counts no inlier, as in the JAX package, whose linear algebra propagates
  the NaN. A point that is not finite makes every hypothesis NaN, sampled or
  not: the JAX package's weighted sums multiply it by a zero weight (inf * 0
  is NaN), so its RANSAC finds no pose. Torch's batched solvers raise on
  such input (CUDA's `eigh` stopped a relocalization on the card, ROADMAP
  C5), so the hypothesis is solved with the point at the origin and its
  pose set to NaN. A hypothesis whose 12x12 normal matrix overflows float32
  (a near-singular control frame) is likewise solved on a fixed matrix and
  returned as NaN, where the reference's eigen-solve gives NaN and CUDA's
  raised (ROADMAP C9); an eigen-solve that fails to converge on a finite
  batch is run again in float64.
* Precision: the 12x12 normal matrix M^T M is summed over the points in
  float64 and rounded (a float32 matmul would follow the TF32 flags); the
  small products are elementwise float32 (`se3.mm`, `se3.mv`); 3x3
  determinants are written out. No call waits on the device for an error
  check (`inv_ex`, `solve_ex`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.solvers import pose_gn
from orbslam2_nmi_torch.solvers.sim3 import _intrinsics
from orbslam2_nmi_torch.utils.profiling import labelled


class PnPResult(NamedTuple):
    Tcw: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int32
    ok: torch.Tensor  # bool: enough inliers found


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _gram64(a: torch.Tensor) -> torch.Tensor:
    """a^T a over the last two axes, summed in float64 and rounded."""
    a = a.double()
    return (a.transpose(-1, -2) @ a).float()


def _generic_spd(n: int, device) -> torch.Tensor:
    """C C^T with C_ij = sin(0.7 (n i + j) + 1): a fixed symmetric matrix
    with generic eigenvectors, on which the EPnP systems have full rank."""
    c = torch.sin(torch.arange(n * n, dtype=torch.float32, device=device).reshape(n, n) * 0.7
                  + 1.0)
    return se3.mm(c, c.transpose(0, 1))


def _eigh(A: torch.Tensor):
    """torch.linalg.eigh of symmetric A [..., n, n]. Should the solver fail
    to converge on a finite batch and raise (CUDA's batched Jacobi did once
    on an EPnP batch, ROADMAP C9), the batch is solved again in float64 on
    its device and the result rounded; only a second failure raises."""
    try:
        return torch.linalg.eigh(A)
    except torch.linalg.LinAlgError:
        return tuple(x.to(A.dtype) for x in torch.linalg.eigh(A.double()))


_FAR = 1e15  # m; a coordinate's square stays far inside float32's range


def _flip_last(R_u: torch.Tensor, Vt: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """U diag(1, 1, det) V^T."""
    scale = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return se3.mm(R_u * scale[..., None, :], Vt)


def _dlt_pose(K, pts_w, uv, weights):
    """Weighted DLT for P = K [R|t] from >= 6 points; returns Tcw [..., 4, 4].
    `weights` [..., N] selects the sampled subset (0/1)."""
    fx, fy, cx, cy = _intrinsics(K)
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    one = torch.ones_like(x)
    Xh = torch.cat([pts_w, one[:, None]], dim=1)  # [N, 4]
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -x[:, None] * Xh], dim=1)  # [N, 12]
    r2 = torch.cat([zeros, Xh, -y[:, None] * Xh], dim=1)
    w = weights[..., :, None]
    A = torch.cat([r1 * w, r2 * w], dim=-2)
    vt = torch.linalg.svd(A, full_matrices=False)[2]
    m = vt[..., -1, :].reshape(*weights.shape[:-1], 3, 4)
    # the null vector's sign: the one that puts the sample in FRONT of the
    # camera, chosen before orthogonalizing (a flip after would break det R = 1)
    depths = se3.mv(m[..., None, 2:3, :], Xh)[..., 0]  # [..., N]
    flip = torch.sum((depths < 0) * weights, -1) > 0.5 * torch.sum(weights, -1)
    m = torch.where(flip[..., None, None], -m, m)
    U, S, Vt = torch.linalg.svd(m[..., :3])
    R = _flip_last(U, Vt, _det3(se3.mm(U, Vt)))
    scale = torch.sum(S, -1) / 3.0
    t = m[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return se3.make_se3(R, t)


def _procrustes_rt(pw, pc, w):
    """Weighted rigid alignment pc ~ R pw + t (rotation only, scale 1).
    pw [N, 3], pc [..., N, 3], w [..., N]."""
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)[..., None]
    cw = torch.sum(pw * w[..., None], -2) / wsum
    cc = torch.sum(pc * w[..., None], -2) / wsum
    qw = pw - cw[..., None, :]
    qc = pc - cc[..., None, :]
    H = ((qc * w[..., None])[..., :, :, None] * qw[..., :, None, :]).sum(-3)  # [..., 3, 3]
    U, _, Vt = torch.linalg.svd(H)
    R = _flip_last(U, Vt, _det3(se3.mm(U, Vt)))
    return R, cc - se3.mv(R, cw)


_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _dists(vc):  # squared control-point distances of a camera-frame candidate
    return torch.stack([torch.sum((vc[..., i, :] - vc[..., j, :]) ** 2, -1) for i, j in _PAIRS],
                       -1)


def _diffs(va, vb):  # cross terms
    return torch.stack([torch.sum((va[..., i, :] - va[..., j, :]) * (vb[..., i, :] - vb[..., j, :]),
                                  -1) for i, j in _PAIRS], -1)


def _reproj_err2(K, T, pts_w, uv):
    """Squared reprojection errors [..., N] of world points through T
    [..., 4, 4]; 1e12 behind the camera."""
    fx, fy, cx, cy = _intrinsics(K)
    pc = se3.mv(T[..., None, :3, :3], pts_w) + T[..., None, :3, 3]
    z = torch.where(torch.abs(pc[..., 2]) > 1e-9, pc[..., 2], 1e-9)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    return torch.where(pc[..., 2] > 0, err2, 1e12)


def epnp_pose(K, pts_w, uv, weights):
    """EPnP for the weighted point subset (weights [..., N] in {0, 1}, >= 4
    ones); returns Tcw [..., 4, 4]. Follows PnPsolver.cc:479 compute_pose, as
    the JAX package's `epnp_pose` does: the best of the three beta cases by
    reprojection error on the sample wins."""
    fx, fy, cx, cy = _intrinsics(K)
    w = weights
    dev = pts_w.device
    wsum = torch.clamp(torch.sum(w, -1), min=1e-9)
    usable = (pts_w.abs() < _FAR).all(-1)  # finite and far from overflow
    # hypotheses returned as NaN: those that sample an unusable point, and
    # all of them when a point is not finite (see the module docstring)
    bad = ((w > 0) & ~usable).any(-1) | ~torch.isfinite(pts_w).all()
    pts_w = torch.where(usable[:, None], pts_w, 0.0)

    # ---- control points: centroid + PCA axes
    c0 = torch.sum(pts_w * w[..., None], -2) / wsum[..., None]
    q = (pts_w - c0[..., None, :]) * w[..., None]
    cov = (q[..., :, :, None] * q[..., :, None, :]).sum(-3) / wsum[..., None, None]
    eval_, evec = _eigh(cov)  # ascending
    axes = evec * torch.sqrt(torch.clamp(eval_, min=1e-10))[..., None, :]
    C = torch.stack([c0, c0 + axes[..., :, 2], c0 + axes[..., :, 1], c0 + axes[..., :, 0]], -2)

    # ---- barycentric coordinates: X_i = sum_j alpha_ij C_j
    M34 = (C[..., 1:, :] - C[..., :1, :]).transpose(-1, -2)
    eye3 = torch.eye(3, dtype=pts_w.dtype, device=dev)
    Minv = torch.linalg.inv_ex(M34 + 1e-12 * eye3)[0]
    a123 = se3.mv(Minv[..., None, :, :], pts_w - C[..., None, 0, :])  # [..., N, 3]
    alpha = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)  # [..., N, 4]

    # ---- M (2N x 12) and its 12x12 normal matrix
    du = uv[:, 0] - cx
    dv = uv[:, 1] - cy
    zero = torch.zeros_like(alpha)
    r1 = torch.stack([alpha * fx, zero, -alpha * du[:, None]], -1).flatten(-2)  # [..., N, 12]
    r2 = torch.stack([zero, alpha * fy, -alpha * dv[:, None]], -1).flatten(-2)
    ws = torch.sqrt(w)[..., None]
    MtM = _gram64(r1 * ws) + _gram64(r2 * ws)
    # a near-singular control frame can give barycentric coordinates whose
    # squares overflow float32: the reference's eigen-solve then returns NaN,
    # CUDA's raises (ROADMAP C9), so such a hypothesis is solved on a fixed
    # matrix and returned as NaN
    nonfinite = ~torch.isfinite(MtM).all(-1).all(-1)
    bad = bad | nonfinite
    MtM = torch.where(nonfinite[..., None, None], _generic_spd(12, dev), MtM)
    V = _eigh(MtM)[1]  # ascending eigenvalues
    v = [V[..., :, k].reshape(*V.shape[:-2], 4, 3) for k in range(4)]

    rho = _dists(C)  # [..., 6] squared distances between the world control points

    def unit(k):
        return torch.eye(4, dtype=pts_w.dtype, device=dev)[k]

    def lstsq(A, b):
        return torch.linalg.lstsq(A, b[..., None], driver="gels").solution[..., 0]

    # ---- beta initializations (find_betas_approx_1/2/3, PnPsolver.cc:700-840)
    L11 = _dists(v[0])
    b1_c1 = torch.sqrt(torch.abs(torch.sum(L11 * rho, -1)
                                 / torch.clamp(torch.sum(L11 * L11, -1), min=1e-12)))
    betas_c1 = b1_c1[..., None] * unit(0)

    L2 = torch.stack([_dists(v[0]), 2.0 * _diffs(v[0], v[1]), _dists(v[1])], -1)  # [..., 6, 3]
    x2 = lstsq(L2, rho)
    b1_c2 = torch.sqrt(torch.abs(x2[..., 0]))
    sign2 = torch.sign(x2[..., 1]) * torch.sign(x2[..., 0] + 1e-30)
    b2_c2 = torch.sqrt(torch.abs(x2[..., 2])) * sign2
    betas_c2 = b1_c2[..., None] * unit(0) + b2_c2[..., None] * unit(1)

    L3 = torch.stack([_dists(v[0]), 2.0 * _diffs(v[0], v[1]), _dists(v[1]),
                      2.0 * _diffs(v[0], v[2]), 2.0 * _diffs(v[1], v[2])], -1)  # [..., 6, 5]
    x3 = lstsq(L3, rho)
    b1_c3 = torch.sqrt(torch.abs(x3[..., 0]))
    sign3 = torch.sign(x3[..., 1]) * torch.sign(x3[..., 0] + 1e-30)
    b2_c3 = torch.sqrt(torch.abs(x3[..., 2])) * sign3
    b3_c3 = x3[..., 3] / torch.clamp(b1_c3, min=1e-12) * torch.sign(x3[..., 0] + 1e-30)
    betas_c3 = b1_c3[..., None] * unit(0) + b2_c3[..., None] * unit(1) + b3_c3[..., None] * unit(2)

    # ---- Gauss-Newton on the betas (gauss_newton, PnPsolver.cc:842, 5 iterations)
    L10 = torch.stack([_dists(v[0]), 2.0 * _diffs(v[0], v[1]), _dists(v[1]),
                       2.0 * _diffs(v[0], v[2]), 2.0 * _diffs(v[1], v[2]), _dists(v[2]),
                       2.0 * _diffs(v[0], v[3]), 2.0 * _diffs(v[1], v[3]),
                       2.0 * _diffs(v[2], v[3]), _dists(v[3])], -1)  # [..., 6, 10]
    eye4 = torch.eye(4, dtype=pts_w.dtype, device=dev)

    def gn_refine(b):
        for _ in range(5):
            b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
            qv = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3, b1 * b4,
                              b2 * b4, b3 * b4, b4 * b4], -1)
            res = se3.mv(L10, qv) - rho
            c = [L10[..., :, k] for k in range(10)]
            bb = [x[..., None] for x in (b1, b2, b3, b4)]
            J = torch.stack([
                c[0] * 2 * bb[0] + c[1] * bb[1] + c[3] * bb[2] + c[6] * bb[3],
                c[1] * bb[0] + c[2] * 2 * bb[1] + c[4] * bb[2] + c[7] * bb[3],
                c[3] * bb[0] + c[4] * bb[1] + c[5] * 2 * bb[2] + c[8] * bb[3],
                c[6] * bb[0] + c[7] * bb[1] + c[8] * bb[2] + c[9] * 2 * bb[3],
            ], -1)  # [..., 6, 4]
            Jt = J.transpose(-1, -2)
            JtJ = se3.mm(Jt, J) + 1e-9 * eye4
            db = torch.linalg.solve_ex(JtJ, se3.mv(Jt, res)[..., None])[0][..., 0]
            b = b - db
        return b

    def pose_from_betas(betas):
        vc = sum(betas[..., k, None, None] * v[k] for k in range(4))  # [..., 4, 3]
        pc = se3.mm(alpha, vc)  # [..., N, 3] camera-frame points
        # positive depth (the null space's sign is arbitrary)
        pos = torch.sum((pc[..., 2] > 0) * w, -1) >= 0.5 * wsum
        pc = pc * torch.where(pos, 1.0, -1.0)[..., None, None]
        return se3.make_se3(*_procrustes_rt(pts_w, pc, w))

    def sample_err(T):
        return torch.sum(_reproj_err2(K, T, pts_w, uv) * w, -1) / wsum

    cand = torch.stack([pose_from_betas(gn_refine(b)) for b in (betas_c1, betas_c2, betas_c3)])
    errs = torch.stack([sample_err(T) for T in cand])  # [3, ...]
    best = torch.argmin(errs, dim=0)  # the first of equals, as jnp.argmin
    T = torch.gather(cand, 0, best[None, ..., None, None].expand(1, *cand.shape[1:]))[0]
    return torch.where(bad[..., None, None], float("nan"), T)


def _ransac_core(samples, K, pts_w, uv, inv_sigma2, valid, solver="epnp"):
    """Every hypothesis's minimal solve at once, its inliers counted; the
    best (first of equals) pose, its inlier mask and count."""
    n = pts_w.shape[0]
    minimal = epnp_pose if solver == "epnp" else _dlt_pose
    w = torch.zeros((samples.shape[0], n), dtype=pts_w.dtype, device=pts_w.device)
    w.scatter_(1, samples.long(), 1.0)
    Ts = minimal(K, pts_w, uv, w)
    inl = (_reproj_err2(K, Ts, pts_w, uv) * inv_sigma2 < pose_gn.CHI2_MONO) & valid
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    T = Ts[best]
    inl = (_reproj_err2(K, T, pts_w, uv) * inv_sigma2 < pose_gn.CHI2_MONO) & valid
    return T, inl, counts[best]


@labelled("pnp_ransac")
def pnp_ransac(
    samples: torch.Tensor,  # [H, 4] (EPnP) or [H, 6] (DLT) row indices
    K,
    pts_w: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    min_inliers: int = 10,
    solver: str = "epnp",
) -> PnPResult:
    """Full relocalization solve: batched minimal-solver RANSAC on the given
    samples, then the pose-only LM polish."""
    T, inl, _ = _ransac_core(samples, K, pts_w, uv, inv_sigma2, valid, solver)
    res = pose_gn.pose_optimization_k(K, T, pts_w, uv, inv_sigma2, inl)
    return PnPResult(Tcw=res.Tcw, inliers=res.inliers, n_inliers=res.n_inliers,
                     ok=res.n_inliers >= min_inliers)
