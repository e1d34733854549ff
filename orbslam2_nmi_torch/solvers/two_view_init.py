"""Classic two-view monocular initialization: H/F RANSAC and reconstruction.

Port of `orbslam2_nmi_tpu/solvers/two_view_init.py`, the reference's
Initializer (src/Initializer.cc): FindHomography (:132) and FindFundamental
(:183), both model families scored on every hypothesis at once; model
selection RH = SH/(SH+SF) > 0.40 (:105-128); ReconstructF through the
essential matrix and cheirality (:484, DecomposeE :924); ReconstructH by the
Faugeras 8-solution decomposition (:587). Scoring constants are the
reference's: chi2 thresholds 5.991 (H) and 3.841 (F), score offset 5.991 per
inlier.

Where the port differs: the JAX package draws each hypothesis's rows with
`jax.random.choice` under a vmap, one key a hypothesis shared by the H and
the F draw. The port takes the rows as arguments (`h_samples` [H, 4],
`f_samples` [H, 8]), drawn by the caller (the tracker on a seeded CPU
generator, the tests from the JAX package's keys). The 3x3 products go
through `se3.mm`/`mv` (plain float32 whatever the TF32 flags); the inverse
is `inv_ex`, which does not wait on the device.

The NMI pipeline bypasses this (Tracking.cc:386-387 uses InitializeWithNMI);
`Tracker._initialize_classic` calls it for model-free operation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.ops import triangulate

TH_H = 5.991
TH_F = 3.841
SCORE_OFFSET = 5.991
N_HYPOTHESES = 200


class InitResult(NamedTuple):
    ok: torch.Tensor  # bool
    used_homography: torch.Tensor  # bool
    Tcw2: torch.Tensor  # [4, 4] pose of view 2 (view 1 at identity)
    points_w: torch.Tensor  # [N, 3] triangulated
    inliers: torch.Tensor  # [N] bool


def _mat3(rows, like):
    """A [..., 3, 3] matrix from nine broadcastable entries (row major)."""
    rows = [torch.as_tensor(r, dtype=like.dtype, device=like.device) for r in rows]
    shape = torch.broadcast_shapes(*(r.shape for r in rows))
    return torch.stack([r.expand(shape) for r in rows], -1).reshape(*shape, 3, 3)


def _normalize(uv, valid):
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = torch.abs(uv - mean) * w[:, None]
    s = 1.0 / torch.clamp(d.sum(0) / n, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = _mat3([s[0], z, -mean[0] * s[0], z, s[1], -mean[1] * s[1], z, z, o], uv)
    return (uv - mean) * s[None, :], T


def _null_vector(A):
    """The right singular vector of the smallest singular value, [..., 9]."""
    return torch.linalg.svd(A, full_matrices=False)[2][..., -1, :]


def _dlt_homography(p1, p2, w):
    """Weighted DLT for H p1 ~ p2 (normalized coordinates), one [H, N] weight
    row a hypothesis."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    return _null_vector(A).reshape(*w.shape[:-1], 3, 3)


def _eight_point(p1, p2, w):
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1) * w[..., None]
    F = _null_vector(A).reshape(*w.shape[:-1], 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)  # rank 2
    return se3.mm(U * S[..., None, :], Vt)


def _homog(a):
    return torch.cat([a, torch.ones_like(a[:, :1])], 1)


def _homography_score(H, uv1, uv2, valid):
    """Symmetric transfer error score (CheckHomography, Initializer.cc:240),
    for H [..., 3, 3]: (score [...], inliers [..., N])."""
    def transfer(H, a, b):
        p = se3.mv(H[..., None, :, :], _homog(a))
        p = p[..., :2] / torch.where(torch.abs(p[..., 2:3]) > 1e-9, p[..., 2:3], 1e-9)
        return torch.sum((p - b) ** 2, -1)

    Hi = torch.linalg.inv_ex(H)[0]
    e12 = transfer(H, uv1, uv2)
    e21 = transfer(Hi, uv2, uv1)
    ok = (e12 < TH_H) & (e21 < TH_H) & valid
    score = torch.sum(torch.where(ok, (TH_H - e12) + (TH_H - e21), 0.0), -1)
    return score, ok


def _fundamental_score(F, uv1, uv2, valid):
    """Epipolar distance score (CheckFundamental, Initializer.cc:330)."""
    o1, o2 = _homog(uv1), _homog(uv2)
    l2 = se3.mv(F[..., None, :, :], o1)  # lines in image 2
    l1 = se3.mv(F.transpose(-1, -2)[..., None, :, :], o2)  # lines in image 1
    d2 = torch.sum(l2 * o2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * o1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    ok = (d1 < TH_F) & (d2 < TH_F) & valid
    score = torch.sum(torch.where(ok, (SCORE_OFFSET - d1) + (SCORE_OFFSET - d2), 0.0), -1)
    return score, ok


def _check_rt(R, t, K, uv1, uv2, valid):
    """CheckRT (Initializer.cc:813) for all candidates [C] at once:
    triangulate and count the good points."""
    C, n = R.shape[0], uv1.shape[0]
    T2 = se3.make_se3(R, t)
    T1 = torch.eye(4, dtype=R.dtype, device=R.device).expand(C, 4, 4)
    ones = torch.ones((C, n), dtype=uv1.dtype, device=uv1.device)
    res = triangulate.triangulate_and_gate(
        K, T1, T2, uv1.expand(C, n, 2), uv2.expand(C, n, 2), ones, ones,
        valid.expand(C, n), min_parallax_cos=0.99998, chi2_thresh=4.0 * 4.0)
    return res.valid.sum(-1), res


def _decompose_e(E):
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = _mat3([0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0], E)
    R1 = se3.mm(se3.mm(U, W), Vt)
    R2 = se3.mm(se3.mm(U, W.T), Vt)
    t = U[:, 2]
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_h(H, K):
    """Faugeras SVD decomposition of A = K^-1 H K (ReconstructH,
    Initializer.cc:587): 8 candidate (R, t) pairs."""
    A = se3.mm(se3.mm(torch.linalg.inv_ex(K)[0], H), K)
    U, S, Vt = torch.linalg.svd(A)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    out = []
    # d' = d2
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        st = sin_t * torch.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        Rp = _mat3([cos_t, zero, -st, zero, one, zero, st, zero, cos_t], H)
        R = s * se3.mm(se3.mm(U, Rp), Vt)
        t = se3.mv(U, torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
        out.append((R, t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)))
    # d' = -d2
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sp = sin_p * torch.where(x1s[i] * x3s[i] >= 0, 1.0, -1.0)
        Rp = _mat3([cos_p, zero, sp, zero, -one, zero, sp, zero, -cos_p], H)
        R = s * se3.mm(se3.mm(U, Rp), Vt)
        t = se3.mv(U, torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
        out.append((R, t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)))
    return out


def initialize_two_view(h_samples, f_samples, K, uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor) -> InitResult:
    """Full two-view initialization (Initializer::Initialize, :48).

    `h_samples` [H, 4] and `f_samples` [H, 8] are each hypothesis's rows
    (among the valid rows, which come first); `uv1`, `uv2` [N, 2] pixels and
    `valid` [N] on the solve's device; `K` 3x3 (host or device)."""
    dev = uv1.device
    K = torch.as_tensor(np.asarray(K, np.float32) if not isinstance(K, torch.Tensor) else K,
                        dtype=torch.float32, device=dev)
    n = uv1.shape[0]
    p1n, T1 = _normalize(uv1, valid)
    p2n, T2 = _normalize(uv2, valid)

    def one_hot(samples):
        s = torch.as_tensor(samples, device=dev).long()
        w = torch.zeros((s.shape[0], n), dtype=torch.float32, device=dev)
        return w.scatter_(1, s, 1.0)

    Hn = _dlt_homography(p1n, p2n, one_hot(h_samples))
    Hs = se3.mm(se3.mm(torch.linalg.inv_ex(T2)[0], Hn), T1)
    h_scores, _ = _homography_score(Hs, uv1, uv2, valid)
    Fn = _eight_point(p1n, p2n, one_hot(f_samples))
    Fs = se3.mm(se3.mm(T2.T, Fn), T1)
    f_scores, _ = _fundamental_score(Fs, uv1, uv2, valid)
    bH, bF = torch.argmax(h_scores), torch.argmax(f_scores)
    H, SH = Hs[bH], h_scores[bH]
    F, SF = Fs[bF], f_scores[bF]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40  # Initializer.cc:125
    _, h_inl = _homography_score(H, uv1, uv2, valid)
    _, f_inl = _fundamental_score(F, uv1, uv2, valid)

    # reconstruct both families, pick by the selected model
    E = se3.mm(se3.mm(K.T, F), K)
    cands = _decompose_e(E) + _decompose_h(H, K)
    R = torch.stack([r for r, _ in cands])
    t = torch.stack([tt for _, tt in cands])
    counts, res = _check_rt(R, t, K, uv1, uv2, torch.where(use_h, h_inl, f_inl))
    idx = torch.arange(12, device=dev)
    e_counts = torch.where(idx < 4, counts, -1)
    h_counts = torch.where(idx >= 4, counts, -1)
    best = torch.where(use_h, torch.argmax(h_counts), torch.argmax(e_counts))
    n_best = counts[best]
    second = torch.sort(torch.where(use_h, h_counts, e_counts)).values[-2]
    n_inliers_model = torch.sum(torch.where(use_h, h_inl, f_inl))
    ok = ((n_best >= 30) & (n_best.float() > 0.75 * n_inliers_model.float())
          & (second.float() < 0.75 * n_best.float()))
    return InitResult(ok=ok, used_homography=use_h, Tcw2=se3.make_se3(R[best], t[best]),
                      points_w=res.points_w[best], inliers=res.valid[best])
