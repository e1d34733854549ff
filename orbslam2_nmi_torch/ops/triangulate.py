"""Batched two-view triangulation + acceptance gates.

Port of `orbslam2_nmi_tpu/ops/triangulate.py`, the replacement for
Initializer::Triangulate (reference: src/Initializer.cc:749, per-point DLT via
cv::SVD) and the triangulation gates of LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:210: parallax, positive depth, reprojection chi2).

Where the port differs, or is likely to trip:

* `vmap` over neighbour pairs becomes leading batch axes: the poses are
  [..., 4, 4] and the pixels [..., N, 2], and `triangulate_and_gate_batch`
  broadcasts the new keyframe's pose over the pair axis.
* The DLT takes the last right singular vector of a batched [..., N, 4, 4]
  `torch.linalg.svd`. Its sign is arbitrary and cancels in x / w; the
  singular vectors of LAPACK and cuSOLVER differ by float32 rounding, so the
  points are held to a tolerance and the gates exactly except within an
  epsilon of their thresholds (tests/test_torch_triangulate.py).
* Every small product (the projection matrices, the camera centres, the
  reprojections) is a fused-multiply-add float32 product (`se3.mm_fma`,
  `se3.se3_apply`), as the JAX package's HIGHEST products are; no TF32 flag
  reaches it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.utils.profiling import labelled


class TriangulationResult(NamedTuple):
    points_w: torch.Tensor  # [..., N, 3] world points
    valid: torch.Tensor  # [..., N] bool: passed all gates
    parallax_cos: torch.Tensor  # [..., N]


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """P = K [R|t] for world->pixel projection: [..., 3, 4]."""
    return se3.mm_fma(K, Tcw[..., :3, :4])


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear DLT triangulation. P*: [..., 3, 4]; uv*: [..., N, 2] pixels.
    Returns [..., N, 3].

    Same construction as Initializer::Triangulate (Initializer.cc:749):
    rows u*P3 - P1row, v*P3 - P2row for both views; the solution is the last
    right singular vector.
    """
    def rows(P, uv):
        P = P[..., None, :, :]  # broadcast over the N points
        a = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        b = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([a, b], dim=-2)  # [..., N, 2, 4]

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], dim=-2)  # [..., N, 4, 4]
    vt = torch.linalg.svd(A).Vh
    x = vt[..., 3, :]
    w = x[..., 3]
    w_safe = torch.where(torch.abs(w) > 1e-10, w, 1e-10)
    return x[..., :3] / w_safe[..., None]


def triangulate_and_gate(
    K: torch.Tensor,
    Tcw1: torch.Tensor,
    Tcw2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    min_parallax_cos: float = 0.9998,
    chi2_thresh: float = 5.991,
) -> TriangulationResult:
    """Triangulate matches between two posed views ([..., 4, 4] each, pixels
    [..., N, 2]) and apply the reference's acceptance gates
    (LocalMapping.cc:210 CreateNewMapPoints):
      * parallax: cos(ray angle) < min_parallax_cos (0.9998 ~ 1.15 deg)
      * positive depth in both cameras
      * reprojection chi2 <= 5.991 / sigma2 in both views
    """
    pts_w = triangulate_dlt(projection_matrix(K, Tcw1), projection_matrix(K, Tcw2), uv1, uv2)
    zero = torch.zeros(3, dtype=pts_w.dtype, device=pts_w.device)
    c1 = se3.se3_apply(se3.se3_inverse(Tcw1), zero)[..., None, :]  # camera centres (world)
    c2 = se3.se3_apply(se3.se3_inverse(Tcw2), zero)[..., None, :]
    r1 = pts_w - c1
    r2 = pts_w - c2
    cos_par = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1) + 1e-12)

    def reproj_ok(Tcw, uv, inv_s2):
        pc = se3.se3_apply(Tcw[..., None, :, :], pts_w)
        z = pc[..., 2]
        zs = torch.where(z > 1e-9, z, 1e-9)
        u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
        v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
        err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
        return (z > 0) & (err2 * inv_s2 <= chi2_thresh)

    ok = (
        valid
        & (cos_par < min_parallax_cos)
        & (cos_par > 0)
        & reproj_ok(Tcw1, uv1, inv_sigma2_1)
        & reproj_ok(Tcw2, uv2, inv_sigma2_2)
        & torch.isfinite(pts_w).all(dim=-1)
    )
    return TriangulationResult(points_w=pts_w, valid=ok, parallax_cos=cos_par)


@labelled("triangulate_and_gate_batch")
def triangulate_and_gate_batch(
    K: torch.Tensor,
    Tcw1: torch.Tensor,  # [4, 4] the new keyframe (shared)
    Tcw2_b: torch.Tensor,  # [N, 4, 4] neighbour poses
    uv1_b: torch.Tensor,  # [N, NB, 2]
    uv2_b: torch.Tensor,  # [N, NB, 2]
    is2_1_b: torch.Tensor,  # [N, NB]
    is2_2_b: torch.Tensor,  # [N, NB]
    valid_b: torch.Tensor,  # [N, NB]
) -> TriangulationResult:
    """All neighbour pairs of CreateNewMapPoints triangulated and gated in
    one batched call. Fields come back with a leading [N] pair axis."""
    return triangulate_and_gate(K, Tcw1.expand(Tcw2_b.shape[0], 4, 4), Tcw2_b, uv1_b, uv2_b,
                                is2_1_b, is2_2_b, valid_b)
