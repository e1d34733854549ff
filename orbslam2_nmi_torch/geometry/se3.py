"""SO(3) and SE(3) operations in torch float32.

Port of the part of `orbslam2_nmi_tpu/geometry/se3.py` that the NMI grid step
and the localizer reach (`hat`, `so3_exp`, `make_se3`, `se3_inverse`,
`se3_apply`, `se3_compose`); the rest of the Lie-group module comes with the
tracking slice. Poses Tcw are 4x4 world->camera transforms. Pose math stays in
full float32: no TF32, no bf16.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> 3x3 rotation. Safe at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * torch.matmul(W, W)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 from 3x3 R and 3-vector t. Batched."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to 3-points ([..., 3])."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)
