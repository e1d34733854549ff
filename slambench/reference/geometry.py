"""Pose arithmetic of the plain reference.

Poses: rotations, their products and rigid inverses as the textbook states
them, in float64 whatever the program's order of rounding; a pose is
rounded to float32 only where it is handed on as the program hands it on
(a sweep's centre pose), so the reference's poses differ from a sound
float32 program's by rounding alone.

The warp's homographies and the splat's camera-frame coordinates alone
keep the program's float32 rounding order (`mm_fma`, `mv_fma`,
`so3_exp_f32`, frozen copies of `orbslam2_nmi_torch/geometry/se3.py`'s):
each fused step a float64 product and sum rounded once to float32. Why, in
`warp.py` and `splat.py`.
"""

from __future__ import annotations

import numpy as np
import torch


_EPS = 1e-8


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    acc = (a[..., 0] * b[..., 0]).float()
    for k in range(1, a.shape[-1]):
        acc = (a[..., k] * b[..., k] + acc.double()).float()
    return acc


def mm_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fma_dot(a[..., :, None, :], b.transpose(-1, -2)[..., None, :, :])


def mv_fma(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _fma_dot(a, v[..., None, :])


def so3_exp_f32(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula in float32, the program's order of rounding."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * mm_fma(W, W)


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([torch.stack([zero, -wz, wy], dim=-1),
                        torch.stack([wz, zero, -wx], dim=-1),
                        torch.stack([-wy, wx, zero], dim=-1)], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, float64: [..., 3] axis-angle -> [..., 3, 3]."""
    w = w.to(torch.float64)
    theta = torch.linalg.vector_norm(w, dim=-1)
    small = theta < 1e-12
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, torch.ones_like(theta), torch.sin(safe) / safe)
    b = torch.where(small, torch.full_like(theta, 0.5), (1.0 - torch.cos(safe)) / (safe * safe))
    W = hat(w)
    eye = torch.eye(3, dtype=torch.float64, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def inverse_host(T: np.ndarray) -> np.ndarray:
    """The rigid inverse of a [4, 4] pose, float64."""
    T = np.asarray(T, np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def euler_zyx_matrix(angles) -> np.ndarray:
    """R = Rz(az) Ry(ay) Rx(ax), float64."""
    a = torch.as_tensor(np.asarray(angles, np.float64))
    eye = torch.eye(3, dtype=torch.float64)
    return (so3_exp(eye[2] * a[2]) @ so3_exp(eye[1] * a[1]) @ so3_exp(eye[0] * a[0])).numpy()
