"""Pinhole camera model: projection, unprojection, undistortion.

Port of `orbslam2_nmi_tpu/geometry/camera.py`, which replaces the reference's
per-frame OpenCV undistort (Frame::UndistortKeyPoints, src/Frame.cc:442) and
the frustum check (Frame::isInFrustum, src/Frame.cc:308) with batched tensor
ops. `K` and `dist` may be tensors or numpy arrays; their entries are read as
scalars, so a tensor `K` should lie on the host or on the points' device.
"""

from __future__ import annotations

import numpy as np
import torch


def project(K, pts_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame 3-D points [..., 3] to pixels [..., 2]."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u = K[0, 0] * pts_cam[..., 0] * inv_z + K[0, 2]
    v = K[1, 1] * pts_cam[..., 1] * inv_z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def unproject(K, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] -> camera-frame 3-D points [..., 3]."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Apply radial-tangential distortion (k1, k2, p1, p2, k3) to normalized
    coordinates."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(K, dist, uv: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Iterative undistortion (cv::undistortPoints equivalent) of pixel
    coordinates: the fixed-point iteration x <- xd - delta(x), a static
    `iters` times."""
    x0 = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y0 = (uv[..., 1] - K[1, 2]) / K[1, 1]
    xd = torch.stack([x0, y0], dim=-1)
    xy = xd
    for _ in range(iters):
        xy = xd - (distort_normalized(xy, dist) - xy)
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def compute_image_bounds(K: np.ndarray, dist: np.ndarray, width: int, height: int):
    """Undistorted image bounds (Frame::ComputeImageBounds, src/Frame.cc:~470),
    on the host."""
    if not np.any(np.abs(dist) > 0):
        return 0.0, float(width), 0.0, float(height)
    corners = torch.tensor([[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
                           dtype=torch.float32)
    und = undistort_points(torch.as_tensor(np.asarray(K, np.float32)),
                           torch.as_tensor(np.asarray(dist, np.float32)), corners).numpy()
    return (
        float(min(und[0, 0], und[2, 0])),
        float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])),
        float(max(und[2, 1], und[3, 1])),
    )
