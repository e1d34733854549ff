"""Plain reference of the pointcloud render (render mode 4).

Frozen copies of the program's splat arithmetic (`orbslam2_nmi_torch/ops/
render.py`: `_min_pool`, `_splat`, `render_translation_grid`): each point's
quantized depth and gray packed into one int32 key, one scatter-min a
candidate's image, then a point_size x point_size min-pool. Plain PyTorch.

The points' camera-frame coordinates keep the program's float32 rounding
order (`geometry.mv_fma`, then the candidate's translation added in
float32), and the projection, the depth's quantization and the keys are
float32, as the program's are. A splat has no tolerance to round off: a
point's pixel is a rounded projection and its depth a truncated one, so a
coordinate one ulp off moves a point across a pixel or a depth level, and
the point that wins a pixel's scatter-min changes, with its gray. On the
CPU, the benchmark's terrain sampled at 400 points/m² (2,184,253 points) and
rendered at 960x540, 3 candidates 0.2 m apart along x at each of circuit
frames 40, 100, 260 and 400: projected in float64, the renders differ from
the program's at 6-22 pixels a frame, by up to 60-166 gray levels; the
float32 copy differs at none (PERF.md section 2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slambench.reference.geometry import mv_fma

_BIG = 2**30
_DEPTH_LEVELS = 2**22


class RenderModel:
    def __init__(self, points: torch.Tensor, gray: torch.Tensor):
        self.points, self.gray = points, gray


def _min_pool(key_img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size min-pool, stride 1, of int32 key images [..., H, W], padded
    with the empty key as XLA's "SAME" padding does ((size - 1) // 2 before,
    the rest after). Exact on int32: a float pool would round keys past 2^24."""
    if size <= 1:
        return key_img
    lo = (size - 1) // 2
    hi = size - 1 - lo
    h, w = key_img.shape[-2:]
    padded = F.pad(key_img, (lo, hi, lo, hi), value=_BIG)
    rows = padded[..., 0:h, :]
    for d in range(1, size):
        rows = torch.minimum(rows, padded[..., d:d + h, :])
    out = rows[..., 0:w]
    for d in range(1, size):
        out = torch.minimum(out, rows[..., d:d + w])
    return out


def _splat(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, gray: torch.Tensor, K,
           height: int, width: int, near: float, far: float, point_size: int,
           background: float) -> torch.Tensor:
    """Render S sets of camera-frame points (coordinates x, y, z [S, P], gray
    [P]) into [S, H, W] f32."""
    S = z.shape[0]
    dev = z.device
    K_host = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, np.float32)
    fx, fy, cx, cy = (torch.tensor(K_host[i, j], device=dev)
                      for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    z_safe = torch.where(z > 1e-6, z, torch.tensor(1e-6, device=dev))
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    ok = (z > near) & (z < far) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    # the reference's compiled (z - near) / (far - near): times the f32 reciprocal
    inv_range = torch.tensor(np.float32(1.0) / np.float32(far - near), device=dev)
    zq = torch.clamp(((z - near) * inv_range * _DEPTH_LEVELS).to(torch.int32), 0, _DEPTH_LEVELS - 1)
    g8 = torch.clamp(gray, 0, 255).to(torch.int32)
    key = torch.where(ok, zq * 256 + g8, _BIG)
    # masked points write the empty key to their render's pixel 0, which
    # leaves it as it was
    base = torch.arange(S, device=dev, dtype=torch.int64)[:, None] * (height * width)
    pix = torch.where(ok, vi.to(torch.int64) * width + ui, 0) + base
    buf = torch.full((S * height * width,), _BIG, dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin", include_self=True)
    img_key = _min_pool(buf.reshape(S, height, width), point_size)
    return torch.where(img_key < _BIG, (img_key % 256).to(torch.float32),
                       torch.tensor(background, dtype=torch.float32, device=dev))


def render_translation_grid(
    model: RenderModel,
    Tcw: torch.Tensor,
    K,
    offsets_cam: torch.Tensor,  # [S, 3] camera-axis offsets of the camera center
    height: int,
    width: int,
    near: float,
    far: float,
    point_size: int = 3,
    round_to: torch.dtype | None = None,
) -> torch.Tensor:
    """Render every translation candidate: [S, H, W] float32, one scatter over
    all S x P points. `round_to` (the control) rounds the camera-frame
    coordinates to that type before they are projected."""
    dev = model.points.device
    Tcw = torch.as_tensor(Tcw, dtype=torch.float32, device=dev)
    offsets_cam = torch.as_tensor(offsets_cam, dtype=torch.float32, device=dev)
    # the camera-frame coordinates in the program's float32 order, each [S, P]
    rotated = mv_fma(Tcw[:3, :3], model.points).T  # [3, P]
    t_all = Tcw[:3, 3][None, :] - offsets_cam  # [S, 3]
    xyz = [rotated[i][None, :] + t_all[:, i:i + 1] for i in range(3)]
    if round_to is not None:
        xyz = [c.to(round_to).to(torch.float32) for c in xyz]
    return _splat(*xyz, model.gray, K, height, width, near, far, point_size, 0.0)


def translation_grid_offsets(
    synth_num: tuple[int, int, int],
    synth_step: tuple[float, float, float],
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """[S, 3] camera-axis offsets, centered grid; index s = (sz*ny + sy)*nx + sx
    (matches the rating-array layout localization.cpp:185-210)."""
    nx, ny, nz = synth_num
    sx, sy, sz = synth_step
    f32 = dict(dtype=torch.float32, device=device)
    ox = (torch.arange(nx, **f32) - (nx - 1) / 2.0) * sx
    oy = (torch.arange(ny, **f32) - (ny - 1) / 2.0) * sy
    oz = (torch.arange(nz, **f32) - (nz - 1) / 2.0) * sz
    OZ, OY, OX = torch.meshgrid(oz, oy, ox, indexing="ij")
    return torch.stack([OX.reshape(-1), OY.reshape(-1), OZ.reshape(-1)], dim=-1)
