"""Plain reference of the rotation warps.

Frozen copies of the program's warp arithmetic (`orbslam2_nmi_torch/ops/
homography.py`): H = K Rz Ry Rx K^-1 for each rotation hypothesis, and the
reference system's rule between the separable two-pass warp (shift bound
at most 64 px) and the exact bilinear inverse warp. Plain PyTorch.

The homographies keep the program's float32 rounding order
(`geometry.mm_fma`), as the splat's coordinates do (`splat.py`): the grid's
centre, the identity rotation, warps an integer frame onto integer grays,
and a float32 identity homography moves every source by up to an ulp of the
principal point (3.05e-5 px at 960x540), which puts column 0 outside and
half of the grays a bin lower. A float64 build scores that warp 1.4e-3 to
1.8e-3 apart and moves the best cell on sound runs (PERF.md section 2).
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.geometry import mm_fma, so3_exp_f32

MAX_TWO_PASS_SHIFT = 64


def _inverse(Hs: torch.Tensor) -> torch.Tensor:
    # inv_ex: the inverse without the error check, which would wait on the device
    return torch.linalg.inv_ex(Hs).inverse


def rotation_grid_angles(warp_num: tuple[int, int, int], warp_step: tuple[float, float, float],
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """[R, 3] angles (ax, ay, az) for the full rotation grid, centered on zero.

    Index r = (wz * numWarpY + wy) * numWarpX + wx, each axis spanning
    (i - (n-1)/2) * step (image.cpp:76-108 center-offset convention).
    """
    nx, ny, nz = warp_num
    sx, sy, sz = warp_step
    f32 = dict(dtype=torch.float32, device=device)
    ax = (torch.arange(nx, **f32) - (nx - 1) / 2.0) * sx
    ay = (torch.arange(ny, **f32) - (ny - 1) / 2.0) * sy
    az = (torch.arange(nz, **f32) - (nz - 1) / 2.0) * sz
    AZ, AY, AX = torch.meshgrid(az, ay, ax, indexing="ij")  # [nz, ny, nx]
    return torch.stack([AX.reshape(-1), AY.reshape(-1), AZ.reshape(-1)], dim=-1)


def homographies_from_angles(K: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[R, 3] Euler angles -> [R, 3, 3] homographies H = K Rz Ry Rx K^-1."""
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)
    Rx = so3_exp_f32(eye[0] * angles[:, 0:1])
    Ry = so3_exp_f32(eye[1] * angles[:, 1:2])
    Rz = so3_exp_f32(eye[2] * angles[:, 2:3])
    R = mm_fma(mm_fma(Rz, Ry), Rx)
    # float32 products whatever the TF32 flags (the reference pins HIGHEST,
    # homography.py:46-47); inv_ex does not wait on the device for an error
    # check
    return mm_fma(mm_fma(K, R), torch.linalg.inv_ex(K).inverse)


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return xs.to(torch.float32), ys.to(torch.float32)


def _src_uv(Hi: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Source coordinates of destination pixels (x, y) [.., h, w] under the
    inverse homographies Hi [R, 3, 3] -> (u, v), each [R, h, w]."""
    h = [Hi[:, i, j][:, None, None] for i in range(3) for j in range(3)]
    denom = h[6] * x + h[7] * y + h[8]
    denom = torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
    u = (h[0] * x + h[1] * y + h[2]) / denom
    v = (h[3] * x + h[4] * y + h[5]) / denom
    return u, v


def warp_bilinear(img: torch.Tensor, Hs: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Inverse-warp a [H, W] image by each of the 3x3 homographies Hs [R, 3, 3]
    (dst->src uses H^-1): [R, H, W] float32."""
    h, w = img.shape
    xs, ys = _pixel_grid(h, w, img.device)
    u, v = _src_uv(_inverse(Hs), xs, ys)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u0i = torch.clamp(u0.to(torch.int64), 0, w - 1)
    v0i = torch.clamp(v0.to(torch.int64), 0, h - 1)
    u1i = torch.clamp(u0i + 1, 0, w - 1)
    v1i = torch.clamp(v0i + 1, 0, h - 1)
    f = img.to(torch.float32).reshape(-1)
    base0 = v0i * w
    base1 = v1i * w
    val = (
        f[base0 + u0i] * (1 - du) * (1 - dv)
        + f[base0 + u1i] * du * (1 - dv)
        + f[base1 + u0i] * (1 - du) * dv
        + f[base1 + u1i] * du * dv
    )
    return torch.where(inb, val, fill)


def _shift_resample(img: torch.Tensor, src: torch.Tensor, axis: int, k_min: int, k_max: int):
    """Resample [R, h, w] along `axis` (1 = rows, 2 = columns):
    out[i] = img[src[i]] (bilinear), where src - i is within [k_min, k_max].
    Returns (values, in_range_mask). Same values as the reference's roll bank:
    each tap reads (i + k) mod n and is zero when k is outside the bank."""
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device)
    idx = idx[:, None] if axis == 1 else idx[None, :]
    shift = src - idx
    k0f = torch.floor(shift)
    k0 = k0f.to(torch.int64)
    frac = shift - k0f
    in0 = (k0 >= k_min) & (k0 <= k_max)
    in1 = (k0 + 1 >= k_min) & (k0 + 1 <= k_max)
    tap0 = torch.gather(img, axis, torch.remainder(idx + k0, n))
    tap1 = torch.gather(img, axis, torch.remainder(idx + k0 + 1, n))
    acc0 = torch.where(in0, tap0, 0.0)
    acc1 = torch.where(in1, tap1, 0.0)
    out = acc0 * (1.0 - frac) + acc1 * frac
    ok = (src >= 0) & (src <= n - 1) & (k0 >= k_min) & (k0 + 1 <= k_max)
    return out, ok


def warp_two_pass(img: torch.Tensor, Hs: torch.Tensor, max_shift, fill: float = 0.0) -> torch.Tensor:
    """Separable homography warp of a [H, W] image by each of Hs [R, 3, 3]:
    [R, H, W]. `max_shift` bounds |source - dest| per axis (an int, or a
    (vertical, horizontal) pair)."""
    h, w = img.shape
    R = Hs.shape[0]
    Hi = _inverse(Hs)
    xs, ys = _pixel_grid(h, w, img.device)
    u, v = _src_uv(Hi, xs, ys)
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    du = u - xs
    # Catmull-Smith correction: the vertical pass must fetch the row the
    # HORIZONTAL source will need, so evaluate v at x' = x - du
    _, v_corr = _src_uv(Hi, xs - du, ys.expand(R, h, w))
    mv, mh = max_shift if isinstance(max_shift, tuple) else (max_shift, max_shift)
    img_r = img.to(torch.float32).expand(R, h, w)
    tmp, ok_v = _shift_resample(img_r, v_corr, axis=1, k_min=-mv, k_max=mv)
    out, ok_u = _shift_resample(tmp, u, axis=2, k_min=-mh, k_max=mh)
    return torch.where(inb & ok_v & ok_u, out, fill)


def shift_bounds_for_angles(
    K: np.ndarray, angles: np.ndarray, height: int, width: int
) -> tuple[int, int]:
    """Static (vertical, horizontal) pixel-shift bounds for a rotation grid.

    Rotation about x moves pixels vertically (~fy*ax), about y horizontally
    (~fx*ay), about z tangentially (~az * corner radius per axis); small
    projective terms are covered by the margin.
    """
    K = np.asarray(K)
    a = np.abs(np.asarray(angles))
    ax, ay, az = a[:, 0].max(initial=0), a[:, 1].max(initial=0), a[:, 2].max(initial=0)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    half_w = max(cx, width - cx)
    half_h = max(cy, height - cy)
    vert = fy * ax * 1.2 + az * half_w + 3.0
    horiz = fx * ay * 1.2 + az * half_h + 3.0
    return int(np.ceil(vert)), int(np.ceil(horiz))


def warp_homographies(img: torch.Tensor, Hs: torch.Tensor, bound: tuple[int, int]) -> torch.Tensor:
    """Warp `img` [H, W] by the homographies Hs [R, 3, 3] whose shifts are
    bounded by `bound` (from `shift_bounds_for_angles`): [R, H, W] float32.
    The reference's rule: the two-pass warp when the bound is at most
    MAX_TWO_PASS_SHIFT, else the exact bilinear warp."""
    if max(bound) <= MAX_TWO_PASS_SHIFT:
        return warp_two_pass(img, Hs, bound)
    return warp_bilinear(img, Hs)


def warp_rotation_grid(img: torch.Tensor, K, angles, round_to=None) -> torch.Tensor:
    """Warp `img` [H, W] by every rotation hypothesis: [R, H, W] float32.

    `K` and `angles` may be numpy arrays or tensors; they are read on the host
    to bound the shifts. `round_to`, a dtype, rounds the homographies to it
    before they are used (the control's lower precision).
    """
    K_np = K.cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    ang_np = angles.cpu().numpy() if isinstance(angles, torch.Tensor) else np.asarray(angles)
    f32 = dict(dtype=torch.float32, device=img.device)
    Hs = homographies_from_angles(torch.as_tensor(K_np, **f32), torch.as_tensor(ang_np, **f32))
    if round_to is not None:
        Hs = Hs.to(round_to).to(torch.float32)
    return warp_homographies(img, Hs, shift_bounds_for_angles(K_np, ang_np, *img.shape))
