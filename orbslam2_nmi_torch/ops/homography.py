"""Rotation-hypothesis image warping for the NMI search.

Port of `orbslam2_nmi_tpu/ops/homography.py` (the reference's Image class,
Thirdparty/Localization/image.cpp:33-285: numWarp^3 homographies
H = K Rz Ry Rx K^-1 and one warpPerspective each). The whole rotation grid is
warped in one batched pass of torch ops; there is no TPU kernel here.

The reference chooses between two warps, and so does the port, by the same
rule, so that both compute the same images:
  * `warp_bilinear`, the exact inverse-warp bilinear sample (a gather);
  * `warp_two_pass`, a separable approximation (vertical then horizontal
    resample, the vertical source Catmull-Smith-corrected) taken whenever the
    static shift bound is <= MAX_TWO_PASS_SHIFT (64 px). The reference realizes each 1-D resample as
    a bank of static rolls and selects, because gathers were slow on its chip;
    for every pixel that bank is a 1-D bilinear lookup at (i + k0) mod n and
    (i + k0 + 1) mod n, each tap zeroed outside [k_min, k_max]. The port does
    that lookup with `torch.gather`, which gives the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.ops import render
from orbslam2_nmi_torch.utils.profiling import labelled

MAX_TWO_PASS_SHIFT = 64  # px: the largest shift bound the two-pass warp takes


def _inverse(Hs: torch.Tensor) -> torch.Tensor:
    # inv_ex: the inverse without the error check, which would wait on the device
    return torch.linalg.inv_ex(Hs).inverse


def rotation_grid_angles(warp_num: tuple[int, int, int], warp_step: tuple[float, float, float],
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """[R, 3] angles (ax, ay, az) for the full rotation grid, centered on zero:
    the grid and index of `render.translation_grid_offsets`, in radians
    (image.cpp:76-108 center-offset convention)."""
    return render.translation_grid_offsets(warp_num, warp_step, device)


def homographies_from_angles(K: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[R, 3] Euler angles -> [R, 3, 3] homographies H = K Rz Ry Rx K^-1."""
    # float32 products whatever the TF32 flags (the reference pins HIGHEST,
    # homography.py:46-47); inv_ex does not wait on the device for an error
    # check
    return se3.mm_fma(se3.mm_fma(K, se3.euler_zyx(angles)), torch.linalg.inv_ex(K).inverse)


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


def warp_bilinear(img: torch.Tensor, Hs: torch.Tensor) -> torch.Tensor:
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
    return torch.where(inb, val, 0.0)


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


def warp_two_pass(img: torch.Tensor, Hs: torch.Tensor, bound: tuple[int, int]) -> torch.Tensor:
    """Separable homography warp of a [H, W] image by each of Hs [R, 3, 3]:
    [R, H, W]. `bound` bounds |source - dest| (vertical, horizontal)."""
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
    mv, mh = bound
    img_r = img.to(torch.float32).expand(R, h, w)
    tmp, ok_v = _shift_resample(img_r, v_corr, axis=1, k_min=-mv, k_max=mv)
    out, ok_u = _shift_resample(tmp, u, axis=2, k_min=-mh, k_max=mh)
    return torch.where(inb & ok_v & ok_u, out, 0.0)


def shift_bounds_for_angles(
    K: np.ndarray, angles: np.ndarray, height: int, width: int
) -> tuple[int, int]:
    """Static (vertical, horizontal) pixel-shift bounds for a rotation grid.

    Rotation about x moves pixels vertically (~fy*ax), about y horizontally
    (~fx*ay), about z tangentially (~az * corner radius per axis); small
    projective terms are covered by the margin.
    """
    a = np.abs(angles)
    ax, ay, az = a[:, 0].max(initial=0), a[:, 1].max(initial=0), a[:, 2].max(initial=0)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    half_w = max(cx, width - cx)
    half_h = max(cy, height - cy)
    vert = fy * ax * 1.2 + az * half_w + 3.0
    horiz = fx * ay * 1.2 + az * half_h + 3.0
    return int(np.ceil(vert)), int(np.ceil(horiz))


class WarpPlan(NamedTuple):
    """How a rotation grid warps a frame of one size."""

    homographies: torch.Tensor  # [R, 3, 3] float32 on the frame's device
    bound: tuple[int, int]  # (vertical, horizontal) static shift bound


def warp_plan(K, angles, height: int, width: int, device: str | torch.device) -> WarpPlan:
    """The plan of the rotation grid `angles` [R, 3] for a `height` x `width`
    frame. K and the angles are host float32 (numpy or CPU tensors): the bound
    picks the warp on the host, and a device tensor would wait to be read."""
    K, angles = np.asarray(K, np.float32), np.asarray(angles, np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return WarpPlan(homographies_from_angles(torch.as_tensor(K, **f32),
                                             torch.as_tensor(angles, **f32)),
                    shift_bounds_for_angles(K, angles, height, width))


@labelled("warp_homographies")
def warp_homographies(img: torch.Tensor, plan: WarpPlan) -> torch.Tensor:
    """Warp `img` [H, W] by the plan's homographies: [R, H, W] float32.
    The reference's rule: the two-pass warp when the plan's bound is at most
    MAX_TWO_PASS_SHIFT, else the exact bilinear warp."""
    if max(plan.bound) <= MAX_TWO_PASS_SHIFT:
        return warp_two_pass(img, plan.homographies, plan.bound)
    return warp_bilinear(img, plan.homographies)


@labelled("warp_rotation_grid")
def warp_rotation_grid(img: torch.Tensor, K, angles) -> torch.Tensor:
    """Warp `img` [H, W] by every rotation hypothesis `angles` [R, 3] (host
    float32, as `K`): [R, H, W] float32. The plan is built on each call; a
    caller that warps many frames by one grid keeps its `warp_plan`."""
    return warp_homographies(img, warp_plan(K, angles, *img.shape, img.device))
