"""Image pyramid and separable Gaussian blur.

Port of `orbslam2_nmi_tpu/ops/pyramid.py`: the reference's
ORBextractor::ComputePyramid (src/ORBextractor.cc:1114, cv::resize bilinear,
8 levels, scale 1.2) and the GaussianBlur(7x7, sigma=2) before the
descriptors (src/ORBextractor.cc:1092). Level sizes are Python ints derived
from the configuration, so every frame has the same shapes.

Precision. The JAX package blurs with `Precision.DEFAULT` (bf16 on a TPU,
f32 on the CPU). On CUDA a float32 `conv2d` goes through cuDNN in TF32 by
default (`torch.backends.cudnn.allow_tf32`), and `t0 < t1` on the blurred
image decides every descriptor bit. So the blur here is seven shifted
multiply-adds a pass in a fixed order, in float32 on every device and
independent of any global flag; the resize is gathers and elementwise ops. A
pyramid and its blurs are therefore the same on the CPU and on the card, bit
for bit; against XLA's convolution they differ in the last bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def level_sizes(height: int, width: int, n_levels: int, scale_factor: float):
    """Per-level (h, w) using the reference's round(size / scale^l) convention
    (Python's `round`, half to even)."""
    sizes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor**lvl)
        sizes.append((int(round(height * inv)), int(round(width * inv))))
    return sizes


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a [H, W] float32 image, matching cv::resize's
    pixel-center alignment (src = (dst + 0.5) * scale - 0.5)."""
    h, w = img.shape
    f32 = dict(dtype=torch.float32, device=img.device)
    ys = (torch.arange(out_h, **f32) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, **f32) + 0.5) * (w / out_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    r0, r1 = img[y0i], img[y1i]
    top = r0[:, x0i] * (1 - wx)[None, :] + r0[:, x1i] * wx[None, :]
    bot = r1[:, x0i] * (1 - wx)[None, :] + r1[:, x1i] * wx[None, :]
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list[torch.Tensor]:
    """[H, W] image -> list of n_levels float32 images, level 0 == input.

    Like the reference, each level is resized from the previous one
    (cumulative bilinear), not from level 0.
    """
    h, w = img.shape
    sizes = level_sizes(h, w, n_levels, scale_factor)
    levels = [img.to(torch.float32)]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *sizes[lvl]))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian with the REFLECT_101 border (OpenCV's default) of a
    [H, W] float32 image: horizontal pass, then vertical, each tap added in
    order."""
    k = [float(v) for v in _gaussian_kernel1d(ksize, sigma)]
    r = ksize // 2
    h, w = img.shape
    # torch's "reflect" does not repeat the edge pixel: REFLECT_101
    p = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    acc = p[:, 0:w] * k[0]
    for i in range(1, ksize):
        acc = acc + p[:, i : i + w] * k[i]
    out = acc[0:h] * k[0]
    for i in range(1, ksize):
        out = out + acc[i : i + h] * k[i]
    return out
