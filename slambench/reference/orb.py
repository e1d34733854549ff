"""Plain reference of the tracking step's first stage, ORB extraction.

A frozen copy of the program's `orbslam2_nmi_torch/ops/orb.py` (with
`ops/fast.py` and `ops/pyramid.py` beside it): the 8-level pyramid, FAST-9
with the per-cell threshold fallback, the spatial top-k, the intensity
centroid orientation and the rotated BRIEF descriptors, in plain PyTorch.
The 256-pair pattern is the stock ORB table (ORBextractor.cc:155-410), kept
here as `orb_pattern.npy`. `precision="bfloat16"` rounds every pyramid level
and its blur to bfloat16: the control.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from slambench.reference import fast as fast_ops
from slambench.reference import pyramid as pyr

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")

HALF_PATCH_SIZE = 15
# preferred-winner bonus of the top-k key, added in float32 (see hazard 1)
_BONUS = 1e9


class Features(NamedTuple):
    """Fixed-capacity feature set for one image (level-0 coordinates)."""

    xy: torch.Tensor  # [N, 2] float32 (x, y) in level-0 pixels
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor  # [N] float32 radians
    octave: torch.Tensor  # [N] int32 pyramid level
    size: torch.Tensor  # [N] float32 patch size at level scale
    desc: torch.Tensor  # [N, 8] int32 bit patterns of the packed 256-bit rBRIEF
    valid: torch.Tensor  # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


@functools.lru_cache(maxsize=1)
def load_pattern() -> np.ndarray:
    return np.load(_PATTERN_PATH)  # [256, 4] int32: x1, y1, x2, y2


@functools.lru_cache(maxsize=1)
def circle_umax() -> np.ndarray:
    """Max column extent per row of the radius-15 circular patch, with the
    symmetry fix-up (same construction as ORBextractor.cc:443-457)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = hp * hp
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


class _Constants(NamedTuple):
    pattern: torch.Tensor  # [4, 256] f32: x1, y1, x2, y2
    bit_weights: torch.Tensor  # [32] int32: 1 << k, bit 31 as -2^31
    dy: torch.Tensor  # [31, 1] f32 patch rows -15..15
    dy_idx: torch.Tensor  # [31, 1] int64
    umax: torch.Tensor  # [31, 1] int64 half-width of each patch row


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> _Constants:
    """The extractor's constant tensors on `device`, made once: creating them
    inside a step would copy from the host, which waits on the device."""
    pat = torch.from_numpy(load_pattern().astype(np.float32).T.copy())
    w = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    hp = HALF_PATCH_SIZE
    dys = np.arange(-hp, hp + 1)
    umax = circle_umax()[np.abs(dys)]
    return _Constants(
        pattern=pat.to(device),
        bit_weights=torch.from_numpy(w.copy()).to(device),
        dy=torch.from_numpy(dys.astype(np.float32)[:, None]).to(device),
        dy_idx=torch.from_numpy(dys.astype(np.int64)[:, None]).to(device),
        umax=torch.from_numpy(umax.astype(np.int64)[:, None]).to(device),
    )


def _moments_at(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Intensity-centroid moments (m10, m01) of the radius-15 circle around
    pixels (ys, xs) [n] int64, from row prefix sums of the whole image.

    Each circle row is a width-(2u+1) box, so with one x prefix sum C and
    one x-weighted prefix sum W per image:
        rowsum(y+dy, x; u)  = C[y+dy, x+u] - C[y+dy, x-u-1]
        rowxsum(y+dy, x; u) = (W[...] - W[...]) - x * rowsum
        m01 = sum_dy dy * rowsum,   m10 = sum_dy rowxsum
    (the umax circle of ORBextractor.cc IC_Angle)."""
    c = _constants(img.device)
    h, w = img.shape
    pad = HALF_PATCH_SIZE + 1
    ip = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    xs_pad = torch.arange(-pad, w + pad, dtype=torch.float32, device=img.device)[None, :]
    # prefix sums along x with a leading zero column, so a box sum is two loads
    Cz = torch.nn.functional.pad(torch.cumsum(ip, dim=1), (1, 0)).reshape(-1)
    Wz = torch.nn.functional.pad(torch.cumsum(ip * xs_pad, dim=1), (1, 0)).reshape(-1)
    stride = w + 2 * pad + 1
    row = (ys[None, :] + (pad + c.dy_idx)) * stride  # [31, n]
    lo = row + (xs[None, :] + (pad - c.umax))
    hi = row + (xs[None, :] + (pad + c.umax + 1))
    rowsum = Cz[hi] - Cz[lo]
    rowxsum = (Wz[hi] - Wz[lo]) - xs.to(torch.float32)[None, :] * rowsum
    return rowxsum.sum(0), (c.dy * rowsum).sum(0)


def orientation_maps(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (m10, m01) intensity-centroid moment maps of a [H, W] image
    (row prefix sums; see `_moments_at`)."""
    h, w = img.shape
    ys = torch.arange(h, device=img.device).repeat_interleave(w)
    xs = torch.arange(w, device=img.device).repeat(h)
    m10, m01 = _moments_at(img, ys, xs)
    return m10.reshape(h, w), m01.reshape(h, w)


def select_spatial_topk(
    score: torch.Tensor, n_target: int, cell: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick up to n_target corners, preferring each cell's best (quadtree-like
    spatial spread, reference DistributeOctTree ORBextractor.cc:544), then
    filling by response. Returns (ys, xs, scores, valid) of length n_target;
    ties go to the lower flat index, as `jax.lax.top_k` breaks them."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    s = torch.nn.functional.pad(score, (0, pw, 0, ph))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    cell_max = s.reshape(hc, cell, wc, cell).amax(dim=(1, 3))
    cell_max_b = cell_max[:, None, :, None].expand(hc, cell, wc, cell).reshape(
        hc * cell, wc * cell)[:h, :w]
    preferred = (score > 0) & (score >= cell_max_b)
    # preferred winners rank above everything else, then by score
    key = torch.where(score > 0, score + torch.where(preferred, _BONUS, 0.0), -torch.inf)
    topv, topi = torch.sort(key.reshape(-1), descending=True, stable=True)
    topv, topi = topv[:n_target], topi[:n_target]
    ys = torch.div(topi, w, rounding_mode="floor")
    xs = topi - ys * w
    valid = topv > -torch.inf
    scores = torch.where(valid, score.reshape(-1)[topi], 0.0)
    return ys.to(torch.int32), xs.to(torch.int32), scores, valid


def compute_descriptors(
    blurred: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    angles: torch.Tensor,
) -> torch.Tensor:
    """rBRIEF for keypoints on one level. blurred: [H, W] float32.

    Sampling rule identical to computeOrbDescriptor (ORBextractor.cc:113):
      row offset = round(px*sin + py*cos), col offset = round(px*cos - py*sin).
    Returns [N, 8] int32 (the bit patterns of the uint32 words).
    """
    h, w = blurred.shape
    c = _constants(blurred.device)
    px1, py1, px2, py2 = (c.pattern[i][None, :] for i in range(4))
    a = torch.cos(angles)[:, None]  # [N, 1]
    b = torch.sin(angles)[:, None]
    ys = ys.long()[:, None]
    xs = xs.long()[:, None]
    r1 = torch.round(px1 * b + py1 * a).long() + ys
    c1 = torch.round(px1 * a - py1 * b).long() + xs
    r2 = torch.round(px2 * b + py2 * a).long() + ys
    c2 = torch.round(px2 * a - py2 * b).long() + xs
    flat = blurred.reshape(-1)
    t0 = flat[torch.clamp(r1, 0, h - 1) * w + torch.clamp(c1, 0, w - 1)]
    t1 = flat[torch.clamp(r2, 0, h - 1) * w + torch.clamp(c2, 0, w - 1)]
    bits = (t0 < t1).to(torch.int32).reshape(-1, 8, 32)
    # distinct powers of two with bit 31 as -2^31: no partial sum overflows
    return torch.sum(bits * c.bit_weights, dim=-1, dtype=torch.int32)


def _distribution_cell(h: int, w: int, n_target: int) -> int:
    if n_target <= 0:
        return 16
    c = int(round(np.sqrt(h * w / n_target)))
    return int(np.clip(c, 8, 64))


@dataclass(frozen=True)
class ORBParams:
    """The extractor's settings (ORBextractor.cc:1048's budget)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    patch_size: int = 31
    edge_threshold: int = 19
    cell_size: int = 30

    def features_per_level(self) -> np.ndarray:
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1.0 - factor) / (1.0 - factor**self.n_levels)
        per_level, total = [], 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            per_level.append(n)
            total += n
            n_desired *= factor
        per_level.append(max(self.n_features - total, 0))
        return np.array(per_level, dtype=np.int32)


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if precision == "bfloat16" else x


def extract_orb(image_u8: torch.Tensor, cfg: ORBParams, precision: str = "float32") -> Features:
    """Full ORB extraction on a [H, W] uint8 image -> Features of size
    cfg.n_features (fixed), coordinates in level-0 pixels, on the image's
    device (equivalent of ORBextractor::operator(), ORBextractor.cc:1048)."""
    img = image_u8.to(torch.float32)
    levels = [_rounded(x, precision)
              for x in pyr.build_pyramid(img, cfg.n_levels, cfg.scale_factor)]
    budgets = [int(b) for b in cfg.features_per_level()]
    border = cfg.edge_threshold - 3  # the reference crops EDGE_THRESHOLD-3 = 16
    dev = img.device

    outs = []
    for lvl, (level_img, n_l) in enumerate(zip(levels, budgets)):
        if n_l == 0:
            continue
        h, w = level_img.shape
        _, score = fast_ops.detect_with_fallback(
            level_img, cfg.ini_th_fast, cfg.min_th_fast, cell=cfg.cell_size, border=border
        )
        ys, xs, sc, valid = select_spatial_topk(score, n_l, _distribution_cell(h, w, n_l))
        m10, m01 = _moments_at(level_img, ys.long(), xs.long())
        angles = torch.atan2(m01, m10)
        desc = compute_descriptors(_rounded(pyr.gaussian_blur(level_img, 7, 2.0), precision), xs,
                                   ys, angles)
        scale = float(cfg.scale_factor**lvl)
        xy0 = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1) * scale
        outs.append(
            Features(
                xy=xy0,
                response=sc,
                angle=angles,
                octave=torch.full((n_l,), lvl, dtype=torch.int32, device=dev),
                size=torch.full((n_l,), float(cfg.patch_size) * scale, dtype=torch.float32,
                                device=dev),
                desc=desc,
                valid=valid,
            )
        )
    return Features(*[torch.cat([getattr(o, f) for o in outs], dim=0) for f in Features._fields])
