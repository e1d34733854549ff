"""Plain reference: FAST-9/16 corners (a frozen copy of the program's `ops/fast.py`).

The dense replacement for the
per-cell cv::FAST calls of ORBextractor::ComputeKeyPointsOctTree (reference:
src/ORBextractor.cc:770). The whole level is one pass of tensor ops:

  * the 16 Bresenham-circle neighbours are materialized by `torch.roll`,
  * the bright and dark tests pack into a 16-bit mask a pixel,
  * the ">= 9 contiguous" test is `(m | m << 16) >> i & 0x1FF == 0x1FF` over
    the 16 rotations; only bits 0-23 of the doubled mask are ever read, so it
    is built as `m | (m & 0xFF) << 16` and never reaches int32's sign bit,
  * 3x3 non-max suppression on the score.

The per-cell dual-threshold fallback (iniThFAST=20 -> minThFAST=7 when a
cell is empty, ORBextractor.cc:770-820) is reproduced with cell masks.

Every op here is exact or rounds as the reference does: the score is a
sequential sum of the 16 arc terms (as XLA's CPU reduction adds them), so
masks, scores and NMS equal the JAX package's on the same image, and are the
same on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock, as (drow, dcol):
# the geometry of cv::FAST's offset table.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LENGTH = 9  # FAST-9
_ARC_MASK = (1 << ARC_LENGTH) - 1  # 0x1FF


def _interior(h: int, w: int, margin: int, device) -> torch.Tensor:
    ri = torch.arange(h, device=device)[:, None]
    ci = torch.arange(w, device=device)[None, :]
    return (ri >= margin) & (ri < h - margin) & (ci >= margin) & (ci < w - margin)


def fast_response(img: torch.Tensor, threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense FAST-9 on a [H, W] float image.

    Returns (is_corner [H, W] bool, score [H, W] float32). The score is the
    sum of absolute threshold-exceeding differences on the dominant arc
    polarity: monotone in corner strength, used only for NMS and ranking.
    """
    mb = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    md = torch.zeros_like(mb)
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    for bit, (dr, dc) in enumerate(CIRCLE_OFFSETS.tolist()):
        # roll wraparound is masked out by the border crop below
        diff = torch.roll(img, (-dr, -dc), dims=(0, 1)) - img
        bright = diff > threshold
        dark = diff < -threshold
        mb = mb | (bright.to(torch.int32) << bit)
        md = md | (dark.to(torch.int32) << bit)
        score_b = score_b + torch.where(bright, diff - threshold, 0.0)
        score_d = score_d + torch.where(dark, -diff - threshold, 0.0)

    def has_arc(m):
        ext = m | ((m & 0xFF) << 16)
        hit = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
        for i in range(16):
            hit = hit | (((ext >> i) & _ARC_MASK) == _ARC_MASK)
        return hit

    corner = has_arc(mb) | has_arc(md)
    score = torch.maximum(score_b, score_d)
    # kill the roll wraparound ring (3 px); callers also crop the ORB edge
    interior = _interior(*img.shape, 3, img.device)
    return corner & interior, torch.where(interior, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """True where the score is the max of its 3x3 neighbourhood (ties kept,
    so plateau corners are not dropped entirely); the border pads with -inf."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= neigh


def _cell_any_pool(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-cell OR, broadcast back to pixel resolution. Pads to a cell multiple."""
    h, w = mask.shape
    ph, pw = (-h) % cell, (-w) % cell
    m = F.pad(mask, (0, pw, 0, ph))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    cells = m.reshape(hc, cell, wc, cell).any(dim=3).any(dim=1)
    back = cells[:, None, :, None].expand(hc, cell, wc, cell).reshape(hc * cell, wc * cell)
    return back[:h, :w]


def detect_with_fallback(
    img: torch.Tensor,
    ini_threshold: float,
    min_threshold: float,
    cell: int = 30,
    border: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FAST with the reference's per-cell threshold fallback.

    Cells that fired at ini_threshold keep only those corners; cells that
    did not contribute their min_threshold corners (ORBextractor.cc:770-820).
    `border` crops the ORB edge region (EDGE_THRESHOLD-3 = 16 in the
    reference). Returns (corner mask after NMS, score).
    """
    corner_hi, score_hi = fast_response(img, ini_threshold)
    corner_lo, score_lo = fast_response(img, min_threshold)
    cell_has_hi = _cell_any_pool(corner_hi, cell)
    corner = torch.where(cell_has_hi, corner_hi, corner_lo)
    score = torch.where(cell_has_hi, score_hi, score_lo)
    corner = corner & _interior(*img.shape, border, img.device)
    score = torch.where(corner, score, 0.0)
    keep = nms3x3(score) & corner
    return keep, torch.where(keep, score, 0.0)
