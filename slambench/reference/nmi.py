"""Plain reference of the NMI scores of every (render, warp) pair.

The gray levels are truncated to one byte (256 bins), each pair's 256x256
joint histogram is counted with `torch.bincount`, and the entropies are
-sum p log2 p with p = count * (1 / P) in float32, each term rounded in
float32 and summed in float64 (the arithmetic of the program's plain
versions of kernels B1 and B2, `orbslam2_nmi_torch/ops/histogram_nmi.py`).
The score is SUC = 2 (1 - Hab / (Ha + Hb)), the reference system's enabled
metric (NMI.cu:344-359), with the background counted (nmi_prop_BG).
"""

from __future__ import annotations

import torch

N_BINS = 256
_LOG2E = 1.4426950408889634


def pack_bins(img: torch.Tensor) -> torch.Tensor:
    flat = img.reshape(img.shape[0], -1)
    if flat.dtype == torch.uint8:
        return flat.contiguous()
    return torch.clamp(flat, 0, N_BINS - 1).to(torch.uint8)


def _neg_sum_plogp(counts: torch.Tensor, n: int) -> torch.Tensor:
    p = counts.to(torch.float32) * (1.0 / float(n))
    safe = torch.where(p > 0, p, torch.ones_like(p))
    term = torch.where(p > 0, p * (torch.log(safe) * _LOG2E), torch.zeros_like(p))
    return (-term.to(torch.float64).sum(-1)).to(torch.float32)


def marginal_entropies(bins: torch.Tensor, n: int) -> torch.Tensor:
    N = bins.shape[0]
    off = (torch.arange(N, device=bins.device) * N_BINS)[:, None]
    hist = torch.bincount((bins.long() + off).reshape(-1), minlength=N * N_BINS)
    return _neg_sum_plogp(hist.reshape(N, N_BINS), n)


def joint_entropies(sb: torch.Tensor, wb: torch.Tensor, n: int) -> torch.Tensor:
    """[S, R] Hab, one [R, 256, 256] histogram set a render."""
    R = wb.shape[0]
    b = wb.long()
    rows_off = (torch.arange(R, device=b.device) * N_BINS * N_BINS)[:, None]
    out = []
    for s in range(sb.shape[0]):
        idx = rows_off + sb[s].long()[None, :] * N_BINS + b
        J = torch.bincount(idx.reshape(-1), minlength=R * N_BINS * N_BINS)
        out.append(_neg_sum_plogp(J.reshape(R, -1), n))
    return torch.stack(out)


def nmi_scores(synth: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    """[S, R] float32 SUC scores of renders [S, H, W] x warps [R, H, W]."""
    n = synth[0].numel()
    sb, wb = pack_bins(synth), pack_bins(warped)
    Ha = marginal_entropies(sb, n)
    Hb = marginal_entropies(wb, n)
    Hab = joint_entropies(sb, wb, n)
    s = Ha[:, None] + Hb[None, :]
    return 2.0 * (1.0 - Hab / torch.clamp(s, min=1e-12))
