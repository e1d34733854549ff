"""Normalized-mutual-information scoring of (synthetic render x warped camera) pairs.

Port of `orbslam2_nmi_tpu/ops/histogram_nmi.py`. The reference's CUDA NMI
pipeline (Thirdparty/CUDA_Functions/NMI.cu: histogram256all :52-104,
ComputeEntropyKernel :230-267) scores one pair per launch; here all S*R pairs
of a pose grid are scored by two kernels:

  * `joint_entropy_grid` (kernel B1, csrc/histogram_nmi.cu): the 256x256
    joint histogram and its entropy Hab for every (render s, warp r) pair.
  * `marginal_entropy_sets` (kernel B2): the 256-bin entropy of each render
    and each warp, both sets in one launch (`marginal_entropy_grid` for one).

Both take gray levels packed to uint8 (256 bins) with no padding, and
normalize by the full pixel count. Each wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version for CPU tensors only.

Score metrics (reference kernel.cuh:22-23, NMI.cu:344-359):
    SUC  = 2 * (1 - Hab / (Ha + Hb))     <- enabled in the reference
    ENMI = (Ha + Hb) / Hab

Background masking (`nmi_prop_BG=false`, reference NMI.cu:85): pixel pairs
where EITHER image is 0 are excluded from the joint AND both marginal
histograms, while probabilities stay normalized by the full pixel count. The
masked marginals are the row and column sums of the masked joint histogram,
so the joint kernel returns all three entropies in that mode.
"""

from __future__ import annotations

import math

import torch

from orbslam2_nmi_torch import kernels

N_BINS = 256
JOINT_MAX_PIXELS = 2**25  # kernel B1's limit (csrc/histogram_nmi.cu, kSpillSlots * kSpill)
MARGINAL_MAX_IMAGES = 65535  # kernel B2's limit: one image a row of its grid (gridDim.y)
_LOG2E = 1.4426950408889634


def quantize_to_bins(img: torch.Tensor) -> torch.Tensor:
    """float [0,255] image -> int32 bin indices (uint8 semantics like NMI.cu)."""
    return torch.clamp(img, 0, N_BINS - 1).to(torch.int32)


def _entropy_of_counts(hist: torch.Tensor, n_valid: int) -> torch.Tensor:
    """-sum p*log2(p) over the last dim, p = hist / n_valid (oracle form)."""
    p = hist / float(n_valid)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return -torch.sum(torch.where(p > 0, p * torch.log2(safe), torch.zeros_like(p)), dim=-1)


def marginal_entropy(bins_flat: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Shannon entropy (log2) of one image's histogram. bins_flat: [P] int32
    (pads marked -1 drop out)."""
    w = (bins_flat >= 0).to(torch.float32)
    hist = torch.zeros(N_BINS, dtype=torch.float32, device=bins_flat.device)
    hist.index_add_(0, torch.clamp(bins_flat, 0, N_BINS - 1).long(), w)
    return _entropy_of_counts(hist, n_valid)


def _joint_index(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a, 0, N_BINS - 1).long() * N_BINS + torch.clamp(b, 0, N_BINS - 1).long()


def joint_entropy_reference(a: torch.Tensor, b: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Joint entropy of two [P] int32 bin arrays (padding marked as -1)."""
    idx = _joint_index(a, b)
    w = ((a >= 0) & (b >= 0)).to(torch.float32)
    hist = torch.zeros(N_BINS * N_BINS, dtype=torch.float32, device=a.device)
    hist.index_add_(0, idx, w)
    return _entropy_of_counts(hist, n_valid)


def masked_entropies_reference(a: torch.Tensor, b: torch.Tensor, n_valid: int):
    """(Hab, Ha, Hb) of one pair with zero-pixel pairs excluded (NMI.cu:85
    `nmi_prop_BG=false` path), normalized by the full n_valid. Oracle."""
    idx = _joint_index(a, b)
    w = ((a > 0) & (b > 0)).to(torch.float32)
    J = torch.zeros(N_BINS * N_BINS, dtype=torch.float32, device=a.device)
    J.index_add_(0, idx, w)
    J = J.reshape(N_BINS, N_BINS)
    return (_entropy_of_counts(J.reshape(-1), n_valid),
            _entropy_of_counts(J.sum(1), n_valid),
            _entropy_of_counts(J.sum(0), n_valid))


def _combine(Ha, Hb, Hab, metric):
    s = Ha[:, None] + Hb[None, :]
    if metric == "SUC":
        return 2.0 * (1.0 - Hab / torch.clamp(s, min=1e-12))
    elif metric == "ENMI":
        return s / torch.clamp(Hab, min=1e-12)
    raise ValueError(f"unknown NMI metric {metric!r}")


def _combine_pairwise(Ha, Hb, Hab, metric):
    """Same score formulas, but Ha/Hb are per-PAIR [S, R] (masked path)."""
    s = Ha + Hb
    if metric == "SUC":
        return 2.0 * (1.0 - Hab / torch.clamp(s, min=1e-12))
    elif metric == "ENMI":
        return s / torch.clamp(Hab, min=1e-12)
    raise ValueError(f"unknown NMI metric {metric!r}")


# ---------------------------------------------------------------------------
# Kernels B1 and B2 with their plain versions
# ---------------------------------------------------------------------------


def _inv_n(n_valid: int) -> float:
    # the kernels multiply each count by this f32 factor (as the Pallas kernels did)
    return 1.0 / float(n_valid)


def _neg_sum_plogp(counts: torch.Tensor, n_valid: int) -> torch.Tensor:
    """-sum over the last dim of p*log2(p), p = count * (1/n) in f32, each term
    rounded in f32 and the sum taken in f64 (the kernels' arithmetic)."""
    p = counts.to(torch.float32) * _inv_n(n_valid)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    term = torch.where(p > 0, p * (torch.log(safe) * _LOG2E), torch.zeros_like(p))
    return (-term.to(torch.float64).sum(-1)).to(torch.float32)


def joint_entropy_grid_plain(synth_bins: torch.Tensor, warp_bins: torch.Tensor,
                             n_valid: int, mask_zero: bool = False) -> torch.Tensor:
    """Plain version of kernel B1: [S, R] Hab, or [3, S, R] (Hab, Ha, Hb) with
    `mask_zero`. synth_bins [S, P], warp_bins [R, P] uint8."""
    S, R = synth_bins.shape[0], warp_bins.shape[0]
    b = warp_bins.long()
    rows_off = (torch.arange(R, device=b.device) * N_BINS * N_BINS)[:, None]
    out = []
    for s in range(S):  # one [R, 256, 256] histogram set per render
        a = synth_bins[s].long()[None, :]
        idx = rows_off + a * N_BINS + b
        if mask_zero:
            idx = idx[(a != 0) & (b != 0)]
        J = torch.bincount(idx.reshape(-1), minlength=R * N_BINS * N_BINS)
        J = J.reshape(R, N_BINS, N_BINS)
        hab = _neg_sum_plogp(J.reshape(R, -1), n_valid)
        if mask_zero:
            out.append(torch.stack([hab, _neg_sum_plogp(J.sum(2), n_valid),
                                    _neg_sum_plogp(J.sum(1), n_valid)]))
        else:
            out.append(hab)
    return torch.stack(out, dim=-2)


def marginal_entropy_grid_plain(bins: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain version of kernel B2 on one set: [N] entropies of [N, P] uint8 bins."""
    N = bins.shape[0]
    off = (torch.arange(N, device=bins.device) * N_BINS)[:, None]
    hist = torch.bincount((bins.long() + off).reshape(-1), minlength=N * N_BINS)
    return _neg_sum_plogp(hist.reshape(N, N_BINS), n_valid)


def marginal_entropy_sets_plain(synth_bins: torch.Tensor, warp_bins: torch.Tensor,
                                n_valid: int) -> torch.Tensor:
    """Plain version of kernel B2 on two sets: [S+R] entropies of synth_bins
    [S, P], then warp_bins [R, P]."""
    return torch.cat([marginal_entropy_grid_plain(synth_bins, n_valid),
                      marginal_entropy_grid_plain(warp_bins, n_valid)])


def _check_bins(*bins: torch.Tensor) -> None:
    P = bins[0].shape[-1]
    for t in bins:
        if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] != P or P == 0:
            raise ValueError(f"bins must be non-empty [N, P] with one P, got {tuple(t.shape)}")
    if P >= 2**31:
        raise ValueError("pixel count must stay below 2**31 (int32 histogram counts)")


def joint_entropy_grid(synth_bins: torch.Tensor, warp_bins: torch.Tensor, n_valid: int,
                       mask_zero: bool = False) -> torch.Tensor:
    """All-pairs joint entropies [S, R] (or [3, S, R] with `mask_zero`) of
    uint8 bins [S, P] x [R, P]: kernel B1 on CUDA, the plain version on CPU."""
    _check_bins(synth_bins, warp_bins)
    if synth_bins.device.type == "cpu":
        return joint_entropy_grid_plain(synth_bins, warp_bins, n_valid, mask_zero)
    dev = kernels.require_cuda(synth_bins, warp_bins, dtypes=(torch.uint8, torch.uint8))
    S, P = synth_bins.shape
    if P >= JOINT_MAX_PIXELS:
        raise ValueError(f"kernel B1 takes fewer than {JOINT_MAX_PIXELS} pixels an image "
                         f"(its spill table holds P / 2**14 bins), got {P}")
    R = warp_bins.shape[0]
    out = torch.empty((3, S, R) if mask_zero else (S, R), dtype=torch.float32, device=dev)
    kernels.launch(
        "joint_entropy", dev, synth_bins.data_ptr(), warp_bins.data_ptr(), S, R, P,
        _inv_n(n_valid), int(mask_zero), out.data_ptr(),
    )
    return out


def _launch_marginal(a: torch.Tensor, b: torch.Tensor | None, n_valid: int) -> torch.Tensor:
    """Kernel B2 over a's rows, then b's (none when b is None), in one launch."""
    bins = (a,) if b is None else (a, b)
    dev = kernels.require_cuda(*bins, dtypes=(torch.uint8,) * len(bins))
    S, P = a.shape
    R = 0 if b is None else b.shape[0]
    if S + R > MARGINAL_MAX_IMAGES:
        raise ValueError(f"kernel B2 takes at most {MARGINAL_MAX_IMAGES} images a launch "
                         f"(its grid's y dimension), got {S + R}")
    out = torch.empty(S + R, dtype=torch.float32, device=dev)
    kernels.launch("marginal_entropy", dev, a.data_ptr(), S, 0 if b is None else b.data_ptr(),
                   R, P, _inv_n(n_valid), out.data_ptr())
    return out


def marginal_entropy_grid(bins: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Per-image entropies [N] of uint8 bins [N, P]: kernel B2 on CUDA, the
    plain version on CPU."""
    _check_bins(bins)
    if bins.device.type == "cpu":
        return marginal_entropy_grid_plain(bins, n_valid)
    return _launch_marginal(bins, None, n_valid)


def marginal_entropy_sets(synth_bins: torch.Tensor, warp_bins: torch.Tensor,
                          n_valid: int) -> torch.Tensor:
    """Entropies [S+R] of uint8 bins synth_bins [S, P], then warp_bins [R, P]:
    kernel B2 in one launch on CUDA, the plain version on CPU."""
    _check_bins(synth_bins, warp_bins)
    if synth_bins.device.type == "cpu":
        return marginal_entropy_sets_plain(synth_bins, warp_bins, n_valid)
    return _launch_marginal(synth_bins, warp_bins, n_valid)


def pack_bins(img: torch.Tensor) -> torch.Tensor:
    """[N, ...] images in [0, 255] -> [N, P] uint8 bins (quantize_to_bins'
    clamp-and-truncate, packed to one byte per pixel)."""
    flat = img.reshape(img.shape[0], -1)
    if flat.dtype == torch.uint8:
        return flat.contiguous()
    return torch.clamp(flat, 0, N_BINS - 1).to(torch.uint8)


def nmi_scores(
    synth: torch.Tensor,  # [S, H, W] float or uint8 images in [0, 255]
    warped: torch.Tensor,  # [R, H, W]
    metric: str = "SUC",
    use_background: bool = True,
) -> torch.Tensor:
    """Score every (render, warp) pair: [S, R] float32, over N_BINS = 256
    gray bins (the reference's uint8 histograms).

    `use_background=False` is the reference's `nmi_prop_BG=false` compile
    option (NMI.cu:85): pairs where either image is 0 are excluded from all
    histograms (normalization stays at the full pixel count).
    """
    P = math.prod(synth.shape[1:])
    sb = pack_bins(synth)
    wb = pack_bins(warped)
    if not use_background:
        Hab, Ha, Hb = joint_entropy_grid(sb, wb, P, mask_zero=True)
        return _combine_pairwise(Ha, Hb, Hab, metric)
    Ha, Hb = marginal_entropy_sets(sb, wb, P).split([sb.shape[0], wb.shape[0]])
    Hab = joint_entropy_grid(sb, wb, P)
    return _combine(Ha, Hb, Hab, metric)
