"""Batched ORB descriptor matching.

Port of `orbslam2_nmi_tpu/ops/matching.py`, the replacement for ORBmatcher
(reference: src/ORBmatcher.cc). The reference speeds up CPU matching with a
64x48 grid index and BoW vectors; here the primitive is the dense [Q, N]
candidate matrix: Hamming distances, spatial windows as masks, argmin
reductions. Thresholds are the reference's: TH_LOW=50, TH_HIGH=100
(ORBmatcher.cc:42-44), the best/second-best ratio, and the 30-bin rotation
histogram with its top-3 peaks (ORBmatcher.cc ComputeThreeMaxima).

Where the port differs, or is likely to trip:

1. No popcount in torch. Descriptors are [..., 8] int32 words (the bit
   patterns of the JAX package's uint32 words). `hamming_matrix` unpacks
   them to +-1 and takes one float32 product: a.b = 256 - 2 d. Every product
   and partial sum is a small integer, exact in float32, and the +-1 inputs
   are exact in TF32 and bf16 too, so the distances are exact integers equal
   to the JAX package's on every device, whatever the matmul precision flags.
2. Ties in argmin. Distances are small integers, so ties are common.
   `jnp.argmin` takes the first minimum, and so does `torch.argmin` (its
   documented contract, on the CPU and on CUDA); the tests hold it on
   tie-heavy inputs.
3. `vmap` becomes a leading batch axis: `match_descriptors`, `window_mask`
   and `hamming_matrix` take [..., A, 8] / [..., B, 8]; the rotation check
   takes one pair of sets.
4. Nothing here waits on the device: no boolean indexing, no `.item()`; the
   rotation histogram is an `index_add_` of int32 ones (exact in any order).
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HIST_LENGTH = 30

_BIG = 10_000
_DESC_BITS = 256


def _signs(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] float32 +-1 (bit k of word w at
    32 w + k; an arithmetic shift keeps bit k in place)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return (1 - 2 * bits).to(torch.float32).reshape(*desc.shape[:-1], _DESC_BITS)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[..., A, 8] x [..., B, 8] int32 words -> [..., A, B] int32 Hamming
    distances, exact (see the module docstring)."""
    dot = torch.matmul(_signs(desc_a), _signs(desc_b).transpose(-1, -2))
    return ((_DESC_BITS - dot) * 0.5).to(torch.int32)


def rotation_consistency_mask(
    angle_a: torch.Tensor, angle_b: torch.Tensor, match_idx: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ORBmatcher.cc:1458 ComputeThreeMaxima semantics).

    angle_a: [A] query angles (radians); angle_b: [B] train angles;
    match_idx: [A] index into B (or -1); valid: [A] bool.
    """
    two_pi = 2.0 * math.pi
    rot = angle_a - angle_b[torch.clamp(match_idx, 0, angle_b.shape[0] - 1)]
    rot = torch.remainder(rot, two_pi)  # [0, 2pi)
    bins = torch.clamp((rot * (HIST_LENGTH / two_pi)).to(torch.int32), 0, HIST_LENGTH - 1)
    counts = torch.zeros(HIST_LENGTH, dtype=torch.int32, device=valid.device)
    counts.index_add_(0, bins, valid.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    # the reference drops peaks weaker than 0.1x the max
    not_first = torch.arange(3, device=valid.device) > 0
    thresh = torch.clamp(top3 * not_first, min=(0.1 * top3[0]).to(torch.int32))
    keep_bin = torch.zeros(HIST_LENGTH, dtype=torch.bool, device=valid.device)
    for k in range(3):
        keep_bin = keep_bin | ((counts == top3[k]) & (top3[k] >= thresh[k]) & (top3[k] > 0))
    return valid & keep_bin[bins.long()]


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    *,
    spatial_mask: torch.Tensor | None = None,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.9,
    angle_a: torch.Tensor | None = None,
    angle_b: torch.Tensor | None = None,
    apply_ratio: bool = True,
    check_rotation: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-match search A->B with optional window mask / ratio / rotation
    checks, over any leading batch axes.

    Returns (match_idx [..., A] int32 into B or -1, dist [..., A] int32).
    Enforces one-to-one matching by keeping, for each B, only the
    lowest-distance A (mutual best of the masked candidate matrix).
    """
    d = hamming_matrix(desc_a, desc_b)
    mask = valid_a[..., :, None] & valid_b[..., None, :]
    if spatial_mask is not None:
        mask = mask & spatial_mask
    d = torch.where(mask, d, _BIG)
    n_a, n_b = d.shape[-2], d.shape[-1]

    best = torch.argmin(d, dim=-1)  # [..., A] int64, first minimum
    best_d = torch.gather(d, -1, best[..., None])[..., 0]
    ok = best_d <= max_dist

    if apply_ratio:
        cols = torch.arange(n_b, device=d.device)
        second_d = torch.where(cols == best[..., None], _BIG, d).amin(dim=-1)
        ok = ok & (best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32))

    # one-to-one: for each B keep the best A
    inv_best = torch.argmin(torch.where(ok[..., :, None], d, _BIG), dim=-2)  # [..., B]
    mutual = torch.gather(inv_best, -1, best) == torch.arange(n_a, device=d.device)
    ok = ok & mutual

    if check_rotation and angle_a is not None and angle_b is not None:
        ok = rotation_consistency_mask(angle_a, angle_b, best, ok)

    return torch.where(ok, best, -1).to(torch.int32), torch.where(ok, best_d, _BIG)


def window_mask(
    xy_a: torch.Tensor,
    xy_b: torch.Tensor,
    radius,
    octave_a: torch.Tensor | None = None,
    octave_b: torch.Tensor | None = None,
    level_window: int = 1,
) -> torch.Tensor:
    """[..., A, B] mask: B features within `radius` (a float or a per-A
    [..., A] tensor) of each A position, optionally within +-level_window
    octaves. Mirrors the grid lookups of Frame::GetFeaturesInArea
    (src/Frame.cc) without the grid."""
    diff = xy_a[..., :, None, :] - xy_b[..., None, :, :]
    r = radius[..., :, None] if isinstance(radius, torch.Tensor) and radius.dim() > 0 else radius
    m = (torch.abs(diff[..., 0]) < r) & (torch.abs(diff[..., 1]) < r)
    if octave_a is not None and octave_b is not None:
        dl = octave_b[..., None, :] - octave_a[..., :, None]
        m = m & (dl >= -level_window) & (dl <= level_window)
    return m


def match_epipolar(
    desc1: torch.Tensor,
    free1: torch.Tensor,
    desc2: torch.Tensor,
    free2: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    F12: torch.Tensor,
    sigma2_2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SearchForTriangulation's epipolar-constrained match (ORBmatcher.cc:690),
    over any leading batch axes: the [..., F1, F2] epipolar-distance mask
    (the line of x1 in image 2 is F12^T x1; gate at 3.84 sigma^2 like the
    reference) feeds the Hamming matcher. The line is a plain float32
    product of sums, never TF32."""
    # lines2[..., i, :] = [x1, y1, 1] @ F12, added in order
    lines2 = (xy1[..., :, 0:1] * F12[..., None, 0, :] + xy1[..., :, 1:2] * F12[..., None, 1, :]
              + F12[..., None, 2, :])
    a, b, c = lines2[..., 0:1], lines2[..., 1:2], lines2[..., 2:3]
    d = torch.abs(a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c) / torch.sqrt(
        torch.clamp(a * a + b * b, min=1e-12))
    epi_ok = (d * d) < 3.84 * sigma2_2[..., None, :]
    return match_descriptors(desc1, free1, desc2, free2, spatial_mask=epi_ok,
                             max_dist=TH_LOW, apply_ratio=False)


def match_epipolar_batch(
    desc1: torch.Tensor,  # [F1, 8] the new keyframe's descriptors (shared)
    free1: torch.Tensor,  # [N, F1] per-pair free mask (bindings change as pairs land)
    xy1: torch.Tensor,  # [F1, 2]
    desc2_b: torch.Tensor,  # [N, F2, 8] neighbour descriptors
    free2_b: torch.Tensor,  # [N, F2]
    xy2_b: torch.Tensor,  # [N, F2, 2]
    F12_b: torch.Tensor,  # [N, 3, 3]
    sigma2_2_b: torch.Tensor,  # [N, F2]
) -> torch.Tensor:
    """All of CreateNewMapPoints' epipolar matches in one batched call (the
    reference walks up to 20 covisible neighbours calling
    SearchForTriangulation per pair, LocalMapping.cc:210-224). Returns match
    idx [N, F1] into F2."""
    n = free1.shape[0]
    return match_epipolar(desc1.expand(n, *desc1.shape), free1, desc2_b, free2_b,
                          xy1.expand(n, *xy1.shape), xy2_b, F12_b, sigma2_2_b)[0]


def fuse_match_batch(
    desc_src: torch.Tensor,  # [P, NB, 8] source map-point descriptors (padded)
    valid_src: torch.Tensor,  # [P, NB]
    proj: torch.Tensor,  # [P, NB, 2] projections into the destination KF
    desc_dst: torch.Tensor,  # [P, F, 8] destination KF feature descriptors
    valid_dst: torch.Tensor,  # [P, F]
    xy_dst: torch.Tensor,  # [P, F, 2]
    radius: float = 3.0,
) -> torch.Tensor:
    """All of SearchInNeighbors' fuse matches (both directions, all
    neighbour pairs) in one batched call: a window mask and a Hamming match
    per pair (ORBmatcher::Fuse, ORBmatcher.cc:858). Returns [P, NB] match idx
    into the destination features (or -1)."""
    sm = window_mask(proj, xy_dst, radius)
    idx, _ = match_descriptors(desc_src, valid_src, desc_dst, valid_dst, spatial_mask=sm,
                               max_dist=TH_LOW, apply_ratio=False)
    return idx
