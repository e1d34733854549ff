"""Multi-rank NMI pose-grid search: the translation candidates sharded over
the mesh.

Port of `orbslam2_nmi_tpu/parallel/sharded_nmi.py`. The single-device NMI
path (`ops/histogram_nmi.py`) scores the whole 6-D grid at once; here the
render (translation) axis S is spread over the ranks of the mesh's pose axis.
Each rank:

  1. renders its S/D candidates (the point splat, or kernel B3 and the
     sampler for a mesh); the pads are offset 1e6 m, an empty render;
  2. warps the frame by its R/D rotation hypotheses, by the two-pass or the
     gather warp as the FULL angle set's `homography.warp_plan` decides (so
     sharding never changes which warp runs), and `all_gather`s the warps to
     [R_pad, H, W];
  3. scores its renders against every warp with `nmi_scores` (kernel B2 once,
     then B1 once, on the card);
  4. `all_gather`s the [S/D, R_pad] score blocks, so that every rank returns
     the full [S, R] scores, the pad rows at -inf.

The model (splat points, or the binned mesh and its texture) is replicated:
every rank passes the same one, as in the JAX module. K and the angles come
on the host, so the search reads nothing back from the device.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch.ops import histogram_nmi, homography, raster, render
from orbslam2_nmi_torch.parallel.mesh import POSE_AXIS, Mesh, all_gather_cat


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0, fill=0.0) -> torch.Tensor:
    pad = (-x.shape[axis]) % m
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis)


def _search(mesh: Mesh, render_fn, frame_gray, offsets_cam, angles, K, metric):
    """The shared body: pad, warp and gather, render, score and gather."""
    n_dev, rank = mesh.size(POSE_AXIS), mesh.get_local_rank(POSE_AXIS)
    dev = mesh.device
    frame_gray = torch.as_tensor(frame_gray, dtype=torch.float32, device=dev)
    offsets_cam = torch.as_tensor(offsets_cam, dtype=torch.float32, device=dev)
    S, R = offsets_cam.shape[0], len(angles)
    offsets_p = pad_to_multiple(offsets_cam, n_dev, fill=1e6)  # far away: an empty render
    # identity-rotation pads; the plan of the FULL padded set picks the warp,
    # so sharding never changes which warp runs
    plan = homography.warp_plan(K, pad_to_multiple(torch.as_tensor(angles), n_dev),
                                *frame_gray.shape, dev)
    S_loc, R_loc = offsets_p.shape[0] // n_dev, plan.homographies.shape[0] // n_dev
    # the warps are sharded too and exchanged with one all_gather: a
    # replicated warp would cost D times the work for the same wall time
    local = homography.WarpPlan(plan.homographies[rank * R_loc:(rank + 1) * R_loc], plan.bound)
    warped = all_gather_cat(homography.warp_homographies(frame_gray, local), mesh, POSE_AXIS)
    synth = render_fn(offsets_p[rank * S_loc:(rank + 1) * S_loc])
    scores = all_gather_cat(histogram_nmi.nmi_scores(synth, warped, metric=metric), mesh,
                            POSE_AXIS)  # [S_pad, R_pad]
    valid = (torch.arange(scores.shape[0], device=dev) < S)[:, None]
    return torch.where(valid, scores, -torch.inf)[:S, :R]


def sharded_nmi_search(
    mesh: Mesh,
    model: render.RenderModel,
    frame_gray: torch.Tensor,  # [H, W] float32, the same on every rank
    Tcw: torch.Tensor,  # [4, 4]
    offsets_cam: torch.Tensor,  # [S, 3] translation candidates
    angles: np.ndarray,  # [R, 3] host float32 rotation candidates
    K: np.ndarray,  # [3, 3] host float32 intrinsics
    height: int,
    width: int,
    near: float,
    far: float,
    point_size: int = 3,
    metric: str = "SUC",
) -> torch.Tensor:
    """Evaluate the full (S x R) NMI grid of the point splat (render mode 4)
    with S sharded over the mesh. Returns the [S, R] scores on every rank;
    the caller takes the argmax as in the single-device path."""
    model = render.RenderModel(*(t.to(mesh.device) for t in model))
    return _search(mesh, lambda off: render.render_translation_grid(
        model, Tcw, K, off, height, width, near, far, point_size),
        frame_gray, offsets_cam, angles, K, metric)


def sharded_nmi_search_mesh(
    mesh: Mesh,
    binned: raster.BinnedMesh,  # binned at the grid-center pose, on the mesh's device
    frame_gray: torch.Tensor,  # [H, W] float32, the same on every rank
    Tcw: torch.Tensor,  # [4, 4]
    offsets_cam: torch.Tensor,  # [S, 3] translation candidates
    angles: np.ndarray,  # [R, 3] host float32 rotation candidates
    K: np.ndarray,  # [3, 3] host float32 intrinsics
    near: float,
    far: float,
    metric: str = "SUC",
) -> torch.Tensor:
    """The textured-mesh variant (the reference's default render mode 1):
    each rank rasterizes its share of the candidates from the shared binned
    mesh (`render_gray`, kernel B3 with the sampler fused, on the card)."""
    return _search(mesh, lambda off: raster.render_mesh_grid(binned, Tcw, K, off, near, far),
                   frame_gray, offsets_cam, angles, K, metric)
