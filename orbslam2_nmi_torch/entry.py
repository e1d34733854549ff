"""The NMI pose-grid step, the port's main path.

Mirrors `__graft_entry__.entry()` of the JAX package: one full evaluation of
the pose grid around a prior pose. It renders every translation candidate of
the textured prior mesh (kernel B3 and the sampler), warps the live frame by
every rotation hypothesis, scores every (render, warp) pair by NMI (kernels
B1 and B2), and takes the argmax on the device.

    from orbslam2_nmi_torch.entry import entry
    fn, (frame, Tcw) = entry()            # 960x540, 27 renders x 27 warps
    scores, best = fn(frame, Tcw)         # [27, 27] f32, flat argmax

`localizer_entry()` builds the NMI localizer (`slam/nmi/localizer.py`) on the
same scene, camera and steps, which turns grid steps into an anchored pose:

    loc, frame, T_true = localizer_entry()          # textured mesh, 960x540
    out = loc.relocalize_strategy(frame, T_pert, initializing=True)

Both run on CUDA unless the caller passes `device="cpu"` (the CPU runs the
kernels' plain versions; the tests use it at small sizes).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import CameraConfig, NMIConfig
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import histogram_nmi, homography, raster, render
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer

NEAR, FAR = 5.0, 40.0
SYNTH_STEP = (0.2, 0.2, 0.5)  # meters per translation-grid step (X, Y, Z)
WARP_STEP = (0.02, 0.02, 0.05)  # radians per rotation-grid step (X, Y, Z)


def _toy_mesh(n=80, seed=0):
    """The reference entry's height-field prior: an (n-1)^2 * 2 triangle mesh
    over 80 x 60 m at ~15 m depth with a random 256x256 texture."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-40, 40, n)
    ys = np.linspace(-30, 30, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = 15.0 + 3.0 * np.sin(X * 0.3) * np.cos(Y * 0.25)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack(
        [(X.ravel() - xs[0]) / 80.0, (Y.ravel() - ys[0]) / 60.0], -1
    ).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate(
        [np.stack([a, a + 1, a + n + 1], -1), np.stack([a, a + n + 1, a + n], -1)]
    ).astype(np.int32)
    tex = rng.uniform(10, 245, (256, 256)).astype(np.float32)
    return MeshModel(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex)


def camera_K(height: int, width: int) -> np.ndarray:
    """The entry's intrinsics: 435 px focal length at 960 px width, scaled
    with the width, principal point at the image center."""
    f = 435.0 * width / 960.0
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)


class NMIGridStep:
    """One pose-grid evaluation against a binned prior mesh, on one device.

    `render`, `warp` and `score` are the step's three stages, callable on
    their own for timing; `__call__` runs all three and the argmax. The
    rotation grid's homographies and shift bound are built once, here.
    """

    def __init__(self, binned: raster.BinnedMesh, K: np.ndarray, offsets: torch.Tensor,
                 angles: np.ndarray, use_background: bool = True):
        self.binned = binned
        self.K = K
        self.offsets = offsets
        self.angles = angles
        self.use_background = use_background
        f32 = dict(dtype=torch.float32, device=binned.tri_data.device)
        self.homographies = homography.homographies_from_angles(
            torch.as_tensor(K, **f32), torch.as_tensor(angles, **f32))
        self.shift_bound = homography.shift_bounds_for_angles(K, angles, binned.height,
                                                              binned.width)

    def render(self, Tcw: torch.Tensor) -> torch.Tensor:
        return raster.render_mesh_grid(self.binned, Tcw, self.K, self.offsets, NEAR, FAR)

    def warp(self, frame_gray: torch.Tensor) -> torch.Tensor:
        return homography.warp_homographies(frame_gray, self.homographies, self.shift_bound)

    def score(self, synth: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
        return histogram_nmi.nmi_scores(synth, warped, use_background=self.use_background)

    def __call__(self, frame_gray: torch.Tensor, Tcw: torch.Tensor):
        scores = self.score(self.render(Tcw), self.warp(frame_gray))
        return scores, torch.argmax(scores)


def entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
          synth_num=(3, 3, 3), warp_num=(3, 3, 3), use_background: bool = True):
    """(fn, (frame_gray, Tcw)): the NMI grid step at full camera resolution by
    default (960x540, 27 textured-mesh renders x 27 warps = 729 scored pose
    pairs), and an example frame and pose on `device`."""
    device = kernels.resolve_device(device, "entry()")
    K = camera_K(height, width)
    binned = raster.bin_mesh(
        _toy_mesh(), np.eye(4, dtype=np.float32), K, height, width, NEAR, FAR,
        max_offset=SYNTH_STEP, device=device,
    )
    offsets = render.translation_grid_offsets(synth_num, SYNTH_STEP, device=device)
    angles = homography.rotation_grid_angles(warp_num, WARP_STEP, device="cpu").numpy()
    fn = NMIGridStep(binned, K, offsets, angles, use_background=use_background)
    rng = np.random.default_rng(1)
    frame = torch.from_numpy(rng.uniform(0, 255, (height, width)).astype(np.float32)).to(device)
    Tcw = torch.eye(4, dtype=torch.float32, device=device)
    return fn, (frame, Tcw)


def localizer_entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
                    render_mode: int = 1):
    """(localizer, frame, T_true): the NMI localizer on the entry's scene and
    camera at full camera resolution by default, with a frame rendered at
    T_true = I by the same renderer, so an exact match exists.

    `render_mode` 1 renders the textured toy mesh (kernel B3 and the
    sampler); 4 renders the mesh's dense point sampling (`mesh_to_points`,
    2,211,835 points) by point splat. The NMI settings are the defaults
    (3^3 x 3^3 grids, the entry's steps, 4 iterations, SUC, background kept)
    with near/far 5/40 m and the accept threshold 0.1.
    """
    device = kernels.resolve_device(device, "localizer_entry()")
    K = camera_K(height, width)
    camera = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                          cy=float(K[1, 2]), width=width, height=height)
    cfg = NMIConfig(render_near=NEAR, render_far=FAR, threshold=0.1, render_mode=render_mode)
    mesh = _toy_mesh()
    T_true = np.eye(4, dtype=np.float32)
    if render_mode == 1:
        loc = NMILocalizer(cfg, camera, None, mesh=mesh, device=device)
        binned = raster.bin_mesh(mesh, T_true, K, height, width, NEAR, FAR, device=device)
        frame = raster.render_mesh_grid(binned, T_true, K, torch.zeros(1, 3), NEAR, FAR)[0]
    elif render_mode == 4:
        model = render.model_from_pointcloud(render.mesh_to_points(mesh), device)
        loc = NMILocalizer(cfg, camera, model, device=device)
        frame = render.render_pointcloud(model, T_true, K, height, width, NEAR, FAR,
                                         point_size=max(1, round(cfg.render_point_size)))
    else:
        raise ValueError(f"render_mode must be 1 (textured mesh) or 4 (pointcloud), "
                         f"got {render_mode}")
    return loc, frame, T_true
