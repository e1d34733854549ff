"""Synthetic terrain world: the circuit the tracking front-end is driven on.

Port of the mesh half of `orbslam2_nmi_tpu/io/synthetic.py`:
`terrain_mesh` (the same `default_rng` draws, so the mesh and its texture
are the JAX package's bit for bit) and `SyntheticMeshWorld` (`generate`,
`camera_K`, `pose_at`, `render_frames`, `near_far`). Frames are rendered
with the port's own tiled rasterizer (`ops/raster.py`: host binning, kernel
B3 and the sampler on CUDA), each at its exact pose, as the JAX package
renders its circuit. The port's sampler reads the resident texture whole,
so the reference's per-batch texture-window bookkeeping
(`synthetic.py:237-268`) has no counterpart.

`terrain_height` and `raycast_terrain` are the JAX package's ground-truth
oracle (`tools/fused_probe.py:27-40`): the analytic height field of
`terrain_mesh`, within about 6 mm of the 190-grid mesh at 15 m, and the
intersection of world rays with it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import raster


def terrain_height(x, y, base_z=15.0, relief=3.0):
    return base_z + relief * np.sin(x * 0.3) * np.cos(y * 0.25)


def raycast_terrain(Twc_center, dirs_w):
    """Intersect world-frame rays from the point `Twc_center` [3] along
    `dirs_w` [N, 3] with the analytic height field: the fixed point in t of
    z0 + t dz = h(x0 + t dx, y0 + t dy), 12 iterations. Returns [N, 3]."""
    o = Twc_center
    t = (15.0 - o[2]) / dirs_w[:, 2]
    for _ in range(12):
        p = o[None, :] + t[:, None] * dirs_w
        h = terrain_height(p[:, 0], p[:, 1])
        t = (h - o[2]) / dirs_w[:, 2]
    return o[None, :] + t[:, None] * dirs_w


def terrain_mesh(seed: int = 0, n: int = 190, extent=(40.0, 30.0), base_z: float = 15.0,
                 relief: float = 3.0) -> MeshModel:
    """Textured undulating height-field mesh: 2(n-1)^2 triangles with a
    multi-scale random-block 512x512 texture. Piecewise-constant blocks give
    descriptors that repeat under sub-pixel view shifts, and block edges at
    three scales (~0.6 m, 1.25 m and 5 m on the ground) give FAST corners
    across the whole pyramid."""
    rng = np.random.default_rng(seed)
    ex, ey = extent
    xs = np.linspace(-ex, ex, n)
    ys = np.linspace(-ey, ey, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = base_z + relief * np.sin(X * 0.3) * np.cos(Y * 0.25)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() + ex) / (2 * ex), (Y.ravel() + ey) / (2 * ey)], -1).astype(
        np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    b, c, d = a + 1, a + n + 1, a + n
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)]).astype(np.int32)

    def _blocks(n_block: int, amp: float) -> np.ndarray:
        r = rng.uniform(0, amp, (n_block, n_block))
        return np.kron(r, np.ones((512 // n_block, 512 // n_block)))

    tex = (15.0 + _blocks(128, 95) + _blocks(64, 75) + _blocks(16, 60)).clip(10, 245)
    return MeshModel(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex.astype(np.float32))


@dataclass
class SyntheticMeshWorld:
    """A textured terrain mesh imaged along a closed elliptical circuit that
    revisits its start, looking down at the terrain from about 15 m."""

    mesh: MeshModel
    fx: float = 450.0
    radius_x: float = 12.0
    radius_y: float = 8.0
    overlap: float = 0.10  # fraction of the circuit re-traversed at the end

    @staticmethod
    def generate(seed: int = 0, n_grid: int = 190) -> "SyntheticMeshWorld":
        return SyntheticMeshWorld(mesh=terrain_mesh(seed=seed, n=n_grid))

    def camera_K(self, width: int, height: int) -> np.ndarray:
        return np.array([[self.fx, 0, width / 2], [0, self.fx, height / 2], [0, 0, 1]],
                        np.float32)

    def pose_at(self, i: int, n_frames: int) -> np.ndarray:
        """Tcw on the circuit at z=0 looking down (+z) at the terrain, with a
        gentle yaw/pitch wobble and a vertical swell; the last `overlap` of
        the frames re-traverses the start arc."""
        s = i / max(n_frames - 1, 1)
        th = 2.0 * np.pi * s * (1.0 + self.overlap)
        t = np.array(
            [self.radius_x * np.sin(th), self.radius_y * (1.0 - np.cos(th)),
             0.6 * np.sin(3.0 * th)],
            np.float32,
        )
        yaw = 0.08 * np.sin(2.0 * th)
        pitch = 0.05 * np.sin(th + 0.7)
        R = se3.so3_exp(torch.tensor([pitch, yaw, 0.0], dtype=torch.float32)).numpy()
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = -R @ t
        return Tcw

    def render_frames(self, frame_ids, n_frames: int, width: int, height: int,
                      device="cuda") -> torch.Tensor:
        """Frames [len(frame_ids), H, W] uint8 on `device`, each binned on the
        host and rendered at its own exact pose (B3 and the sampler on CUDA,
        one launch each a frame). Raises if the binning dropped a triangle:
        holes in the ground-truth imagery would bias every test of it."""
        K = self.camera_K(width, height)
        near, far = self.near_far()
        dev = torch.device(device)
        out = torch.empty((len(frame_ids), height, width), dtype=torch.uint8, device=dev)
        zero = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        texture = None
        for j, i in enumerate(frame_ids):
            T = self.pose_at(i, n_frames)
            binned = raster.bin_mesh(self.mesh, T, K, height, width, near, far, device=None)
            if binned.overflow:
                raise ValueError(f"bin_mesh dropped {binned.overflow} triangles at frame {i} "
                                 f"(tile capacity {binned.capacity} exceeded)")
            if texture is None:  # the same texture every frame: upload it once
                texture = torch.from_numpy(binned.texture).to(dev)
            binned = binned._replace(tri_data=torch.from_numpy(binned.tri_data).to(dev),
                                     texture=texture)
            out[j] = raster.render_mesh_grid(binned, T, K, zero, near, far, out_u8=True)[0]
        return out

    @staticmethod
    def near_far() -> tuple:
        return 4.0, 45.0
