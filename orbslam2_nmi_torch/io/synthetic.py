"""Synthetic worlds and sequences: the replay oracle with exact ground truth.

Port of `orbslam2_nmi_tpu/io/synthetic.py`:
  * `SyntheticWorld`, the textured point world of the end-to-end tests,
    rendered by the port's point splat (`ops/render.render_pointcloud`);
  * `terrain_mesh` (the same `default_rng` draws, so the mesh and its
    texture are the JAX package's bit for bit) and `SyntheticMeshWorld`
    (`generate`, `generate_wide`, `camera_K`, `pose_at`, `render_frames`,
    `near_far`, `lit_mesh`);
  * `apply_photometric_gap`, the camera-degradation stack of the domain-gap
    runs.
Frames of the mesh world are rendered
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

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import raster, render
from orbslam2_nmi_torch.utils.readback import to_host


def _rotation(pitch: float, yaw: float) -> np.ndarray:
    return se3.so3_exp(torch.tensor([pitch, yaw, 0.0], dtype=torch.float32)).numpy()


@dataclass
class SyntheticWorld:
    """A textured undulating point terrain ~15 m below a forward camera path:
    the oracle of the end-to-end tests (`tests/test_slam_e2e.py`)."""

    points: np.ndarray  # [P, 3] float32
    gray: np.ndarray  # [P] float32
    fx: float = 260.0

    @staticmethod
    def generate(seed: int = 0, n_points: int = 120_000) -> "SyntheticWorld":
        """High-frequency blocky texture on the terrain (rich in FAST corners)."""
        rng = np.random.default_rng(seed)
        x = rng.uniform(-30, 60, n_points)
        y = rng.uniform(-25, 25, n_points)
        z = 15.0 + 2.5 * np.sin(x * 0.35) * np.cos(y * 0.3) + rng.uniform(0, 0.3, n_points)
        pts = np.stack([x, y, z], axis=-1).astype(np.float32)
        gray = ((np.floor(x * 1.3) * 53 + np.floor(y * 1.3) * 101 + np.floor(z * 2.0) * 29) % 200
                + 28).astype(np.float32)
        return SyntheticWorld(points=pts, gray=gray)

    def pose_at(self, i: int, n_frames: int) -> np.ndarray:
        """Ground-truth Tcw along a smooth forward path with a gentle yaw."""
        s = i / max(n_frames - 1, 1)
        t = np.array([12.0 * s, 1.5 * np.sin(s * 2.0), 0.0], np.float32)
        R = _rotation(0.04 * np.sin(s * 2.0), 0.10 * np.sin(s * 3.0))
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = -R @ t
        return Tcw

    def camera_K(self, width: int, height: int) -> np.ndarray:
        return np.array([[self.fx, 0, width / 2], [0, self.fx, height / 2], [0, 0, 1]],
                        np.float32)

    def render_model(self, device="cuda") -> render.RenderModel:
        device = kernels.resolve_device(device, "SyntheticWorld.render_model()")
        return render.RenderModel(points=torch.from_numpy(self.points).to(device),
                                  gray=torch.from_numpy(self.gray).to(device))

    def render_frame(self, i: int, n_frames: int, width: int, height: int,
                     device="cuda") -> np.ndarray:
        """Frame i as uint8 [H, W] on the host, splatted on `device`."""
        img = render.render_pointcloud(self.render_model(device), self.pose_at(i, n_frames),
                                       self.camera_K(width, height), height, width, near=2.0,
                                       far=40.0, point_size=3)
        return np.clip(to_host(img), 0, 255).astype(np.uint8)


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
                 relief: float = 3.0, marks: int = 0) -> MeshModel:
    """Textured undulating height-field mesh: 2(n-1)^2 triangles with a
    multi-scale random-block 512x512 texture. Piecewise-constant blocks give
    descriptors that repeat under sub-pixel view shifts, and block edges at
    three scales (~0.6 m, 1.25 m and 5 m on the ground) give FAST corners
    across the whole pyramid. `marks` small rotated elliptical patches break
    the block texture's self-similarity for place recognition."""
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
    if marks:
        yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
        for _ in range(marks):
            cx, cy = rng.uniform(10, 502, 2)
            a, b = rng.uniform(1.2, 4.0, 2)
            th = rng.uniform(0, np.pi)
            g = rng.uniform(0, 255)
            dx, dy = xx - cx, yy - cy
            u = dx * np.cos(th) + dy * np.sin(th)
            v = -dx * np.sin(th) + dy * np.cos(th)
            tex[(u / a) ** 2 + (v / b) ** 2 < 1.0] = g
        tex = tex.clip(10, 245)
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

    @staticmethod
    def generate_wide(seed: int = 0, n_grid: int = 190) -> "SyntheticMeshWorld":
        """The loop-closure variant: a large circuit under a narrow field of
        view (fx 700, a ~+-10 m ground footprint against a 32x18 m ellipse),
        so opposite arcs see disjoint terrain and the revisit is a true loop
        closure; on the standard circuit every keyframe stays covisible with
        every other."""
        return SyntheticMeshWorld(mesh=terrain_mesh(seed=seed, n=n_grid, marks=500), fx=700.0,
                                  radius_x=16.0, radius_y=9.0, overlap=0.15)

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
        R = _rotation(0.05 * np.sin(th + 0.7), 0.08 * np.sin(2.0 * th))
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = -R @ t
        return Tcw

    def render_frames(self, frame_ids, n_frames: int, width: int, height: int,
                      device="cuda") -> torch.Tensor:
        """Frames [len(frame_ids), H, W] uint8 on `device`, each binned on the
        host and rendered at its own exact pose (`render_gray`, B3 with the
        sampler fused, one launch a frame on CUDA). Raises if the binning dropped a triangle:
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

    def lit_mesh(self, sun=(0.45, 0.30, 0.85), ambient: float = 0.30) -> MeshModel:
        """A photometrically divergent copy of the terrain mesh: the texture
        modulated by Lambertian terrain shading from a sun direction. Camera
        frames rendered from it no longer match the flat prior texture the
        localizer keeps (the reference's operating condition, README.md:1-76).
        The height field's planar UV makes the light map bakeable per texel."""
        mesh = self.mesh
        th, tw = mesh.texture_gray.shape
        n = int(np.sqrt(len(mesh.vertices)))
        Z = mesh.vertices[:, 2].reshape(n, n)  # [y, x] (meshgrid indexing=xy)
        X = mesh.vertices[:, 0].reshape(n, n)
        Y = mesh.vertices[:, 1].reshape(n, n)
        dzdx = np.gradient(Z, X[0, :], axis=1)
        dzdy = np.gradient(Z, Y[:, 0], axis=0)
        nrm = np.stack([-dzdx, -dzdy, np.ones_like(Z)], -1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        sun = np.asarray(sun, np.float64)
        sun = sun / np.linalg.norm(sun)
        light = ambient + (1.0 - ambient) * np.clip(nrm @ sun, 0.0, None)
        # texture row 0 is v = 1 (the sampler's GL flip), i.e. y = +ey: flip rows
        li = np.clip(_bilinear_resize(light[::-1, :], th, tw), 0.0, 1.2)
        tex = np.clip(mesh.texture_gray * li, 0.0, 255.0).astype(np.float32)
        return dataclasses.replace(mesh, texture_gray=tex)


def _bilinear_resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Plain-numpy separable bilinear resize of a 2-D array."""
    ys = np.linspace(0, a.shape[0] - 1, h)
    xs = np.linspace(0, a.shape[1] - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, a.shape[0] - 2)
    x0 = np.clip(xs.astype(np.int64), 0, a.shape[1] - 2)
    ay = (ys - y0)[:, None]
    ax = (xs - x0)[None, :]
    r0 = a[y0][:, x0] * (1 - ax) + a[y0][:, x0 + 1] * ax
    r1 = a[y0 + 1][:, x0] * (1 - ax) + a[y0 + 1][:, x0 + 1] * ax
    return r0 * (1 - ay) + r1 * ay


def apply_photometric_gap(frames: np.ndarray, seed: int = 0, noise_sigma: float = 4.0,
                          gamma: float = 1.25, vignette: float = 0.35) -> np.ndarray:
    """Screen-space camera degradation of rendered uint8 frames [N, H, W]:
    smooth per-frame exposure drift, radial vignette, gamma, sensor noise
    (host numpy, seeded)."""
    rng = np.random.default_rng(seed)
    n, h, w = frames.shape
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    vig = 1.0 - vignette * np.clip(xx * xx + yy * yy, 0.0, 1.0)
    t = np.arange(n) / max(n - 1, 1)
    gain = 0.8 + 0.4 * np.sin(2.5 * np.pi * t + 0.7) * 0.5 + 0.1 * t
    out = np.empty_like(frames)
    for i in range(n):
        f = frames[i].astype(np.float32) / 255.0
        f = np.clip(f * gain[i] * vig, 0.0, 1.0) ** gamma
        f = f * 255.0 + rng.normal(0.0, noise_sigma, (h, w))
        out[i] = np.clip(f, 0, 255).astype(frames.dtype)
    return out
