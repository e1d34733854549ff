"""The benchmark's own world: terrain, circuit, lighting, camera degradation.

A frozen copy of the arithmetic of `orbslam2_nmi_torch/io/synthetic.py`
(`terrain_mesh`, `SyntheticMeshWorld.pose_at`, `lit_mesh`,
`apply_photometric_gap`) and of `ops/render.mesh_to_points`, kept here so
that no later change to the program changes the benchmark's inputs. The
camera frames are rendered on the device by ray-casting the analytic height
field that the mesh samples (`terrain_height`) and sampling the lit texture
bilinearly at the hit point: no per-frame host binning, and nothing of the
program's rasterizer. Everything is drawn from the run's seed.

The program receives only what this module makes: the prior (the flat
textured mesh, or the pointcloud sampled from it), the frames and the poses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Mesh:
    """A textured triangle mesh on the host (the program's `MeshModel` fields)."""

    vertices: np.ndarray  # [V, 3] float32
    uvs: np.ndarray  # [V, 2] float32
    faces: np.ndarray  # [F, 3] int32
    texture_gray: np.ndarray  # [Th, Tw] float32


def terrain_height(x, y, base_z: float, relief: float):
    """The analytic height field the mesh samples (numpy or torch)."""
    lib = torch if isinstance(x, torch.Tensor) else np
    return base_z + relief * lib.sin(x * 0.3) * lib.cos(y * 0.25)


def terrain_mesh(seed: int, prior: dict) -> Mesh:
    """Height-field mesh, 2 (n-1)^2 triangles, with a multi-scale random-block
    texture of prior["texture"] texels a side drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = int(prior["grid"])
    ex, ey = prior["extent"]
    side = int(prior["texture"])
    xs = np.linspace(-ex, ex, n)
    ys = np.linspace(-ey, ey, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = terrain_height(X, Y, prior["base_z"], prior["relief"])
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() + ex) / (2 * ex), (Y.ravel() + ey) / (2 * ey)], -1).astype(
        np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    b, c, d = a + 1, a + n + 1, a + n
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)]).astype(np.int32)

    def blocks(n_block: int, amp: float) -> np.ndarray:
        r = rng.uniform(0, amp, (n_block, n_block))
        return np.kron(r, np.ones((side // n_block, side // n_block)))

    tex = (15.0 + blocks(side // 4, 95) + blocks(side // 8, 75) + blocks(side // 32, 60)).clip(
        10, 245)
    return Mesh(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex.astype(np.float32))


def _bilinear_resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = np.linspace(0, a.shape[0] - 1, h)
    xs = np.linspace(0, a.shape[1] - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, a.shape[0] - 2)
    x0 = np.clip(xs.astype(np.int64), 0, a.shape[1] - 2)
    ay = (ys - y0)[:, None]
    ax = (xs - x0)[None, :]
    r0 = a[y0][:, x0] * (1 - ax) + a[y0][:, x0 + 1] * ax
    r1 = a[y0 + 1][:, x0] * (1 - ax) + a[y0 + 1][:, x0 + 1] * ax
    return r0 * (1 - ay) + r1 * ay


def lit_texture(mesh: Mesh, sun, ambient: float) -> np.ndarray:
    """The texture modulated by Lambertian shading of the terrain from `sun`:
    what the camera sees, photometrically apart from the flat prior."""
    th, tw = mesh.texture_gray.shape
    n = int(np.sqrt(len(mesh.vertices)))
    Z = mesh.vertices[:, 2].reshape(n, n)
    X = mesh.vertices[:, 0].reshape(n, n)
    Y = mesh.vertices[:, 1].reshape(n, n)
    dzdx = np.gradient(Z, X[0, :], axis=1)
    dzdy = np.gradient(Z, Y[:, 0], axis=0)
    nrm = np.stack([-dzdx, -dzdy, np.ones_like(Z)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sun = np.asarray(sun, np.float64)
    sun = sun / np.linalg.norm(sun)
    light = ambient + (1.0 - ambient) * np.clip(nrm @ sun, 0.0, None)
    # texture row 0 is v = 1 (the GL flip), i.e. y = +ey: flip rows
    li = np.clip(_bilinear_resize(light[::-1, :], th, tw), 0.0, 1.2)
    return np.clip(mesh.texture_gray * li, 0.0, 255.0).astype(np.float32)


def mesh_to_points(mesh: Mesh, samples_per_unit_area: float, seed: int = 0):
    """(points [P, 3] f32, gray [P] f32): the mesh sampled in proportion to
    face area, each point the texel nearest its UV (the prior as a cloud)."""
    v, f = mesh.vertices, mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    n_samples = np.maximum((area * samples_per_unit_area).astype(np.int64), 1)
    face_idx = np.repeat(np.arange(len(f)), n_samples)
    rng = np.random.default_rng(seed)
    total = int(n_samples.sum())
    r1 = np.sqrt(rng.uniform(size=total)).astype(np.float32)
    r2 = rng.uniform(size=total).astype(np.float32)
    w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    pts = w0[:, None] * p0[face_idx] + w1[:, None] * p1[face_idx] + w2[:, None] * p2[face_idx]
    uv = (w0[:, None] * mesh.uvs[f[face_idx, 0]] + w1[:, None] * mesh.uvs[f[face_idx, 1]]
          + w2[:, None] * mesh.uvs[f[face_idx, 2]])
    th, tw = mesh.texture_gray.shape
    tx = np.clip((uv[:, 0] * (tw - 1)).round().astype(np.int64), 0, tw - 1)
    ty = np.clip(((1.0 - uv[:, 1]) * (th - 1)).round().astype(np.int64), 0, th - 1)
    return pts.astype(np.float32), mesh.texture_gray[ty, tx].astype(np.float32)


def _rodrigues(w) -> np.ndarray:
    """Axis-angle 3-vector -> 3x3 rotation, float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pose_at(i: float, circuit: dict) -> np.ndarray:
    """Tcw [4, 4] float32 on the elliptical circuit at z = 0 looking down (+z),
    with a gentle pitch/yaw wobble and a vertical swell. Frame indices past
    the circuit's length go on round it at the same motion a frame."""
    n = circuit["frames"]
    s = i / max(n - 1, 1)
    th = 2.0 * np.pi * s * (1.0 + circuit["overlap"])
    t = np.array([circuit["radius_x"] * np.sin(th), circuit["radius_y"] * (1.0 - np.cos(th)),
                  0.6 * np.sin(3.0 * th)])
    R = _rodrigues([0.05 * np.sin(th + 0.7), 0.08 * np.sin(2.0 * th), 0.0])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ t
    return T.astype(np.float32)


def camera_K(camera: dict) -> np.ndarray:
    return np.array([[camera["fx"], 0, camera["cx"]], [0, camera["fy"], camera["cy"]], [0, 0, 1]],
                    np.float32)


def raycast_frames(poses: np.ndarray, camera: dict, prior: dict, texture: torch.Tensor,
                   frame_index: np.ndarray, n_circuit: int, gap: dict,
                   gen: torch.Generator, batch: int = 16) -> torch.Tensor:
    """uint8 [N, H, W] camera frames on `texture`'s device: each pixel's ray
    (through its centre) intersected with the analytic height field by 12
    fixed-point steps, the lit texture sampled bilinearly at the hit's UV,
    then the camera degradation (exposure drift by `frame_index` along the
    circuit, vignette, gamma, sensor noise from `gen`)."""
    dev = texture.device
    f32 = dict(dtype=torch.float32, device=dev)
    H, W = int(camera["height"]), int(camera["width"])
    ys, xs = torch.meshgrid(torch.arange(H, **f32) + 0.5, torch.arange(W, **f32) + 0.5,
                            indexing="ij")
    d_cam = torch.stack([(xs - camera["cx"]) / camera["fx"], (ys - camera["cy"]) / camera["fy"],
                         torch.ones_like(xs)], -1).reshape(-1, 3)  # [HW, 3]
    ex, ey = prior["extent"]
    th, tw = texture.shape
    tex = texture.reshape(-1)
    yy = torch.linspace(-1, 1, H, **f32)[:, None]
    xx = torch.linspace(-1, 1, W, **f32)[None, :]
    vig = 1.0 - gap["vignette"] * torch.clamp(xx * xx + yy * yy, 0.0, 1.0)
    out = torch.empty((len(poses), H, W), dtype=torch.uint8, device=dev)
    for b0 in range(0, len(poses), batch):
        T = torch.as_tensor(np.asarray(poses[b0:b0 + batch], np.float32), **f32)
        Rwc = T[:, :3, :3].transpose(1, 2)
        o = -(Rwc @ T[:, :3, 3:4])[..., 0]  # [B, 3] camera centres
        d = torch.einsum("bij,pj->bpi", Rwc, d_cam)  # [B, HW, 3]
        t = (prior["base_z"] - o[:, None, 2]) / d[..., 2]
        for _ in range(12):
            px = o[:, None, 0] + t * d[..., 0]
            py = o[:, None, 1] + t * d[..., 1]
            h = terrain_height(px, py, prior["base_z"], prior["relief"])
            t = (h - o[:, None, 2]) / d[..., 2]
        px = o[:, None, 0] + t * d[..., 0]
        py = o[:, None, 1] + t * d[..., 1]
        u = torch.clamp((px + ex) / (2 * ex), 0.0, 1.0) * (tw - 1)
        v = torch.clamp(1.0 - (py + ey) / (2 * ey), 0.0, 1.0) * (th - 1)
        x0 = torch.clamp(torch.floor(u), 0, tw - 2)
        y0 = torch.clamp(torch.floor(v), 0, th - 2)
        ax, ay = u - x0, v - y0
        i00 = y0.long() * tw + x0.long()
        gray = ((tex[i00] * (1 - ax) + tex[i00 + 1] * ax) * (1 - ay)
                + (tex[i00 + tw] * (1 - ax) + tex[i00 + tw + 1] * ax) * ay)
        gray = gray.reshape(-1, H, W) / 255.0
        # the exposure drifts along the circuit and back again past a lap
        s = np.asarray(frame_index[b0:b0 + batch], np.float64) / max(n_circuit - 1, 1)
        s = torch.as_tensor(1.0 - np.abs(np.mod(s, 2.0) - 1.0), **f32)
        gain = (0.8 + 0.4 * torch.sin(2.5 * np.pi * s + 0.7) * 0.5 + 0.1 * s)[:, None, None]
        f = torch.clamp(gray * gain * vig, 0.0, 1.0) ** gap["gamma"]
        noise = torch.randn(f.shape, generator=gen, **f32) * gap["noise_sigma"]
        out[b0:b0 + batch] = torch.clamp(f * 255.0 + noise, 0, 255).to(torch.uint8)
    return out


def euler_zyx_angles(R: np.ndarray) -> np.ndarray:
    """The drift accumulator's Euler angles (rotationMatrixToEulerAngles)."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        return np.array([np.arctan2(R[2, 1], R[2, 2]), np.arctan2(-R[2, 0], sy),
                         np.arctan2(R[1, 0], R[0, 0])])
    return np.array([np.arctan2(-R[1, 2], R[1, 1]), np.arctan2(-R[2, 0], sy), 0.0])


def motion_since(poses: list) -> tuple:
    """(dist, rot) per axis: the sums of |delta| of Tcw's translation and of its
    Euler angles over consecutive poses, as the tracker accumulates them."""
    dist, rot = np.zeros(3), np.zeros(3)
    for a, b in zip(poses[:-1], poses[1:]):
        dist += np.abs(b[:3, 3].astype(np.float64) - a[:3, 3])
        rot += np.abs(euler_zyx_angles(b[:3, :3].astype(np.float64))
                      - euler_zyx_angles(a[:3, :3].astype(np.float64)))
    return dist, rot


def perturb(Tcw: np.ndarray, d_cam: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Tcw with the camera centre moved by `d_cam` along its own axes and the
    camera rotated by R = Rz Ry Rx(angles) on the right of Twc."""
    Twc = np.linalg.inv(Tcw.astype(np.float64))
    eye = np.eye(3)
    R = _rodrigues(eye[2] * angles[2]) @ _rodrigues(eye[1] * angles[1]) @ _rodrigues(
        eye[0] * angles[0])
    out = Twc.copy()
    out[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ d_cam
    out[:3, :3] = Twc[:3, :3] @ R
    return np.linalg.inv(out).astype(np.float32)
