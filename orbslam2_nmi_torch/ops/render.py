"""Offscreen point-splat rendering of the prior model, and the translation grid.

Port of `orbslam2_nmi_tpu/ops/render.py`, the reference's RENDER_POINT_CLOUD
mode (render mode 4; Thirdparty/Localization/rendering.hpp:64-759 draws
GL_POINTS into an FBO). Each point's quantized depth and gray pack into one
int32 key (depth in the high bits, gray in the low byte), so one scatter-min
over the keys is the depth test; glPointSize(k) becomes a k x k min-pool of
the key image (the nearest depth in the neighborhood wins, as point sprites
do under GL_LESS). The whole translation grid renders as one scatter over
S x P entries. There is no TPU kernel here: the reference runs these as XLA
ops. On CUDA the port runs two hand-written kernels (`csrc/splat.cu`:
`splat_scatter` projects every point once a candidate and folds its key in
with atomicMin, `splat_resolve` min-pools and writes the gray), launched once
each a render call (the scatter not for an empty cloud); on the CPU it runs the same function as torch ops
(`splat_keys_plain`, `resolve_keys_plain`), which the card's tests hold the
kernels against bit for bit.

The arithmetic follows the reference's compiled render (`render_translation_grid`
is jitted with `near` and `far` static, so XLA multiplies by the f32
reciprocal of `far - near` rather than dividing): on the CPU the port's
images equal the reference's pixel for pixel (tests/test_torch_render.py).

Camera-frame translation offsets follow calculateTranslation semantics
(rendering.hpp:644-665): with Tcw = [R|t], a camera-center offset `o` in
camera axes renders with t' = t - o.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.io.model_loader import MeshModel, PointCloudModel
from orbslam2_nmi_torch.utils.profiling import labelled, span

_BIG = 2**30  # empty pixel (and masked point) key
_DEPTH_LEVELS = 2**22

_SPLAT_PROJECT = span("render.splat.project")
_SPLAT_SCATTER = span("render.splat.scatter")
_SPLAT_RESOLVE = span("render.splat.resolve")


class RenderModel(NamedTuple):
    """Device-resident renderable: world points + gray intensities [0, 255]."""

    points: torch.Tensor  # [P, 3] float32
    gray: torch.Tensor  # [P] float32


def model_from_pointcloud(pc: PointCloudModel, device: str | torch.device = "cuda") -> RenderModel:
    return RenderModel(
        points=torch.as_tensor(np.asarray(pc.points, np.float32), device=device),
        gray=torch.as_tensor(np.asarray(pc.gray, np.float32), device=device),
    )


def mesh_to_points(
    mesh: MeshModel, samples_per_unit_area: float = 400.0, max_points: int = 4_000_000, seed: int = 0
) -> PointCloudModel:
    """Densely sample a textured mesh into a colored pointcloud (host-side,
    once at load). Per-face sample count is proportional to face area. A
    line-for-line numpy copy of the reference, with the same random draws, so
    the points are the reference's bit for bit."""
    v = mesh.vertices
    f = mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(p1 - p0, p2 - p0)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    n_samples = np.maximum((area * samples_per_unit_area).astype(np.int64), 1)
    total = int(n_samples.sum())
    if total > max_points:
        scale = max_points / total
        n_samples = np.maximum((n_samples * scale).astype(np.int64), 1)
        total = int(n_samples.sum())

    face_idx = np.repeat(np.arange(len(f)), n_samples)
    rng = np.random.default_rng(seed)
    r1 = np.sqrt(rng.uniform(size=total)).astype(np.float32)
    r2 = rng.uniform(size=total).astype(np.float32)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2
    pts = (
        w0[:, None] * p0[face_idx]
        + w1[:, None] * p1[face_idx]
        + w2[:, None] * p2[face_idx]
    )
    uv = (
        w0[:, None] * mesh.uvs[f[face_idx, 0]]
        + w1[:, None] * mesh.uvs[f[face_idx, 1]]
        + w2[:, None] * mesh.uvs[f[face_idx, 2]]
    )
    th, tw = mesh.texture_gray.shape
    # GL-style UV: v=0 at texture bottom
    tx = np.clip((uv[:, 0] * (tw - 1)).round().astype(np.int64), 0, tw - 1)
    ty = np.clip(((1.0 - uv[:, 1]) * (th - 1)).round().astype(np.int64), 0, th - 1)
    gray = mesh.texture_gray[ty, tx]
    return PointCloudModel(points=pts.astype(np.float32), gray=gray.astype(np.float32))


def _min_pool(key_img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size min-pool, stride 1, of int32 key images [..., H, W], padded
    with the empty key as XLA's "SAME" padding does ((size - 1) // 2 before,
    the rest after). Exact on int32: a float pool would round keys past 2^24."""
    if size <= 1:
        return key_img
    lo = (size - 1) // 2
    hi = size - 1 - lo
    h, w = key_img.shape[-2:]
    padded = F.pad(key_img, (lo, hi, lo, hi), value=_BIG)
    rows = padded[..., 0:h, :]
    for d in range(1, size):
        rows = torch.minimum(rows, padded[..., d:d + h, :])
    out = rows[..., 0:w]
    for d in range(1, size):
        out = torch.minimum(out, rows[..., d:d + w])
    return out


def _intrinsics(K) -> tuple:
    """fx, fy, cx, cy as float32, read on the host (numpy or tensor)."""
    K_host = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, np.float32)
    return tuple(K_host[i, j] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))


def _inv_range(near: float, far: float) -> np.float32:
    # the reference's compiled (z - near) / (far - near): times the f32 reciprocal
    return np.float32(1.0) / np.float32(far - near)


def _splat_candidates(points: torch.Tensor, gray: torch.Tensor, R: torch.Tensor,
                      t_all: torch.Tensor, K, height: int, width: int, near: float,
                      far: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's [S, P] flat pixel indices (int64, into the [S, H, W]
    buffer) and keys (int32): the points in each candidate's camera frame
    (R p + t_all[s], the rotation in `se3.mv_fma`'s order), projected to pixel
    indices and keys (span `render.splat.project`)."""
    S = t_all.shape[0]
    dev = points.device
    rotated = se3.mv_fma(R, points).T  # [3, P], never TF32
    x, y, z = (rotated[i][None, :] + t_all[:, i:i + 1] for i in range(3))  # [S, P] each
    with _SPLAT_PROJECT():
        fx, fy, cx, cy = (torch.tensor(v, device=dev) for v in _intrinsics(K))
        z_safe = torch.where(z > 1e-6, z, torch.tensor(1e-6, device=dev))
        u = fx * x / z_safe + cx
        v = fy * y / z_safe + cy
        ui = torch.round(u).to(torch.int32)
        vi = torch.round(v).to(torch.int32)
        ok = (z > near) & (z < far) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
        inv_range = torch.tensor(_inv_range(near, far), device=dev)
        zq = torch.clamp(((z - near) * inv_range * _DEPTH_LEVELS).to(torch.int32), 0,
                         _DEPTH_LEVELS - 1)
        g8 = torch.clamp(gray, 0, 255).to(torch.int32)
        key = torch.where(ok, zq * 256 + g8, _BIG)
        # masked points write the empty key to their render's pixel 0, which
        # leaves it as it was
        base = torch.arange(S, device=dev, dtype=torch.int64)[:, None] * (height * width)
        pix = torch.where(ok, vi.to(torch.int64) * width + ui, 0) + base
    return pix, key


def splat_keys_plain(points: torch.Tensor, gray: torch.Tensor, R: torch.Tensor,
                     t_all: torch.Tensor, K, height: int, width: int, near: float,
                     far: float) -> torch.Tensor:
    """Plain version of `splat_keys`, in torch ops on any device: the
    candidates' pixel indices and keys, scatter-min into the key buffer (span
    `render.splat.scatter`)."""
    S = t_all.shape[0]
    pix, key = _splat_candidates(points, gray, R, t_all, K, height, width, near, far)
    with _SPLAT_SCATTER():
        buf = torch.full((S * height * width,), _BIG, dtype=torch.int32, device=points.device)
        buf.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin", include_self=True)
    return buf.reshape(S, height, width)


def splat_keys(points: torch.Tensor, gray: torch.Tensor, R: torch.Tensor, t_all: torch.Tensor,
               K, height: int, width: int, near: float, far: float) -> torch.Tensor:
    """[S, H, W] int32 key buffer of S renders of the points (world [P, 3],
    gray [P]) at rotation R [3, 3] and translations t_all [S, 3]: the nearest
    point's zq * 256 + gray at each pixel, `_BIG` where none landed. Kernel
    `splat_scatter` on CUDA (the intrinsics, near, far and the depth scale
    are launch arguments; span `render.splat.project`, then the fill and the
    launch in `render.splat.scatter`), the plain version on the CPU."""
    if points.device.type == "cpu":
        return splat_keys_plain(points, gray, R, t_all, K, height, width, near, far)
    with _SPLAT_PROJECT():
        R, t_all = R.contiguous(), t_all.contiguous()
        dev = kernels.require_cuda(points, gray, R, t_all, dtypes=(torch.float32,) * 4)
        P, S = points.shape[0], t_all.shape[0]
        if (points.shape != (P, 3) or gray.shape != (P,) or R.shape != (3, 3)
                or t_all.shape != (S, 3) or S == 0 or height <= 0 or width <= 0):
            raise ValueError(f"points {tuple(points.shape)}, gray {tuple(gray.shape)}, R "
                             f"{tuple(R.shape)}, t_all {tuple(t_all.shape)}, {height}x{width}: "
                             "want [P, 3], [P], [3, 3], [S, 3] with S > 0 and a non-empty image")
        args = (*(float(v) for v in _intrinsics(K)), float(near), float(far),
                float(_inv_range(near, far)))
    with _SPLAT_SCATTER():
        keys = torch.full((S, height, width), _BIG, dtype=torch.int32, device=dev)
        if P == 0:  # an empty cloud lands nothing: no launch
            return keys
        kernels.launch("splat_scatter", dev, points.data_ptr(), gray.data_ptr(), R.data_ptr(),
                       t_all.data_ptr(), P, S, height, width, *args, keys.data_ptr())
    return keys


def resolve_keys_plain(keys: torch.Tensor, point_size: int, background: float) -> torch.Tensor:
    """Plain version of `resolve_keys`, in torch ops on any device."""
    with _SPLAT_RESOLVE():
        img_key = _min_pool(keys, point_size)
        return torch.where(img_key < _BIG, (img_key % 256).to(torch.float32),
                           torch.tensor(background, dtype=torch.float32, device=keys.device))


def resolve_keys(keys: torch.Tensor, point_size: int, background: float) -> torch.Tensor:
    """[S, H, W] f32 renders of a key buffer: the point_size x point_size
    min-pool (glPointSize), the winner's gray, `background` where no key
    landed. Kernel `splat_resolve` on CUDA (span `render.splat.resolve`), the
    plain version on the CPU."""
    if keys.device.type == "cpu":
        return resolve_keys_plain(keys, point_size, background)
    with _SPLAT_RESOLVE():
        dev = kernels.require_cuda(keys, dtypes=(torch.int32,))
        S, height, width = keys.shape
        out = torch.empty((S, height, width), dtype=torch.float32, device=dev)
        kernels.launch("splat_resolve", dev, keys.data_ptr(), S, height, width,
                       max(1, int(point_size)), float(background), out.data_ptr())
    return out


def _splat(model: RenderModel, R: torch.Tensor, t_all: torch.Tensor, K, height: int,
           width: int, near: float, far: float, point_size: int,
           background: float) -> torch.Tensor:
    """[S, H, W] f32 renders of `model` at rotation R and translations t_all."""
    keys = splat_keys(model.points, model.gray, R, t_all, K, height, width, near, far)
    return resolve_keys(keys, point_size, background)


@labelled("render_pointcloud")
def render_pointcloud(
    model: RenderModel,
    Tcw: torch.Tensor,
    K,
    height: int,
    width: int,
    near: float,
    far: float,
    point_size: int = 3,
    background: float = 0.0,
) -> torch.Tensor:
    """Render [H, W] float32 grayscale with z-buffering (GL_LESS semantics):
    the grid's splat at one candidate, `se3_apply`'s arithmetic."""
    Tcw = torch.as_tensor(Tcw, dtype=torch.float32, device=model.points.device)
    return _splat(model, Tcw[:3, :3], Tcw[:3, 3][None, :], K, height, width, near, far,
                  point_size, background)[0]


@labelled("render_translation_grid")
def render_translation_grid(
    model: RenderModel,
    Tcw: torch.Tensor,
    K,
    offsets_cam: torch.Tensor,  # [S, 3] camera-axis offsets of the camera center
    height: int,
    width: int,
    near: float,
    far: float,
    point_size: int = 3,
) -> torch.Tensor:
    """Render every translation candidate: [S, H, W] float32, one splat over
    all S x P points (the kernels on CUDA, torch ops on the CPU)."""
    dev = model.points.device
    Tcw = torch.as_tensor(Tcw, dtype=torch.float32, device=dev)
    offsets_cam = torch.as_tensor(offsets_cam, dtype=torch.float32, device=dev)
    t_all = Tcw[:3, 3][None, :] - offsets_cam  # [S, 3]
    return _splat(model, Tcw[:3, :3], t_all, K, height, width, near, far, point_size, 0.0)


def translation_grid_offsets(
    synth_num: tuple[int, int, int],
    synth_step: tuple[float, float, float],
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """[S, 3] camera-axis offsets, centered grid; index s = (sz*ny + sy)*nx + sx
    (matches the rating-array layout localization.cpp:185-210)."""
    nx, ny, nz = synth_num
    sx, sy, sz = synth_step
    f32 = dict(dtype=torch.float32, device=device)
    ox = (torch.arange(nx, **f32) - (nx - 1) / 2.0) * sx
    oy = (torch.arange(ny, **f32) - (ny - 1) / 2.0) * sy
    oz = (torch.arange(nz, **f32) - (nz - 1) / 2.0) * sz
    OZ, OY, OX = torch.meshgrid(oz, oy, ox, indexing="ij")
    return torch.stack([OX.reshape(-1), OY.reshape(-1), OZ.reshape(-1)], dim=-1)
