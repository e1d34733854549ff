"""Tiled textured-mesh rasterizer: triangles on the GPU without its raster pipeline.

Port of `orbslam2_nmi_tpu/ops/raster.py`, the equivalent of the reference's
RENDER_TEXTURE mode (Thirdparty/Localization/rendering.hpp:530-630 draws the
OBJ mesh through GLSL shaders into a GL_RED FBO). Stages:

  1. **Binning** (once per NMI sweep): every triangle is projected at the
     grid-center pose and binned into fixed-capacity per-screen-tile lists,
     with a margin that covers the whole translation-candidate grid, so one
     binning serves every candidate. Two paths, chosen by the device of the
     call, which give the same lists and slab bit for bit:
       * on a CUDA device, kernels `bin_count` and `bin_fill`
         (csrc/raster.cu): the projection, culls, margins and per-tile counts,
         one readback of four ints that sizes the slab, then the lists and
         the [tiles, 16, C] slab, read from the mesh's arrays that stay on the
         device (`resident_mesh`, uploaded once per mesh and device);
       * on the host (`device=None` or the CPU), numpy, a line-for-line copy
         of the reference's host binning: the plain version, which the CPU
         tests and the JAX parity tests use and the kernels are held against.
  2. **Kernel B3 and the sampler** (csrc/raster.cu), one block per
     (candidate, tile): re-project the tile's triangles for the candidate,
     test coverage, and keep a single-pass integer z-buffer min over packed
     (quantized 1/z << 11 | quantized u-or-v) keys in shared memory, so the
     winner's perspective-correct UV rides in the low bits. One sweep body
     has two epilogues:
       * `render_gray` (the main path): bilinear sampling of the grayscale
         texture at each pixel's winning UV, with the reference's bf16
         rounding of texels and row weights, written straight into the
         cropped [S, H, W] image. It serves B3 and both of the reference's
         samplers (whole texture B4 and per-tile windows B5), which compute
         the same function.
       * `rasterize_keys`: the keys and the winners' UVs in the tiled layout
         [S, tiles, 16, 128], B3's own output, which the parity checks hold
         against the reference and against its plain version.

Each kernel wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors only: `render_gray_plain` is
`rasterize_keys_plain`, then `sample_texture_plain`, then `_untile`. The
binning kernels (`bin_count`, `bin_fill`) run only inside `bin_mesh` on a
CUDA device: their plain version is `bin_mesh`'s host path.

Differences vs GL, by design (as in the reference): triangles crossing the
near plane are dropped whole rather than clipped, and shared-edge pixels may
rasterize into either neighbor (no top-left fill rule).
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.utils.profiling import labelled, span
from orbslam2_nmi_torch.utils.readback import to_host

TILE_H = 16
TILE_W = 128
_PIX = TILE_H * TILE_W  # pixels per tile
ID_BITS = 11  # low bits of the packed z-key (quantized UV lives there)
UV_MAX_P1 = 1 << ID_BITS
UV_MAX = float(UV_MAX_P1 - 1)
MAX_CAPACITY = 2048  # triangles per tile list (kernel chunks of 128)
DEPTH_LEVELS = 1 << 20
SENTINEL = np.int32(2**31 - 1)
MAX_TEX_DIM = 512  # textures above this per side are box-downsampled at bin time
_INV_UV_MAX = float(np.float32(1.0) / np.float32(UV_MAX))
# the span offsets (dy, dx) that order a tile's list: bin_fill counts them in shared memory
MAX_PASSES = 32768
_MAX_TILES_AXIS = 32767  # tiles per axis that bin_count's packed spans hold
# bin_mesh's phases
_BIN_BUILD = span("render.bin_mesh.build")
_BIN_SLAB = span("render.bin_mesh.slab")
_BIN_UPLOAD = span("render.bin_mesh.upload")


class BinnedMesh(NamedTuple):
    """Per-tile triangle lists + SoA triangle data, ready for the kernel.

    Array fields are numpy arrays after `bin_mesh(..., device=None)` and
    tensors on one device otherwise."""

    tri_data: torch.Tensor  # [n_tiles, 16, C] f32: x0 y0 z0 x1 y1 z1 x2 y2 z2 u0 v0 u1 v1 u2 v2 valid
    tri_ids: torch.Tensor  # [n_tiles, C] int32 global face ids (0 in empty slots; see tri_data row 15)
    verts: torch.Tensor  # [V, 3] f32 world vertices
    uvs: torch.Tensor  # [V, 2] f32
    faces: torch.Tensor  # [F, 3] int32
    texture: torch.Tensor  # [Th_pad, Tw_pad] f32 grayscale, <= MAX_TEX_DIM per side
    tex_hw: tuple  # true (Th, Tw) before padding
    tiles_y: int
    tiles_x: int
    height: int  # unpadded output size
    width: int
    capacity: int
    overflow: int  # triangles dropped by capacity clipping (0 in healthy runs)
    # The reference's BinnedMesh also carries per-tile texture windows for its
    # windowed sampler; the port's sampler reads the whole texture (the same
    # function), so they are left out here (see `_tile_texture_windows`).


_ARRAY_FIELDS = ("tri_data", "tri_ids", "verts", "uvs", "faces", "texture")


def to_device(binned: BinnedMesh, device) -> BinnedMesh:
    """Upload a host (numpy) BinnedMesh's arrays to `device` as tensors."""
    up = {k: torch.from_numpy(np.ascontiguousarray(getattr(binned, k))).to(device)
          for k in _ARRAY_FIELDS}
    return binned._replace(**up)


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _downsample_texture(tex: np.ndarray, max_dim: int) -> np.ndarray:
    """Box-filter halvings until both sides are <= max_dim, then pad both
    sides to a multiple of 128. Returns (padded texture, true (h, w))."""
    t = tex.astype(np.float32)
    while max(t.shape) > max_dim:
        h2, w2 = t.shape[0] // 2 * 2, t.shape[1] // 2 * 2
        t = t[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean((1, 3))
    shape = t.shape
    ph = _pad_up(max(t.shape[0], 128), 128) - t.shape[0]
    pw = _pad_up(max(t.shape[1], 128), 128) - t.shape[1]
    return np.pad(t, ((0, ph), (0, pw)), mode="edge"), shape


class ResidentMesh(NamedTuple):
    """A mesh's constant arrays on one device: what the binning kernels and
    the render read, and what a device `BinnedMesh` points at."""

    verts: torch.Tensor  # [V, 3] f32
    uvs: torch.Tensor  # [V, 2] f32
    faces: torch.Tensor  # [F, 3] int32
    texture: torch.Tensor  # [Th_pad, Tw_pad] f32, as `_downsample_texture` pads it
    tex_hw: tuple  # true (Th, Tw) before padding


# (id(mesh), device) -> ResidentMesh; an entry is dropped when its mesh is
# collected, so an id is never reused while its entry lives
_RESIDENT: dict = {}
_RESIDENT_LOCK = threading.Lock()


def resident_mesh(mesh: MeshModel, device) -> ResidentMesh:
    """`mesh`'s constant arrays on the CUDA `device`: checked and uploaded on
    the first call for this (mesh, device), the same tensors on every later
    one, kept while the mesh lives. `MeshModel` is frozen and its arrays are
    read as immutable, as every caller treats them. Raises on a device that
    is not CUDA, and on arrays that no binning can read: faces not [F, 3]
    with F > 0, or indexing past the vertices; vertices not [V, 3]; UVs not
    [V, 2]. The checks come before anything touches the device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the mesh stays resident on a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (id(mesh), device)
    with _RESIDENT_LOCK:
        res = _RESIDENT.get(key)
        if res is None:
            verts = np.asarray(mesh.vertices, np.float32)
            uvs = np.asarray(mesh.uvs, np.float32)
            faces = np.asarray(mesh.faces)
            if faces.ndim != 2 or faces.shape[1] != 3 or len(faces) == 0:
                raise ValueError(f"faces must be [F, 3] with F > 0, got {faces.shape}")
            if verts.ndim != 2 or verts.shape[1] != 3 or uvs.shape != (len(verts), 2):
                raise ValueError(f"vertices {verts.shape} and uvs {uvs.shape} must be "
                                 "[V, 3] and [V, 2]")
            if faces.min() < 0 or faces.max() >= len(verts):
                raise ValueError(f"faces index vertices {faces.min()}..{faces.max()}, "
                                 f"outside 0..{len(verts) - 1}")
            tex_pad, tex_hw = _downsample_texture(mesh.texture_gray, MAX_TEX_DIM)
            res = ResidentMesh(
                *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in (verts, uvs, faces.astype(np.int32), tex_pad)),
                tex_hw=tex_hw,
            )
            _RESIDENT[key] = res
            weakref.finalize(mesh, _RESIDENT.pop, key, None)
    return res


def _bin_params(Tcw_center, K, near, far, max_offset) -> np.ndarray:
    """bin_count's 21 float64 parameters: R row-major, t, fx, fy, cx, cy,
    near, far and |max_offset| per camera axis."""
    T = np.asarray(Tcw_center, np.float64)
    K = np.asarray(K, np.float64)
    off = np.broadcast_to(np.abs(np.asarray(max_offset, np.float64)), (3,))
    return np.concatenate([T[:3, :3].ravel(), T[:3, 3], [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                           [float(near), float(far)], off])


def _bin_count(res: ResidentMesh, params: np.ndarray, height: int, width: int, tiles_y: int,
               tiles_x: int):
    """Kernel `bin_count`: each face's tile span at the pose and intrinsics
    of `params` (`_bin_params`), counted into per-tile counts on the device.
    Returns (spans [F, 2] int32, (largest count, largest span in x, largest
    span in y, overflow)), the second read back to the host by `to_host`,
    whose wait releases the interpreter lock: on the async NMI worker it
    waits behind the tracking thread's queued step."""
    dev = res.verts.device
    spans = torch.empty((len(res.faces), 2), dtype=torch.int32, device=dev)
    buf = torch.zeros(tiles_y * tiles_x + 4, dtype=torch.int32, device=dev)
    counts, record = buf[:-4], buf[-4:]
    kernels.launch("bin_count", dev, res.verts.data_ptr(), res.faces.data_ptr(), len(res.faces),
                   params.ctypes.data, height, width, tiles_y, tiles_x, spans.data_ptr(),
                   counts.data_ptr(), record.data_ptr())
    return spans, tuple(int(x) for x in to_host(record))


def _bin_fill(res: ResidentMesh, spans: torch.Tensor, tiles_y: int, tiles_x: int, max_sx: int,
              max_sy: int, capacity: int):
    """Kernel `bin_fill`: (tri_data [n_tiles, 16, capacity] f32, tri_ids
    [n_tiles, capacity] int32), each tile's list in the host's order, from
    `_bin_count`'s spans and largest spans. Raises when the spans need more
    (dy, dx) passes than the kernel counts in shared memory."""
    n_passes = max(max_sx, 1) * max(max_sy, 1)
    if n_passes > MAX_PASSES:
        raise ValueError(f"spans up to {max_sy}x{max_sx} tiles take {n_passes} passes, more "
                         f"than {MAX_PASSES}")
    dev = res.verts.device
    n_tiles = tiles_y * tiles_x
    tri_data = torch.empty((n_tiles, 16, capacity), dtype=torch.float32, device=dev)
    tri_ids = torch.empty((n_tiles, capacity), dtype=torch.int32, device=dev)
    kernels.launch("bin_fill", dev, res.verts.data_ptr(), res.uvs.data_ptr(),
                   res.faces.data_ptr(), len(res.faces), spans.data_ptr(), n_tiles, tiles_x,
                   max(max_sx, 1), n_passes, capacity, tri_data.data_ptr(), tri_ids.data_ptr())
    return tri_data, tri_ids


def _bin_mesh_cuda(mesh, Tcw_center, K, height, width, near, far, max_offset,
                   device) -> BinnedMesh:
    """`bin_mesh` on a CUDA device: the kernels, from the resident arrays.
    Raises on an image with no tiles, or with more per axis than
    `bin_count`'s packed spans hold."""
    tiles_y = _pad_up(height, TILE_H) // TILE_H
    tiles_x = _pad_up(width, TILE_W) // TILE_W
    if height <= 0 or width <= 0 or max(tiles_y, tiles_x) > _MAX_TILES_AXIS:
        raise ValueError(f"a {height}x{width} image must have 1 to {_MAX_TILES_AXIS} tiles "
                         "per axis")
    with _BIN_UPLOAD():
        res = resident_mesh(mesh, device)
        params = _bin_params(Tcw_center, K, near, far, max_offset)
    with _BIN_BUILD():
        spans, (top, max_sx, max_sy, overflow) = _bin_count(res, params, height, width, tiles_y,
                                                            tiles_x)
        capacity = min(_pad_up(max(top, 1), 128), MAX_CAPACITY)
    with _BIN_SLAB():
        tri_data, tri_ids = _bin_fill(res, spans, tiles_y, tiles_x, max_sx, max_sy, capacity)
    return BinnedMesh(tri_data=tri_data, tri_ids=tri_ids, verts=res.verts, uvs=res.uvs,
                      faces=res.faces, texture=res.texture, tex_hw=res.tex_hw, tiles_y=tiles_y,
                      tiles_x=tiles_x, height=height, width=width, capacity=capacity,
                      overflow=overflow)


@labelled("render.bin_mesh")
def bin_mesh(
    mesh: MeshModel,
    Tcw_center: np.ndarray,
    K: np.ndarray,
    height: int,
    width: int,
    near: float,
    far: float,
    max_offset=0.0,
    device: str | torch.device | None = "cuda",
) -> BinnedMesh:
    """Bin triangles into screen tiles at the grid-center pose.

    `max_offset` is the largest translation-candidate offset per CAMERA AXIS
    (scalar = same bound for all three); each triangle's bounding box is
    inflated by the worst-case pixel shift those offsets can cause so one
    binning is conservative for every candidate in the grid. The margins are
    per-axis and position-dependent: x/y offsets shift by ~f*off/z while a z
    offset scales radially by |u - c|*oz/(z - oz).

    The device of the call chooses the path; both give the same lists, slab,
    capacity and overflow:
      * a CUDA `device`: kernels `bin_count` and `bin_fill` on the card,
        from the mesh's resident arrays (`resident_mesh`), which the result's
        `verts`, `uvs`, `faces` and `texture` are. Its ranges:
        `render.bin_mesh.upload` (the resident arrays, uploaded on the first
        call for the mesh and device, and the pose and intrinsics packed as
        the kernel's parameters), `render.bin_mesh.build` (`bin_count` and
        the readback of its four ints) and `render.bin_mesh.slab`
        (`bin_fill`).
      * `device=None` or any other device: numpy on the host, a copy of the
        reference's binning; `None` keeps the arrays in numpy, another device
        gets them uploaded. Its ranges: `render.bin_mesh.build` (the
        projection, the culls and margins, the (face, tile) pairs, their sort
        and slots), `render.bin_mesh.slab` (the [tiles, 16, C] slab and the
        texture's downsample and pad) and `render.bin_mesh.upload`.
    """
    if device is not None and torch.device(device).type == "cuda":
        return _bin_mesh_cuda(mesh, Tcw_center, K, height, width, near, far, max_offset,
                              torch.device(device))
    with _BIN_BUILD():
        Tcw_center = np.asarray(Tcw_center, np.float64)
        K = np.asarray(K, np.float64)
        v = mesh.vertices.astype(np.float64)
        f = mesh.faces.astype(np.int64)
        pc = v @ Tcw_center[:3, :3].T + Tcw_center[:3, 3]
        z = pc[:, 2]
        z_safe = np.where(z > 1e-6, z, 1e-6)
        u = K[0, 0] * pc[:, 0] / z_safe + K[0, 2]
        w_px = K[1, 1] * pc[:, 1] / z_safe + K[1, 2]

        tz = z[f]  # [F, 3]
        tu = u[f]
        tv = w_px[f]
        # keep faces fully in front of the near plane and not entirely past far
        keep = (tz.min(1) > near) & (tz.min(1) < far)
        off = np.broadcast_to(np.abs(np.asarray(max_offset, np.float64)), (3,))
        zmin = np.maximum(tz.min(1), 1e-3)
        z_after = np.maximum(zmin - off[2], 0.5 * zmin)  # worst-case z shrink
        radial = off[2] / z_after  # |u-c| scale factor from the z offset
        mx = 2.0 + K[0, 0] * off[0] / z_after + np.abs(tu - K[0, 2]).max(1) * radial
        my = 2.0 + K[1, 1] * off[1] / z_after + np.abs(tv - K[1, 2]).max(1) * radial
        x_lo = np.floor(tu.min(1) - mx).astype(np.int64)
        x_hi = np.ceil(tu.max(1) + mx).astype(np.int64)
        y_lo = np.floor(tv.min(1) - my).astype(np.int64)
        y_hi = np.ceil(tv.max(1) + my).astype(np.int64)
        keep &= (x_hi >= 0) & (x_lo < width) & (y_hi >= 0) & (y_lo < height)

        tiles_y = _pad_up(height, TILE_H) // TILE_H
        tiles_x = _pad_up(width, TILE_W) // TILE_W
        n_tiles = tiles_y * tiles_x
        tx_lo = np.clip(x_lo // TILE_W, 0, tiles_x - 1)
        tx_hi = np.clip(x_hi // TILE_W, 0, tiles_x - 1)
        ty_lo = np.clip(y_lo // TILE_H, 0, tiles_y - 1)
        ty_hi = np.clip(y_hi // TILE_H, 0, tiles_y - 1)

        face_ids = np.nonzero(keep)[0]
        # vectorized (face, tile) pair expansion: spans are data-dependent but
        # bounded, so enumerate (dy, dx) span offsets up to the max span and mask
        sy = ty_hi[face_ids] - ty_lo[face_ids] + 1
        sx = tx_hi[face_ids] - tx_lo[face_ids] + 1
        max_sy = int(sy.max(initial=1))
        max_sx = int(sx.max(initial=1))
        pair_tiles = []
        pair_faces = []
        for dy in range(max_sy):
            for dx in range(max_sx):
                m = (dy < sy) & (dx < sx)
                fi = face_ids[m]
                pair_tiles.append((ty_lo[fi] + dy) * tiles_x + (tx_lo[fi] + dx))
                pair_faces.append(fi)
        pair_tiles = np.concatenate(pair_tiles) if pair_tiles else np.zeros(0, np.int64)
        pair_faces = np.concatenate(pair_faces) if pair_faces else np.zeros(0, np.int64)

        if len(pair_tiles):
            counts = np.bincount(pair_tiles, minlength=n_tiles)
            capacity = min(_pad_up(max(int(counts.max()), 1), 128), MAX_CAPACITY)
            order = np.argsort(pair_tiles, kind="stable")
            pt = pair_tiles[order]
            pf = pair_faces[order]
            slot = np.arange(len(pt)) - np.searchsorted(pt, pt, side="left")
            ok = slot < capacity
            overflow = int((~ok).sum())
        else:
            capacity, overflow = 128, 0
            pt = pf = slot = np.zeros(0, np.int64)
            ok = np.zeros(0, bool)

        tri_ids = np.full((n_tiles, capacity), -1, np.int32)
        tri_ids[pt[ok], slot[ok]] = pf[ok]

    with _BIN_SLAB():
        vt = mesh.vertices.astype(np.float32)
        uvs = mesh.uvs.astype(np.float32)
        gathered = np.where(tri_ids >= 0, tri_ids, 0)
        fv = mesh.faces[gathered]  # [n_tiles, C, 3] vertex ids
        data = np.zeros((n_tiles, 16, capacity), np.float32)
        for k in range(3):
            data[:, 3 * k + 0, :] = vt[fv[:, :, k], 0]
            data[:, 3 * k + 1, :] = vt[fv[:, :, k], 1]
            data[:, 3 * k + 2, :] = vt[fv[:, :, k], 2]
            data[:, 9 + 2 * k, :] = uvs[fv[:, :, k], 0]
            data[:, 9 + 2 * k + 1, :] = uvs[fv[:, :, k], 1]
        data[:, 15, :] = (tri_ids >= 0).astype(np.float32)

        tex_pad, tex_hw = _downsample_texture(mesh.texture_gray, MAX_TEX_DIM)
        binned = BinnedMesh(
            tri_data=data,
            tri_ids=np.maximum(tri_ids, 0),
            verts=vt,
            uvs=uvs,
            faces=mesh.faces.astype(np.int32),
            texture=tex_pad,
            tex_hw=tex_hw,
            tiles_y=tiles_y,
            tiles_x=tiles_x,
            height=height,
            width=width,
            capacity=capacity,
            overflow=overflow,
        )
    if device is None:
        return binned
    with _BIN_UPLOAD():
        return to_device(binned, device)


def _tile_texture_windows(data: np.ndarray, tex_pad_shape, tex_hw,
                          force_win: int | None = None):
    """Per-tile texel window origins, as the reference's windowed sampler
    takes them (its `bin_mesh` stores them in its BinnedMesh; the port's
    sampler does not read them, and the tests and chip_smoke.py use them to
    tell a windowed binning from a whole-texture one).

    A screen tile's triangles usually touch a small texture region. Returns
    (origins [n_tiles, 2] int32 as (row0, col0), win), the square window side
    being the smallest 128-multiple covering every tile's texel span (+
    margins), or (None, 0) when no sub-window would help. `force_win` pins the
    side (it must cover this data's spans) so batched renders share one side;
    the origins are always specific to the pose the data was binned at.
    """
    th, tw = tex_hw
    th_pad, tw_pad = tex_pad_shape
    valid = data[:, 15, :] > 0.5  # [n_tiles, C]
    u = np.clip(data[:, 9:15:2, :], 0.0, 1.0)  # [n_tiles, 3, C]
    v = np.clip(data[:, 10:16:2, :], 0.0, 1.0)
    tu = u * (tw - 1)
    tv = (1.0 - v) * (th - 1)  # GL v flip, same as the sampler
    m3 = valid[:, None, :]
    big = np.float32(1e9)
    tu_min = np.where(m3, tu, big).min((1, 2))
    tu_max = np.where(m3, tu, -big).max((1, 2))
    tv_min = np.where(m3, tv, big).min((1, 2))
    tv_max = np.where(m3, tv, -big).max((1, 2))
    any_valid = valid.any(1)
    span = float(
        max(
            np.where(any_valid, tu_max - tu_min, 0.0).max(initial=0.0),
            np.where(any_valid, tv_max - tv_min, 0.0).max(initial=0.0),
        )
    )
    # +4: bilinear x0+1 plus the ~0.25-texel UV quantization of the z-key
    win = max(_pad_up(int(np.ceil(span)) + 4, 128), 128)
    if force_win is not None:
        if force_win < win:
            return None, 0  # forced side cannot cover this pose's spans
        win = force_win
    # the square window must fit inside BOTH texture dims and be smaller than
    # at least one of them to pay off
    if win > min(th_pad, tw_pad) or win >= max(th_pad, tw_pad):
        return None, 0
    row0 = np.clip(np.floor(tv_min) - 1, 0, max(th_pad - win, 0))
    col0 = np.clip(np.floor(tu_min) - 1, 0, max(tw_pad - win, 0))
    row0 = np.where(any_valid, row0, 0.0)
    col0 = np.where(any_valid, col0, 0.0)
    return np.stack([row0, col0], -1).astype(np.int32), win


# ---------------------------------------------------------------------------
# Kernel B3: packed z-buffer keys
# ---------------------------------------------------------------------------


def rasterize_keys_plain(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x):
    """Plain version of kernel B3: (keys int32, u f32, v f32), each
    [S, n_tiles, TILE_H, TILE_W]. Same operations in the same order as the
    kernel (raster.py:350-436 of the reference with the planes in plain f32)."""
    n_tiles = tri_data.shape[0]
    S = poses.shape[0]
    dev = tri_data.device
    f32 = dict(dtype=torch.float32, device=dev)
    tile = torch.arange(n_tiles, device=dev)
    ox = ((tile % tiles_x) * TILE_W).to(torch.float32)[:, None] + 0.5  # [n_tiles, 1]
    oy = ((tile // tiles_x) * TILE_H).to(torch.float32)[:, None] + 0.5
    pix = torch.arange(_PIX, device=dev)
    xl = (pix % TILE_W).to(torch.float32)[None, :, None]  # [1, PIX, 1]
    yl = (pix // TILE_W).to(torch.float32)[None, :, None]
    qscale = float((DEPTH_LEVELS - 1) * near)
    uv_max = torch.tensor(UV_MAX, **f32)
    sentinel = torch.tensor(int(SENTINEL), dtype=torch.int32, device=dev)

    def plane(a, b, c):  # [n_tiles, 128] coefficients -> [n_tiles, PIX, 128]
        return a[:, None, :] * xl + b[:, None, :] * yl + c[:, None, :]

    keys, us, vs = [], [], []
    for s in range(S):
        m = [poses[s, i] for i in range(12)]  # R row-major (9) then t (3)
        best_u = torch.full((n_tiles, _PIX), int(SENTINEL), dtype=torch.int32, device=dev)
        best_v = best_u.clone()
        for c0 in range(0, capacity, 128):
            td = tri_data[:, :, c0 : c0 + 128]  # [n_tiles, 16, 128]

            def project(k):
                X, Y, Z = td[:, 3 * k], td[:, 3 * k + 1], td[:, 3 * k + 2]
                zc = m[6] * X + m[7] * Y + m[8] * Z + m[11]
                zs = torch.clamp(zc, min=1e-6)
                sx = fx * (m[0] * X + m[1] * Y + m[2] * Z + m[9]) / zs + cx
                sy = fy * (m[3] * X + m[4] * Y + m[5] * Z + m[10]) / zs + cy
                return sx - ox, sy - oy, zc

            sx0, sy0, z0 = project(0)
            sx1, sy1, z1 = project(1)
            sx2, sy2, z2 = project(2)
            ok = (td[:, 15] > 0.5) & (z0 > near) & (z1 > near) & (z2 > near)
            A0, B0, C0 = sy1 - sy2, sx2 - sx1, sx1 * sy2 - sx2 * sy1
            A1, B1, C1 = sy2 - sy0, sx0 - sx2, sx2 * sy0 - sx0 * sy2
            A2, B2, C2 = sy0 - sy1, sx1 - sx0, sx0 * sy1 - sx1 * sy0
            area2 = A0 * sx0 + B0 * sy0 + C0
            ok &= torch.abs(area2) > 1e-9
            sgn = torch.where(area2 >= 0, 1.0, -1.0)
            inv = torch.div(torch.ones_like(area2), torch.where(ok, area2, 1.0))
            zi0 = torch.div(torch.ones_like(z0), torch.clamp(z0, min=1e-6))
            zi1 = torch.div(torch.ones_like(z1), torch.clamp(z1, min=1e-6))
            zi2 = torch.div(torch.ones_like(z2), torch.clamp(z2, min=1e-6))

            def bary(f0, f1, f2):
                return ((A0 * f0 + A1 * f1 + A2 * f2) * inv,
                        (B0 * f0 + B1 * f1 + B2 * f2) * inv,
                        (C0 * f0 + C1 * f1 + C2 * f2) * inv)

            E0 = plane(A0 * sgn, B0 * sgn, C0 * sgn)
            E1 = plane(A1 * sgn, B1 * sgn, C1 * sgn)
            E2 = torch.abs(area2)[:, None, :] - E0 - E1
            inside = (E0 >= 0) & (E1 >= 0) & (E2 >= 0) & ok[:, None, :]
            ZI = plane(*bary(zi0, zi1, zi2))
            UZ = plane(*bary(td[:, 9] * zi0, td[:, 11] * zi1, td[:, 13] * zi2))
            VZ = plane(*bary(td[:, 10] * zi0, td[:, 12] * zi1, td[:, 14] * zi2))
            q = torch.clamp(ZI * qscale, 0, DEPTH_LEVELS - 1).to(torch.int32)
            dk = (DEPTH_LEVELS - 1 - q) * (1 << ID_BITS)
            rcp = torch.div(uv_max, torch.clamp(ZI, min=1e-12))
            uq = torch.clamp(UZ * rcp, 0, UV_MAX).to(torch.int32)
            vq = torch.clamp(VZ * rcp, 0, UV_MAX).to(torch.int32)
            key_u = torch.where(inside, dk + uq, sentinel).amin(-1)
            key_v = torch.where(inside, dk + vq, sentinel).amin(-1)
            best_u = torch.minimum(best_u, key_u)
            best_v = torch.minimum(best_v, key_v)
        keys.append(best_u)
        # times the f32 reciprocal, as the reference's compiled division by
        # the constant computes it (it can differ from a division by an ulp)
        us.append((best_u & (UV_MAX_P1 - 1)).to(torch.float32) * _INV_UV_MAX)
        vs.append((best_v & (UV_MAX_P1 - 1)).to(torch.float32) * _INV_UV_MAX)
    shape = (S, n_tiles, TILE_H, TILE_W)
    return (torch.stack(keys).reshape(shape), torch.stack(us).reshape(shape),
            torch.stack(vs).reshape(shape))


def _check_raster_args(tri_data, poses, capacity):
    n_tiles = tri_data.shape[0]
    if tri_data.shape != (n_tiles, 16, capacity) or capacity % 128 or capacity <= 0:
        raise ValueError(f"tri_data {tuple(tri_data.shape)} must be [n_tiles, 16, capacity], "
                         f"capacity a positive multiple of 128 (got {capacity})")
    if poses.dim() != 2 or poses.shape[1] != 12 or poses.shape[0] == 0 or n_tiles == 0:
        raise ValueError(f"poses must be [S, 12] with S > 0, got {tuple(poses.shape)}")


@labelled("rasterize_keys")
def rasterize_keys(tri_data: torch.Tensor, poses: torch.Tensor, capacity: int,
                   fx: float, fy: float, cx: float, cy: float, near: float, tiles_x: int):
    """(keys int32, u f32, v f32), each [S, n_tiles, TILE_H, TILE_W]: packed
    z-buffer keys (SENTINEL = no hit) + the winner's texture UVs. Kernel B3's
    keys epilogue on CUDA, the plain version on CPU."""
    _check_raster_args(tri_data, poses, capacity)
    if tri_data.device.type == "cpu":
        return rasterize_keys_plain(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x)
    dev = kernels.require_cuda(tri_data, poses, dtypes=(torch.float32, torch.float32))
    n_tiles = tri_data.shape[0]
    S = poses.shape[0]
    shape = (S, n_tiles, TILE_H, TILE_W)
    keys = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    kernels.launch(
        "rasterize_keys", dev, tri_data.data_ptr(), poses.data_ptr(), S, n_tiles, capacity,
        tiles_x, fx, fy, cx, cy, near, float((DEPTH_LEVELS - 1) * near),
        keys.data_ptr(), u.data_ptr(), v.data_ptr(),
    )
    return keys, u, v


# ---------------------------------------------------------------------------
# The sampler (kernels B4 and B5 of the reference), B3's gray epilogue
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def sample_texture_plain(keys, uu, vv, texture, th, tw, background):
    """Plain version of the sampler: tiled gray, same shape as `keys`."""
    hit = keys != int(SENTINEL)
    tu = torch.clamp(uu, 0.0, 1.0) * (tw - 1)
    tv = torch.clamp(1.0 - vv, 0.0, 1.0) * (th - 1)  # GL v flip
    x0f = torch.clamp(torch.floor(tu), 0, tw - 2)
    y0f = torch.clamp(torch.floor(tv), 0, th - 2)
    ax = tu - x0f
    ay = tv - y0f
    stride = texture.shape[1]
    tex = _bf16(texture).reshape(-1)
    i00 = y0f.long() * stride + x0f.long()
    w0 = _bf16(1.0 - ay)
    w1 = _bf16(ay)
    c0 = tex[i00] * w0 + tex[i00 + stride] * w1
    c1 = tex[i00 + 1] * w0 + tex[i00 + stride + 1] * w1
    gray = c0 * (1.0 - ax) + c1 * ax
    return torch.where(hit, gray, torch.tensor(background, dtype=torch.float32, device=gray.device))


def _untile(x: torch.Tensor, S: int, ty: int, tx: int, H: int, W: int) -> torch.Tensor:
    """[S, n_tiles, 16, 128] tiled layout -> [S, H, W] image (crop padding)."""
    return (
        x.reshape(S, ty, tx, TILE_H, TILE_W)
        .permute(0, 1, 3, 2, 4)
        .reshape(S, ty * TILE_H, tx * TILE_W)[:, :H, :W]
    )


def render_gray_plain(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x, texture, th, tw,
                      background, H, W):
    """Plain version of `render_gray`: B3, the sampler and the untiling."""
    keys, uu, vv = rasterize_keys_plain(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x)
    gray = sample_texture_plain(keys, uu, vv, texture, th, tw, background)
    return _untile(gray, poses.shape[0], tri_data.shape[0] // tiles_x, tiles_x, H, W)


@labelled("render_gray")
def render_gray(tri_data: torch.Tensor, poses: torch.Tensor, capacity: int, fx: float,
                fy: float, cx: float, cy: float, near: float, tiles_x: int,
                texture: torch.Tensor, th: int, tw: int, background: float, H: int,
                W: int) -> torch.Tensor:
    """[S, H, W] f32: each candidate pose's render, the bilinear gray at each
    hit pixel's (u, 1-v) and `background` elsewhere.

    tri_data [n_tiles, 16, capacity] and poses [S, 12] as `rasterize_keys`
    takes them; texture [Th_pad, Tw_pad] f32 whose true size is (th, tw); the
    image is the top-left H x W of the tiles_y x tiles_x tiles. Kernel B3 with
    its gray epilogue on CUDA, the plain version on CPU."""
    _check_raster_args(tri_data, poses, capacity)
    n_tiles = tri_data.shape[0]
    if tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"{n_tiles} tiles are not rows of tiles_x = {tiles_x}")
    tiles_y = n_tiles // tiles_x
    if not (0 < H <= tiles_y * TILE_H and 0 < W <= tiles_x * TILE_W):
        raise ValueError(f"a {H}x{W} image does not fit {tiles_y}x{tiles_x} tiles")
    if texture.dim() != 2 or not (2 <= th <= texture.shape[0] and 2 <= tw <= texture.shape[1]):
        raise ValueError(f"texture {tuple(texture.shape)} cannot hold a ({th}, {tw}) texture")
    if tri_data.device.type == "cpu":
        return render_gray_plain(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x,
                                 texture, th, tw, background, H, W)
    dev = kernels.require_cuda(tri_data, poses, texture,
                               dtypes=(torch.float32, torch.float32, torch.float32))
    S = poses.shape[0]
    gray = torch.empty((S, H, W), dtype=torch.float32, device=dev)
    kernels.launch(
        "render_gray", dev, tri_data.data_ptr(), poses.data_ptr(), S, n_tiles, capacity, tiles_x,
        fx, fy, cx, cy, near, float((DEPTH_LEVELS - 1) * near), texture.data_ptr(),
        texture.shape[1], th, tw, float(background), H, W, gray.data_ptr(),
    )
    return gray


def grid_poses(Tcw: torch.Tensor, offsets_cam: torch.Tensor) -> torch.Tensor:
    """[S, 12] kernel poses (R row-major | t) of the translation candidates:
    candidate s uses t' = t - offsets_cam[s] (rendering.hpp:644-665)."""
    S = offsets_cam.shape[0]
    t_all = Tcw[:3, 3][None, :] - offsets_cam
    return torch.cat([Tcw[:3, :3].reshape(1, 9).expand(S, 9), t_all], dim=1).contiguous()


@labelled("render_mesh_grid")
def render_mesh_grid(
    binned: BinnedMesh,
    Tcw: torch.Tensor,
    K,
    offsets_cam: torch.Tensor,  # [S, 3] camera-axis offsets of the camera center
    near: float,
    far: float,
    background: float = 0.0,
    out_u8: bool = False,
) -> torch.Tensor:
    """Render every translation candidate from a binned mesh: [S, H, W] f32
    (or uint8 when `out_u8`), on the device that holds `binned`.

    The intrinsics `K` are read on the host (numpy or tensor) and passed to
    the kernel as scalars; `far` only shaped the binning.
    """
    K_host = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K, np.float32)
    dev = binned.tri_data.device
    Tcw = torch.as_tensor(Tcw, dtype=torch.float32, device=dev)
    offsets_cam = torch.as_tensor(offsets_cam, dtype=torch.float32, device=dev)
    th, tw = binned.tex_hw
    img = render_gray(
        binned.tri_data, grid_poses(Tcw, offsets_cam), binned.capacity,
        float(K_host[0, 0]), float(K_host[1, 1]), float(K_host[0, 2]), float(K_host[1, 2]),
        float(near), binned.tiles_x, binned.texture, th, tw, float(background), binned.height,
        binned.width,
    )
    if out_u8:
        img = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
    return img
