"""Plain reference of the mesh render (render mode 1).

Frozen copies of the program's plain arithmetic (`orbslam2_nmi_torch/ops/
raster.py`: the host binning `bin_mesh`, `rasterize_keys_plain`,
`sample_texture_plain`, `_untile`, `grid_poses`): each candidate's render is
the textured mesh rasterized with a packed z-buffer, then sampled
bilinearly with the texels and row weights rounded to bfloat16, as the
reference system's GL path does. Plain PyTorch and numpy only: the binning
is worked out again here from the mesh, never taken from the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TILE_H = 16
TILE_W = 128
_PIX = TILE_H * TILE_W
ID_BITS = 11
UV_MAX_P1 = 1 << ID_BITS
UV_MAX = float(UV_MAX_P1 - 1)
MAX_CAPACITY = 2048
DEPTH_LEVELS = 1 << 20
SENTINEL = np.int32(2**31 - 1)
MAX_TEX_DIM = 512
_INV_UV_MAX = float(np.float32(1.0) / np.float32(UV_MAX))


class BinnedMesh(NamedTuple):
    tri_data: np.ndarray  # [n_tiles, 16, C] f32
    texture: np.ndarray  # [Th_pad, Tw_pad] f32
    tex_hw: tuple
    tiles_y: int
    tiles_x: int
    height: int
    width: int
    capacity: int
    overflow: int



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


def bin_mesh(mesh, Tcw_center: np.ndarray, K: np.ndarray, height: int, width: int, near: float,
             far: float, max_offset=0.0) -> BinnedMesh:
    """Bin triangles into screen tiles at the grid-center pose (host, numpy).

    `max_offset` is the largest translation-candidate offset per CAMERA AXIS
    (scalar = same bound for all three); each triangle's bounding box is
    inflated by the worst-case pixel shift those offsets can cause so one
    binning is conservative for every candidate in the grid. The margins are
    per-axis and position-dependent: x/y offsets shift by ~f*off/z while a z
    offset scales radially by |u - c|*oz/(z - oz).
    """
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
    return BinnedMesh(tri_data=data, texture=tex_pad, tex_hw=tex_hw, tiles_y=tiles_y,
                      tiles_x=tiles_x, height=height, width=width, capacity=capacity,
                      overflow=overflow)


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


def grid_poses(Tcw: torch.Tensor, offsets_cam: torch.Tensor) -> torch.Tensor:
    """[S, 12] kernel poses (R row-major | t) of the translation candidates:
    candidate s uses t' = t - offsets_cam[s] (rendering.hpp:644-665)."""
    S = offsets_cam.shape[0]
    t_all = Tcw[:3, 3][None, :] - offsets_cam
    return torch.cat([Tcw[:3, :3].reshape(1, 9).expand(S, 9), t_all], dim=1).contiguous()


def render_mesh_grid(binned: BinnedMesh, Tcw: torch.Tensor, K: np.ndarray,
                     offsets_cam: torch.Tensor, near: float, device) -> torch.Tensor:
    """[S, H, W] f32 renders of the binned mesh at the S candidates, rendered
    a few candidates at a time so that the plain planes fit in memory."""
    K = np.asarray(K, np.float32)
    tri = torch.from_numpy(binned.tri_data).to(device)
    tex = torch.from_numpy(binned.texture).to(device)
    poses = grid_poses(Tcw.to(device), offsets_cam.to(device))
    th, tw = binned.tex_hw
    out = []
    for s0 in range(0, poses.shape[0], 4):
        keys, uu, vv = rasterize_keys_plain(tri, poses[s0:s0 + 4], binned.capacity,
                                            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                                            float(K[1, 2]), float(near), binned.tiles_x)
        gray = sample_texture_plain(keys, uu, vv, tex, th, tw, 0.0)
        out.append(_untile(gray, keys.shape[0], binned.tiles_y, binned.tiles_x, binned.height,
                           binned.width))
    return torch.cat(out)
