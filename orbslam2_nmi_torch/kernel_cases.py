"""Adversarial inputs for kernels B1 (joint entropy), B2 (marginal entropy)
and B3 (rasterizer, with its keys and its gray epilogue).

`chip_smoke.py` and the card-only tests hold each kernel against its plain
version on these inputs; `tests/test_torch_raster.py` also checks on the CPU,
on the raster cases, that no pixel which the plain coverage test accepts lies
outside its triangle's screen box grown by a pixel, the cull that kernel B3
relies on. Every input is made with numpy from a seed.

    for name, synth_bins, warp_bins in joint_cases(device): ...
    for name, calls in marginal_cases(device):
        for synth_bins, warp_bins in calls: marginal_error(synth_bins, warp_bins)
    for name in RASTER_CASES: tri_data, poses, capacity, *camera, tiles_x = raster_case(name, device)
    raster_mismatch(rasterize_keys(*args), rasterize_keys_plain(*args))
    for name in RASTER_CASES: render_gray_gaps(render_case(name, device))
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch.ops import histogram_nmi as hn
from orbslam2_nmi_torch.ops import raster
from orbslam2_nmi_torch.ops.raster import SENTINEL, TILE_H, TILE_W

P_MAIN = 960 * 540  # pixels of one image on the main path
MARGINAL_CLUSTER = 4  # kernel B2's CTAs an image (kMarginalCluster, csrc/histogram_nmi.cu)

# ---------------------------------------------------------------------------
# B1: joint entropy
# ---------------------------------------------------------------------------


def _uint8(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)


def _unaligned(x: np.ndarray, device, shift: int) -> torch.Tensor:
    """A contiguous [N, P] uint8 view whose first byte lies `shift` bytes past
    an aligned allocation, so the kernel cannot load it 16 bytes at a time."""
    flat = torch.zeros(x.size + shift, dtype=torch.uint8, device=device)
    flat[shift:] = _uint8(x.reshape(-1), device)
    return flat[shift:].view(x.shape)


def joint_cases(device, P: int = P_MAIN, seed: int = 0):
    """[(name, synth_bins [S, P] uint8, warp_bins [R, P] uint8)] on `device`:
      * constant: images of one gray each (0, 7, 200), so one bin of a pair
        holds all P counts (0 with 0 is bin (0, 0));
      * zero_rows_cols: most pixels of some images are 0, so row 0 and
        column 0 of the histograms hold most counts;
      * odd_pixel_count: P - 5 pixels, not a multiple of 16;
      * unaligned_rows: row views that start 1 and 3 bytes past alignment;
      * one_pair: S = R = 1.
    odd_pixel_count and unaligned_rows take the kernel's one-byte-at-a-time
    path, the others its 16-byte path."""
    rng = np.random.default_rng(seed)

    def rand(n, p, zero_frac=0.0):
        x = rng.integers(0, 256, (n, p))
        if zero_frac:
            x[rng.random((n, p)) < zero_frac] = 0
        return x

    const_s = np.stack([np.full(P, v) for v in (0, 7)])
    const_w = np.stack([np.full(P, v) for v in (0, 7, 200)])
    zs = rand(3, P)
    zs[0, : int(0.9 * P)] = 0  # a large uncovered block
    zs[1, rng.random(P) < 0.6] = 0  # scattered zeros
    zw = rand(3, P)
    zw[0, int(0.2 * P):] = 0
    zw[1, rng.random(P) < 0.7] = 0
    zw[2] = zs[2]  # a pair of equal images: a diagonal histogram
    p_odd = P - 5
    return [
        ("constant", _uint8(const_s, device), _uint8(const_w, device)),
        ("zero_rows_cols", _uint8(zs, device), _uint8(zw, device)),
        ("odd_pixel_count", _uint8(rand(2, p_odd, 0.3), device),
         _uint8(rand(3, p_odd, 0.1), device)),
        ("unaligned_rows", _unaligned(rand(2, P, 0.2), device, 1),
         _unaligned(rand(2, P, 0.2), device, 3)),
        ("one_pair", _uint8(rand(1, P, 0.2), device), _uint8(rand(1, P, 0.05), device)),
    ]


# ---------------------------------------------------------------------------
# B2: marginal entropy
# ---------------------------------------------------------------------------

MARGINAL_CASES = ("constant", "uniform", "small_pixel_counts", "unaligned_rows", "4k_frames",
                  "one_render", "one_warp", "more_than_one_wave", "one_set", "twice")


def marginal_case(name: str, device, seed: int = 0) -> list:
    """The calls of one adversarial case of kernel B2, to be made in order:
    [(synth_bins [S, P] uint8, warp_bins [R, P] uint8, or None for the
    one-set wrapper)] on `device`.
      * constant: images of one gray each (0, 255; 7), so every add of an
        image lands on one bin;
      * uniform: every bin holds P / 256 counts, the pixels shuffled in one
        image and sorted (runs of 2025 equal grays) in the other;
      * small_pixel_counts: P = 1, 15, 17 and 16 * C - 1 (C CTAs an image):
        CTAs with no 16-byte word to count, and bytes outside whole words;
      * unaligned_rows: rows that start 1 and 3 bytes past alignment;
      * 4k_frames: P = 4096 x 2160;
      * one_render, one_warp: S = 1 with R = 27, and S = 27 with R = 1;
      * more_than_one_wave: S + R = 756 images of 64,800 pixels, more
        clusters than the card holds at once;
      * one_set: R = 0, through `marginal_entropy_grid`;
      * twice: the same shapes twice with other grays, so nothing may carry
        over from one call to the next."""
    rng = np.random.default_rng([seed, MARGINAL_CASES.index(name)])

    def rand(n, p):
        return _uint8(rng.integers(0, 256, (n, p), dtype=np.uint8), device)

    if name == "constant":
        return [(_uint8(np.stack([np.full(P_MAIN, 0), np.full(P_MAIN, 255)]), device),
                 _uint8(np.full((1, P_MAIN), 7), device))]
    if name == "uniform":
        flat = np.repeat(np.arange(256), P_MAIN // 256)
        return [(_uint8(rng.permutation(flat)[None], device), _uint8(flat[None], device))]
    if name == "small_pixel_counts":
        return [(rand(2, p), rand(3, p)) for p in (1, 15, 17, 16 * MARGINAL_CLUSTER - 1)]
    if name == "unaligned_rows":
        return [(_unaligned(rng.integers(0, 256, (3, P_MAIN)), device, 1),
                 _unaligned(rng.integers(0, 256, (2, P_MAIN)), device, 3))]
    if name == "4k_frames":
        return [(rand(2, 4096 * 2160), rand(1, 4096 * 2160))]
    if name == "one_render":
        return [(rand(1, P_MAIN), rand(27, P_MAIN))]
    if name == "one_warp":
        return [(rand(27, P_MAIN), rand(1, P_MAIN))]
    if name == "more_than_one_wave":
        return [(rand(27, P_MAIN // 8), rand(729, P_MAIN // 8))]
    if name == "one_set":
        return [(rand(3, P_MAIN), None)]
    if name == "twice":
        a, b = rand(4, P_MAIN), rand(5, P_MAIN)
        a[:, : P_MAIN // 3] = 0  # a zero border in the first call only
        return [(a, b), (rand(4, P_MAIN), rand(5, P_MAIN))]
    raise ValueError(f"unknown marginal case {name!r}")


def marginal_cases(device, seed: int = 0) -> list:
    """[(name, calls)] of every case of `marginal_case`."""
    return [(name, marginal_case(name, device, seed)) for name in MARGINAL_CASES]


def marginal_error(synth_bins: torch.Tensor, warp_bins: torch.Tensor | None) -> float:
    """max |kernel B2 - its plain version| on one call of a case."""
    P = synth_bins.shape[1]
    if warp_bins is None:
        got = hn.marginal_entropy_grid(synth_bins, P)
        want = hn.marginal_entropy_grid_plain(synth_bins, P)
    else:
        got = hn.marginal_entropy_sets(synth_bins, warp_bins, P)
        want = hn.marginal_entropy_sets_plain(synth_bins, warp_bins, P)
    return (got - want).abs().max().item()


# ---------------------------------------------------------------------------
# B3: rasterizer
# ---------------------------------------------------------------------------

TILES_Y, TILES_X = 4, 4  # a 512 x 64 px screen
FOCAL = 256.0  # with depth 8, a world coordinate k/32 projects to pixel k exactly
CENTER = 0.5  # principal point: pixel k's center is at screen coordinate k + 0.5
NEAR = 5.0
RASTER_CASES = ("tile_edges", "slivers", "edge_on", "pixel_centres", "two_chunks")


def _unproject(u, v, z):
    """World points (identity camera) that project to screen (u, v) at depth z."""
    return np.stack([(u - CENTER) * z / FOCAL, (v - CENTER) * z / FOCAL, z], -1)


def _triangles(name: str, rng) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [T, 3, 3] world, uvs [T, 3, 2]) of one case."""
    W, H = TILES_X * TILE_W, TILES_Y * TILE_H
    if name == "tile_edges":
        # small triangles around tile corners and edges, and large ones over
        # several tiles
        cx = rng.integers(0, TILES_X + 1, 300) * TILE_W
        cy = rng.integers(0, TILES_Y + 1, 300) * TILE_H
        spread = np.where(rng.random(300) < 0.2, 150.0, 20.0)[:, None]
        u = cx[:, None] + rng.uniform(-1, 1, (300, 3)) * spread
        v = cy[:, None] + rng.uniform(-1, 1, (300, 3)) * spread * 0.3
        z = rng.uniform(6.0, 30.0, (300, 3))
    elif name == "slivers":
        # long thin triangles: the third vertex 0.001 to 0.5 px off the first
        # two's segment
        n = 300
        p0 = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
        ang = rng.uniform(0, 2 * np.pi, n)
        d = np.stack([np.cos(ang), np.sin(ang)], -1)
        p1 = p0 + d * rng.uniform(20, 300, n)[:, None]
        eps = rng.choice([1e-3, 0.05, 0.5], n)[:, None]
        p2 = (p0 + p1) / 2 + np.stack([-d[:, 1], d[:, 0]], -1) * eps
        pts = np.stack([p0, p1, p2], 1)
        u, v = pts[..., 0], pts[..., 1]
        z = rng.uniform(6.0, 30.0, (n, 3))
    elif name == "edge_on":
        # triangles nearly parallel to the view direction: two vertices close
        # on screen at very different depths
        n = 300
        u0, v0 = rng.uniform(0, W, n), rng.uniform(0, H, n)
        u = np.stack([u0, u0 + rng.uniform(-0.5, 0.5, n), u0 + rng.uniform(-30, 30, n)], -1)
        v = np.stack([v0, v0 + rng.uniform(-0.5, 0.5, n), v0 + rng.uniform(-0.05, 0.05, n)], -1)
        z = np.stack([rng.uniform(6, 8, n), rng.uniform(20, 40, n), rng.uniform(6, 40, n)], -1)
    elif name == "pixel_centres":
        # vertices on pixel centers at the identity pose, many edges along
        # pixel rows and columns, and equal depths (z = 8)
        n = 300
        k0 = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], -1)
        d1 = rng.integers(-12, 13, (n, 2))
        d2 = rng.integers(-12, 13, (n, 2))
        axis = rng.random(n) < 0.5
        d1[axis, 1] = 0  # an edge along a row of pixel centers
        d2[axis, 0] = 0  # and one along a column
        k = np.stack([k0, k0 + d1, k0 + d2], 1).astype(np.float64)
        # the last third of the triangles a few f32 ulps off the centers
        k[2 * n // 3 :] += rng.choice([-1e-4, -3e-5, 3e-5, 1e-4], (n - 2 * n // 3, 3, 2))
        u, v = k[..., 0] + CENTER, k[..., 1] + CENTER
        z = np.full((n, 3), 8.0)
    elif name == "two_chunks":
        # more than 128 triangles in one tile, so its list takes two chunks
        n = 220
        u = rng.uniform(130, 250, (n, 1)) + rng.uniform(-6, 6, (n, 3))
        v = rng.uniform(18, 30, (n, 1)) + rng.uniform(-3, 3, (n, 3))
        z = rng.uniform(6.0, 30.0, (n, 3))
    else:
        raise ValueError(f"unknown raster case {name!r}")
    verts = _unproject(u, v, z)
    return verts.astype(np.float32), rng.uniform(0, 1, (verts.shape[0], 3, 2)).astype(np.float32)


def raster_case(name: str, device, seed: int = 0):
    """(tri_data, poses, capacity, fx, fy, cx, cy, near, tiles_x): the
    arguments of `raster.rasterize_keys` for one adversarial case. Each
    triangle is listed in every tile that its screen box at the identity
    pose, grown by 8 pixels, meets (more than any candidate pose moves it);
    empty slots are marked invalid. Capacity is 128, or 256 where a tile
    lists more. Poses: the identity and two small translations."""
    rng = np.random.default_rng(seed)
    verts, uvs = _triangles(name, rng)
    z = verts[..., 2]
    u = verts[..., 0] * FOCAL / z + CENTER
    v = verts[..., 1] * FOCAL / z + CENTER
    tx0 = np.clip(np.floor((u.min(1) - 8) / TILE_W), 0, TILES_X - 1).astype(int)
    tx1 = np.clip(np.floor((u.max(1) + 8) / TILE_W), -1, TILES_X - 1).astype(int)
    ty0 = np.clip(np.floor((v.min(1) - 8) / TILE_H), 0, TILES_Y - 1).astype(int)
    ty1 = np.clip(np.floor((v.max(1) + 8) / TILE_H), -1, TILES_Y - 1).astype(int)
    lists = [[] for _ in range(TILES_Y * TILES_X)]
    for t in range(verts.shape[0]):
        for ty in range(ty0[t], ty1[t] + 1):
            for tx in range(tx0[t], tx1[t] + 1):
                lists[ty * TILES_X + tx].append(t)
    longest = max(len(x) for x in lists)
    if longest > 256:
        raise ValueError(f"case {name!r} lists {longest} triangles in a tile (most 256)")
    capacity = 128 if longest <= 128 else 256
    data = np.zeros((TILES_Y * TILES_X, 16, capacity), np.float32)
    for tile, ids in enumerate(lists):
        ids = np.asarray(ids, int)
        data[tile, 0:9, : len(ids)] = verts[ids].reshape(len(ids), 9).T
        data[tile, 9:15, : len(ids)] = uvs[ids].reshape(len(ids), 6).T
        data[tile, 15, : len(ids)] = 1.0
    poses = np.zeros((3, 12), np.float32)
    poses[:, [0, 4, 8]] = 1.0
    poses[1, 9:] = (0.05, -0.03, 0.1)
    poses[2, 9:] = (-0.02, 0.04, -0.2)
    return (torch.from_numpy(data).to(device), torch.from_numpy(poses).to(device), capacity,
            FOCAL, FOCAL, CENTER, CENTER, NEAR, TILES_X)


def raster_mismatch(got, want) -> dict:
    """How far two (keys, u, v) results of B3 differ: `mask`, the fraction of
    pixels hit on one side only; `u` and `v`, the fraction of the pixels hit
    on both sides whose u (v) differs; `depth`, the largest difference of the
    depth bits (key >> 11) there; `err`, max |du| and |dv|; `hit`, the
    fraction of pixels `got` hits."""
    keys, uu, vv = got
    pk, pu, pv = want
    hit_k, hit_p = keys != int(SENTINEL), pk != int(SENTINEL)
    both = hit_k & hit_p
    n_both = max(int(both.sum().item()), 1)
    return dict(
        hit=hit_k.float().mean().item(),
        mask=(hit_k != hit_p).float().mean().item(),
        u=((uu != pu) & both).sum().item() / n_both,
        v=((vv != pv) & both).sum().item() / n_both,
        depth=((keys >> 11) - (pk >> 11)).abs()[both].max().item() if both.any() else 0,
        err=max((uu - pu).abs().max().item(), (vv - pv).abs().max().item()))


# B3's gray epilogue on the raster cases: a seeded texture padded past its
# true size (the padding is never read), a background that no texel takes,
# and an image that crops the last tile row and column (neither side a
# multiple of the tile's)
RENDER_TEX_PAD, RENDER_TEX_HW = (128, 256), (100, 200)
RENDER_BACKGROUND = -17.5
RENDER_HW = (TILES_Y * TILE_H - 3, TILES_X * TILE_W - 35)


def render_case(name: str, device, seed: int = 0):
    """The arguments of `raster.render_gray` for one raster case: those of
    `raster_case`, then texture, th, tw, background, H, W."""
    rng = np.random.default_rng(seed + 1)
    tex = rng.uniform(0, 255, RENDER_TEX_PAD).astype(np.float32)
    return (*raster_case(name, device, seed), torch.from_numpy(tex).to(device),
            *RENDER_TEX_HW, RENDER_BACKGROUND, *RENDER_HW)


def render_gray_gaps(args) -> dict:
    """How far `raster.render_gray(*args)` lies from its two references:
    `exact`, max |diff| to `sample_texture_plain` of `rasterize_keys`' own
    outputs, untiled (the same z-buffer, so 0 is the bar); against the
    all-plain `render_gray_plain`, `mismatch`, the fraction of pixels that
    differ, and `err`, the largest difference."""
    tri, poses, capacity, fx, fy, cx, cy, near, tiles_x, tex, th, tw, bg, H, W = args
    got = raster.render_gray(*args)
    keys = raster.rasterize_keys(tri, poses, capacity, fx, fy, cx, cy, near, tiles_x)
    same_z = raster._untile(raster.sample_texture_plain(*keys, tex, th, tw, bg), poses.shape[0],
                            tri.shape[0] // tiles_x, tiles_x, H, W)
    plain = raster.render_gray_plain(*args)
    return dict(exact=(got - same_z).abs().max().item(),
                mismatch=(got != plain).float().mean().item(),
                err=(got - plain).abs().max().item())
