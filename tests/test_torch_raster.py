"""Parity of orbslam2_nmi_torch.ops.raster with the JAX package.

The host binning is a line-for-line numpy copy, so it must equal the
reference field by field, bit for bit. The kernels run in interpret mode on
the JAX side and as their plain versions on the port's side, on the meshes of
tests/test_raster.py plus the entry's toy mesh.

Tolerances of the rasterizer. The reference evaluates its planes as bf16x3
split matrix products (raster.py:298-311); the port evaluates them in plain
f32. On the toy mesh at 64x256 with 9 candidates (147,456 pixels) this
measured: identical hit masks; u differing on 0.043 % and v on 0.042 % of hit
pixels, never by more than one quantum (1/2047); the depth bits (key >> 11)
differing on 15.5 % of hit pixels by at most 2 of 2^20 levels. (On the
two-quad scene: 0.063 % and 0.021 %; on the other meshes: none.) So the tests
assert: hit masks equal on all but 0.1 % of pixels; u and v equal on at least
99 % of pixels hit on both sides and within 1/2047 on all of them; gray equal
to 1e-4 wherever u and v are equal. The depth bits are not compared exactly;
the two-quad test checks that depth order picks the same surface.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch import kernel_cases
from orbslam2_nmi_torch.io import model_loader as tml
from orbslam2_nmi_torch.io.model_loader import MeshModel as TMeshModel
from orbslam2_nmi_torch.ops import raster as tr
from orbslam2_nmi_tpu.io import model_loader as jml
from orbslam2_nmi_tpu.io.model_loader import MeshModel
from orbslam2_nmi_tpu.ops import raster as jr
from orbslam2_nmi_tpu.ops import render as jrender

H, W = 48, 256  # multiples of the 16x128 tile, as in tests/test_raster.py
K = np.array([[100.0, 0, 128.0], [0, 100.0, 24.0], [0, 0, 1]], np.float32)
SENT = int(tr.SENTINEL)


def quad_mesh(z=5.0, size=4.0, gray_tl=200.0, gray_br=40.0):
    s = size / 2
    verts = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tex = np.full((8, 8), gray_tl, np.float32)
    tex[4:, 4:] = gray_br
    return MeshModel(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex)


def wavy_mesh(tex_side=300, seed=11):
    """tests/test_raster.py's windowed-sampler mesh (the window path engages)."""
    rng = np.random.default_rng(seed)
    n = 24
    xs = np.linspace(-3, 3, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    Z = 6.0 + 0.5 * np.sin(X) * np.cos(Y)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() + 3) / 6, (Y.ravel() + 3) / 6], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate(
        [np.stack([a, a + 1, a + n + 1], -1), np.stack([a, a + n + 1, a + n], -1)]
    ).astype(np.int32)
    tex = rng.uniform(0, 255, (tex_side, tex_side)).astype(np.float32)
    return MeshModel(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex)


def _bin_both(mesh, Tcw=np.eye(4, dtype=np.float32), K=K, h=H, w=W, near=1.0, far=50.0,
              max_offset=0.0):
    jb = jr.bin_mesh(mesh, Tcw, K, h, w, near, far, max_offset=max_offset, device_arrays=False)
    return jb, convert.binned_from_numpy(jb._asdict(), "cpu")


def _jax_render(jb, Tcw, K, offsets, near, far, whole_texture=False):
    b = jb._replace(tri_data=jnp.asarray(jb.tri_data), texture=jnp.asarray(jb.texture))
    if whole_texture:
        b = b._replace(tex_origin=None, tex_win=0)
    return np.asarray(jr.render_mesh_grid(b, Tcw, K, jnp.asarray(offsets), near, far,
                                          interpret=True))


def _poses(Tcw, offsets):
    S = offsets.shape[0]
    return np.concatenate(
        [np.tile(Tcw[:3, :3].reshape(1, 9), (S, 1)), Tcw[:3, 3][None] - offsets], 1
    ).astype(np.float32)


def assert_render_parity(jb, tb, Tcw, K, offsets, near=1.0, far=50.0):
    """Keys, UVs and gray of the port against the reference, within the bars
    stated in the module docstring. Returns the port's image."""
    offsets = np.array(offsets, np.float32)
    kw = dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
              near=float(near))
    jk, ju, jv = (np.asarray(x) for x in jr._rasterize_keys(
        jnp.asarray(jb.tri_data), jnp.asarray(_poses(Tcw, offsets)), jb.capacity,
        tiles_x=jb.tiles_x, interpret=True, **kw))
    tk, tu, tv = (x.numpy() for x in tr.rasterize_keys(
        tb.tri_data, torch.from_numpy(_poses(Tcw, offsets)), tb.capacity,
        tiles_x=tb.tiles_x, **kw))
    hit_j, hit_t = jk != SENT, tk != SENT
    assert (hit_j != hit_t).mean() <= 1e-3
    both = hit_j & hit_t
    if both.any():
        for a, b in ((ju, tu), (jv, tv)):
            assert (a == b)[both].mean() >= 0.99
            assert np.abs(a - b)[both].max() <= 1.0 / 2047 + 1e-6
    img_j = _jax_render(jb, Tcw, K, offsets, near, far)
    img_t = tr.render_mesh_grid(tb, torch.from_numpy(Tcw), K, torch.from_numpy(offsets),
                                near, far).numpy()
    S = offsets.shape[0]
    same = (ju == tu) & (jv == tv) & (hit_j == hit_t)
    same = tr._untile(torch.from_numpy(same), S, tb.tiles_y, tb.tiles_x, tb.height,
                      tb.width).numpy()
    np.testing.assert_allclose(img_t[same], img_j[same], atol=1e-4)
    return img_t


def _assert_binned_equal(jb, tb):
    """Every field of the port's BinnedMesh, and the texture windows that the
    reference's BinnedMesh adds, equal the reference bit for bit. Returns the
    window side (0: the whole texture)."""
    assert set(tr.BinnedMesh._fields) | {"tex_origin", "tex_win"} == set(jr.BinnedMesh._fields)
    for f in tr.BinnedMesh._fields:
        a, b = getattr(jb, f), getattr(tb, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    origin, win = tr._tile_texture_windows(tb.tri_data, tb.texture.shape, tb.tex_hw)
    assert win == jb.tex_win
    assert (origin is None and jb.tex_origin is None) or (
        origin.dtype == jb.tex_origin.dtype and np.array_equal(origin, jb.tex_origin))
    return win


@pytest.mark.parametrize("case", ["quad", "wavy_windowed", "wavy_small_texture", "toy_grid"])
def test_bin_mesh_matches_reference_bitwise(case):
    mesh, kw = {
        "quad": (quad_mesh(), dict(near=1.0, far=50.0, max_offset=0.4)),
        "wavy_windowed": (wavy_mesh(), dict(near=1.0, far=50.0)),
        "wavy_small_texture": (wavy_mesh(tex_side=100), dict(near=1.0, far=50.0)),
        "toy_grid": (tentry._toy_mesh(), dict(near=5.0, far=40.0, max_offset=(0.2, 0.2, 0.5))),
    }[case]
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = [0.1, -0.2, 0.3]
    jb = jr.bin_mesh(mesh, Tcw, K, H, W, device_arrays=False, **kw)
    tmesh = TMeshModel(mesh.vertices, mesh.uvs, mesh.faces, mesh.texture_gray)
    tb = tr.bin_mesh(tmesh, Tcw, K, H, W, device=None, **kw)
    win = _assert_binned_equal(jb, tb)
    if case == "wavy_windowed":
        assert win >= 128
    if case == "wavy_small_texture":
        assert win == 0


def test_model_loader_copy_matches_reference(tmp_path):
    """load_obj (fan triangulation, corner re-indexing, missing UVs),
    load_texture_gray (.npy) and the XYZ loader give the reference's arrays."""
    tex = np.random.default_rng(1).uniform(0, 300, (6, 5, 3)).astype(np.float32)
    np.save(tmp_path / "tex.npy", tex)
    (tmp_path / "m.obj").write_text(
        "v 0 0 1\nv 1 0 1\nv 1 1 1\nv 0 1 1\nv 2 2 2\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\nf 2/2 5 3/3\n# comment\n")
    (tmp_path / "p.xyz").write_text("1 2 3 255 0 0\n4 5 6 0 1 0\n")
    (tmp_path / "off.txt").write_text("1 1 1\n")
    for fn, args in (("load_obj", (str(tmp_path / "m.obj"), str(tmp_path / "tex.npy"))),
                     ("load_obj", (str(tmp_path / "m.obj"),)),
                     ("load_xyz_pointcloud", (str(tmp_path / "p.xyz"), str(tmp_path / "off.txt")))):
        a, b = getattr(tml, fn)(*args), getattr(jml, fn)(*args)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (fn, f.name)


@pytest.mark.parametrize("force_win", [None, 128, 256, 512])
def test_tile_texture_windows_match_reference(force_win):
    jb = jr.bin_mesh(wavy_mesh(tex_side=600), np.eye(4, dtype=np.float32), K, H, W, 1.0, 50.0,
                     device_arrays=False)
    args = (jb.tri_data, jb.texture.shape, jb.tex_hw)
    ja, jw = jr._tile_texture_windows(*args, force_win=force_win)
    ta, tw = tr._tile_texture_windows(*args, force_win=force_win)
    assert jw == tw
    assert (ja is None and ta is None) or np.array_equal(ja, ta)


def test_quad_coverage_and_texture():
    jb, tb = _bin_both(quad_mesh())
    img = assert_render_parity(jb, tb, np.eye(4, dtype=np.float32), K, np.zeros((1, 3)))
    inside = img[0, 10:38, 90:166]
    assert (inside > 0).all()
    assert img[0, 2, 2] == 0.0
    assert abs(img[0, 6, 92] - 200.0) < 0.5
    assert abs(img[0, 40, 164] - 40.0) < 0.5


def test_depth_ordering_two_quads():
    """A nearer quad wins the z-buffer against a farther one, as in the
    reference, and both packages pick the same surface."""
    near_q = quad_mesh(z=4.0, size=2.0, gray_tl=10.0, gray_br=10.0)
    far_q = quad_mesh(z=10.0, size=8.0, gray_tl=250.0, gray_br=250.0)
    # one texture, two regions: the near quad samples its 10-gray corner, the
    # far quad its 250-gray corner (u, v kept a texel away from the seam)
    tex = np.full((8, 8), 10.0, np.float32)
    tex[:4, 4:] = 250.0
    uv_near, uv_far = near_q.uvs * 0.4, far_q.uvs * 0.4 + 0.6
    mesh = MeshModel(
        vertices=np.concatenate([near_q.vertices, far_q.vertices]),
        uvs=np.concatenate([uv_near, uv_far]),
        faces=np.concatenate([near_q.faces, far_q.faces + 4]),
        texture_gray=tex,
    )
    Tcw = np.eye(4, dtype=np.float32)
    jb, tb = _bin_both(mesh)
    both = assert_render_parity(jb, tb, Tcw, K, np.zeros((1, 3)))[0]
    jn, tn = _bin_both(MeshModel(near_q.vertices, uv_near, near_q.faces, tex))
    near_only = assert_render_parity(jn, tn, Tcw, K, np.zeros((1, 3)))[0]
    covered = near_only > 0
    assert covered.sum() > 500
    np.testing.assert_allclose(both[covered], near_only[covered], atol=0.5)
    assert (np.abs(both[covered] - 10.0) < 1.0).mean() > 0.95  # the near surface's gray
    assert (both[~covered & (both > 0)] > 200).mean() > 0.95  # the far one around it


def test_windowed_binning_matches_whole_texture():
    """The port's one sampler, given the windowed binning, equals the
    reference's windowed AND whole-texture samplers (which equal each other)."""
    Tcw = np.eye(4, dtype=np.float32)
    jb, tb = _bin_both(wavy_mesh())
    assert jb.tex_origin is not None and jb.tex_win >= 128
    img = assert_render_parity(jb, tb, Tcw, K, np.zeros((1, 3)))
    i_full = _jax_render(jb, Tcw, K, np.zeros((1, 3)), 1.0, 50.0, whole_texture=True)
    i_win = _jax_render(jb, Tcw, K, np.zeros((1, 3)), 1.0, 50.0)
    np.testing.assert_array_equal(i_win, i_full)
    assert (np.abs(img - i_full) <= 1e-4).mean() >= 0.99


def test_toy_mesh_translation_grid_matches_reference():
    """The entry's toy mesh at 64x256 with 9 translation candidates."""
    h, w = 64, 256
    Kt = tentry.camera_K(h, w)
    Tcw = np.eye(4, dtype=np.float32)
    jb = jr.bin_mesh(tentry._toy_mesh(), Tcw, Kt, h, w, 5.0, 40.0,
                     max_offset=(0.2, 0.2, 0.5), device_arrays=False)
    tb = convert.binned_from_numpy(jb._asdict(), "cpu")
    offsets = np.array(jrender.translation_grid_offsets((3, 3, 1), (0.2, 0.2, 0.5)))
    img = assert_render_parity(jb, tb, Tcw, Kt, offsets, 5.0, 40.0)
    assert img.shape == (9, h, w) and np.isfinite(img).all()


def test_batched_render_matches_single():
    """Each candidate of a batched render equals its render alone, bit for bit,
    and a translation offset shifts the image as in the reference test."""
    offsets = np.array([[0.0, 0, 0], [0.5, 0, 0], [0.2, -0.3, 0.4]], np.float32)
    jb, tb = _bin_both(quad_mesh(), max_offset=1.0)
    Tcw = torch.eye(4)
    batched = tr.render_mesh_grid(tb, Tcw, K, torch.from_numpy(offsets), 1.0, 50.0).numpy()
    for s in range(3):
        single = tr.render_mesh_grid(tb, Tcw, K, torch.from_numpy(offsets[s : s + 1]), 1.0, 50.0)
        np.testing.assert_array_equal(batched[s], single[0].numpy())
    assert_render_parity(jb, tb, np.eye(4, dtype=np.float32), K, offsets)
    cols0 = np.nonzero(batched[0].sum(0))[0]
    cols1 = np.nonzero(batched[1].sum(0))[0]
    assert abs(cols1.mean() - cols0.mean() + 10.0) < 1.5
    u8 = tr.render_mesh_grid(tb, Tcw, K, torch.from_numpy(offsets), 1.0, 50.0, out_u8=True)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(), np.clip(batched, 0, 255).astype(np.uint8))


def test_wrappers_validate_inputs():
    tri = torch.zeros(2, 16, 100)
    with pytest.raises(ValueError):
        tr.rasterize_keys(tri, torch.zeros(1, 12), 100, 1.0, 1.0, 0.0, 0.0, 1.0, 1)
    tri = torch.zeros(2, 16, 128)
    good = (tri, torch.zeros(1, 12), 128, 1.0, 1.0, 0.0, 0.0, 1.0, 2)
    tail = (torch.zeros(8, 8), 8, 8, 0.0, 16, 256)
    assert tr.render_gray(*good, *tail).shape == (1, 16, 256)
    for bad in (
        (*good[:-1], 3, *tail),  # 2 tiles are no rows of 3
        (*good, torch.zeros(8, 8), 16, 8, 0.0, 16, 256),  # texture smaller than (th, tw)
        (*good, torch.zeros(8), 8, 8, 0.0, 16, 256),  # not a 2-D texture
        (*good, *tail[:-2], 17, 256),  # more rows than the tiles hold
        (*good, *tail[:-2], 16, 257),  # more columns
        (*good, *tail[:-2], 0, 256),  # an empty image
        (tri, torch.zeros(0, 12), *good[2:], *tail),  # no pose
    ):
        with pytest.raises(ValueError):
            tr.render_gray(*bad)


def test_render_gray_matches_reference():
    """`render_gray` on CPU tensors against the JAX package's
    `render_mesh_grid` (interpret mode, windowed sampler) on the entry's toy
    mesh with 9 translation candidates, at 60x250: neither side a multiple of
    the 16x128 tile, so the last tile row and column are cropped. Gray equal
    to 1e-4 wherever both packages' u and v are equal (the module
    docstring's bar), and bit for bit `render_mesh_grid`, which calls it."""
    h, w = 60, 250
    Kt = tentry.camera_K(h, w)
    Tcw = np.eye(4, dtype=np.float32)
    jb = jr.bin_mesh(tentry._toy_mesh(), Tcw, Kt, h, w, 5.0, 40.0,
                     max_offset=(0.2, 0.2, 0.5), device_arrays=False)
    tb = convert.binned_from_numpy(jb._asdict(), "cpu")
    assert (tb.tiles_y * tr.TILE_H, tb.tiles_x * tr.TILE_W) == (64, 256)
    offsets = np.array(jrender.translation_grid_offsets((3, 3, 1), (0.2, 0.2, 0.5)), np.float32)
    args = (tb.tri_data, torch.from_numpy(_poses(Tcw, offsets)), tb.capacity, float(Kt[0, 0]),
            float(Kt[1, 1]), float(Kt[0, 2]), float(Kt[1, 2]), 5.0, tb.tiles_x)
    img = tr.render_gray(*args, tb.texture, *tb.tex_hw, 0.0, h, w)
    assert img.shape == (9, h, w) and torch.isfinite(img).all() and (img > 0).float().mean() > 0.5
    torch.testing.assert_close(img, tr.render_mesh_grid(tb, torch.from_numpy(Tcw), Kt,
                                                        torch.from_numpy(offsets), 5.0, 40.0),
                               atol=0, rtol=0)
    jk, ju, jv = (np.asarray(x) for x in jr._rasterize_keys(
        jnp.asarray(jb.tri_data), jnp.asarray(_poses(Tcw, offsets)), jb.capacity,
        tiles_x=jb.tiles_x, interpret=True, fx=args[3], fy=args[4], cx=args[5], cy=args[6],
        near=5.0))
    tk, tu, tv = tr.rasterize_keys(*args)
    same = ((ju == tu.numpy()) & (jv == tv.numpy()) & ((jk == SENT) == (tk.numpy() == SENT)))
    same = tr._untile(torch.from_numpy(same), 9, tb.tiles_y, tb.tiles_x, h, w).numpy()
    assert same.mean() > 0.99
    ref = _jax_render(jb, Tcw, Kt, offsets, 5.0, 40.0)
    np.testing.assert_allclose(img.numpy()[same], ref[same], atol=1e-4)


def _assert_render_gray_on_card(args):
    """`render_gray` bit for bit the sampler's plain version on the keys
    epilogue's outputs (the same z-buffer), and equal to the all-plain
    composition on all but 1e-4 of pixels (0 expected: chip_smoke.py's
    RASTER_MISMATCH_FRAC)."""
    d = kernel_cases.render_gray_gaps(args)
    assert d["exact"] == 0.0
    assert d["mismatch"] <= 1e-4


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """B3's keys epilogue against its plain version and its gray epilogue
    (`render_gray`) against the two bars of `_assert_render_gray_on_card`, on
    the card: f32 with the same operation order (no FMA contraction), so bit
    for bit, at 960x540 and at 270x475, which crops the last tile row and
    column."""
    for h, w in ((540, 960), (270, 475)):
        Kt = tentry.camera_K(h, w)
        tb = tr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), Kt, h, w, 5.0, 40.0,
                         max_offset=(0.2, 0.2, 0.5), device=cuda_device)
        offsets = torch.tensor([[0.0, 0, 0], [0.2, -0.2, 0.5]], device=cuda_device)
        poses = tr.grid_poses(torch.eye(4, device=cuda_device), offsets)
        args = (tb.tri_data, poses, tb.capacity, float(Kt[0, 0]), float(Kt[1, 1]),
                float(Kt[0, 2]), float(Kt[1, 2]), 5.0, tb.tiles_x)
        k = tr.rasterize_keys(*args)
        p = tr.rasterize_keys_plain(*args)
        for a, b in zip(k, p):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        for bg in (0.0, 37.25):
            _assert_render_gray_on_card((*args, tb.texture, *tb.tex_hw, bg, h, w))


def _covered_outside_box(tri_data, poses, fx, fy, cx, cy, near, tiles_x):
    """(covered, outside): pixels that the plain coverage test accepts, and
    those of them outside their triangle's screen box grown by one pixel, over
    every (pose, tile, slot). The projections, planes and tests are the
    operations of `rasterize_keys_plain` in f32; the box is the one kernel B3
    sweeps: columns ceil(xmin) - 1 .. floor(xmax) + 1, rows likewise, in the
    tile-local frame whose integer points are the pixel centers."""
    n_tiles, _, capacity = tri_data.shape
    tile = torch.arange(n_tiles)
    ox = ((tile % tiles_x) * tr.TILE_W).to(torch.float32)[:, None] + 0.5
    oy = ((tile // tiles_x) * tr.TILE_H).to(torch.float32)[:, None] + 0.5
    pix = torch.arange(tr.TILE_H * tr.TILE_W)
    xl = (pix % tr.TILE_W).to(torch.float32)[None, :, None]
    yl = (pix // tr.TILE_W).to(torch.float32)[None, :, None]
    covered = outside = 0
    for m in poses:
        for c0 in range(0, capacity, 128):
            td = tri_data[:, :, c0 : c0 + 128]
            sx, sy, sz = [], [], []
            for k in range(3):
                X, Y, Z = td[:, 3 * k], td[:, 3 * k + 1], td[:, 3 * k + 2]
                zc = m[6] * X + m[7] * Y + m[8] * Z + m[11]
                zs = torch.clamp(zc, min=1e-6)
                sx.append(fx * (m[0] * X + m[1] * Y + m[2] * Z + m[9]) / zs + cx - ox)
                sy.append(fy * (m[3] * X + m[4] * Y + m[5] * Z + m[10]) / zs + cy - oy)
                sz.append(zc)
            ok = (td[:, 15] > 0.5) & (sz[0] > near) & (sz[1] > near) & (sz[2] > near)
            A0, B0, C0 = sy[1] - sy[2], sx[2] - sx[1], sx[1] * sy[2] - sx[2] * sy[1]
            A1, B1, C1 = sy[2] - sy[0], sx[0] - sx[2], sx[2] * sy[0] - sx[0] * sy[2]
            area2 = A0 * sx[0] + B0 * sy[0] + C0
            ok &= torch.abs(area2) > 1e-9
            sgn = torch.where(area2 >= 0, 1.0, -1.0)

            def plane(a, b, c):
                return a[:, None, :] * xl + b[:, None, :] * yl + c[:, None, :]

            E0 = plane(A0 * sgn, B0 * sgn, C0 * sgn)
            E1 = plane(A1 * sgn, B1 * sgn, C1 * sgn)
            E2 = torch.abs(area2)[:, None, :] - E0 - E1
            inside = (E0 >= 0) & (E1 >= 0) & (E2 >= 0) & ok[:, None, :]
            xs, ys = torch.stack(sx), torch.stack(sy)
            x0 = torch.clamp(torch.ceil(xs.amin(0)) - 1, min=0)[:, None, :]
            x1 = torch.clamp(torch.floor(xs.amax(0)) + 1, max=tr.TILE_W - 1)[:, None, :]
            y0 = torch.clamp(torch.ceil(ys.amin(0)) - 1, min=0)[:, None, :]
            y1 = torch.clamp(torch.floor(ys.amax(0)) + 1, max=tr.TILE_H - 1)[:, None, :]
            in_box = (xl >= x0) & (xl <= x1) & (yl >= y0) & (yl <= y1)
            covered += int(inside.sum())
            outside += int((inside & ~in_box).sum())
    return covered, outside


@pytest.mark.parametrize("case", ["toy_mesh", *kernel_cases.RASTER_CASES])
def test_bounding_box_cull_is_exact(case):
    """Kernel B3 tests each triangle only at the pixels of its screen box grown
    by one pixel. No pixel that the plain coverage test accepts may lie
    outside it: on the entry's toy mesh (64x256, 9 candidates) and on the
    adversarial cases (triangles across tile edges, slivers 0.001 px thin,
    near edge-on triangles, vertices on pixel centers, two chunks)."""
    if case == "toy_mesh":
        h, w = 64, 256
        Kt = tentry.camera_K(h, w)
        tb = tr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), Kt, h, w,
                         tentry.NEAR, tentry.FAR, max_offset=tentry.SYNTH_STEP, device="cpu")
        offsets = torch.from_numpy(np.array(
            jrender.translation_grid_offsets((3, 3, 1), tentry.SYNTH_STEP), np.float32))
        args = (tb.tri_data, tr.grid_poses(torch.eye(4), offsets), float(Kt[0, 0]),
                float(Kt[1, 1]), float(Kt[0, 2]), float(Kt[1, 2]), tentry.NEAR, tb.tiles_x)
    else:
        tri, poses, _, *rest = kernel_cases.raster_case(case, "cpu")
        args = (tri, poses, *rest)
    covered, outside = _covered_outside_box(*args)
    assert covered > 1000
    assert outside == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", kernel_cases.RASTER_CASES)
def test_rasterizer_adversarial_on_card(cuda_device, case):
    """B3 against its plain version on the adversarial cases: hit mask, u and v
    equal on all but 1e-4 of pixels (0 expected), depth within 2 levels; and
    `render_gray` on the same case (a seeded texture, a background no texel
    takes, an image that crops the last tile row and column) within the bars
    of `_assert_render_gray_on_card`."""
    args = kernel_cases.raster_case(case, cuda_device)
    d = kernel_cases.raster_mismatch(tr.rasterize_keys(*args), tr.rasterize_keys_plain(*args))
    assert max(d["mask"], d["u"], d["v"]) <= 1e-4
    assert d["depth"] <= 2
    _assert_render_gray_on_card(kernel_cases.render_case(case, cuda_device))
