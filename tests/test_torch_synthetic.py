"""The port's synthetic terrain world against the JAX package's.

`terrain_mesh` makes the same draws, so its arrays are equal (exact); the
circuit's poses agree within 1e-6 (`so3_exp` in float32 in both; measured:
equal). Rendering runs the port's rasterizer on the CPU (plain versions
of B3 and the sampler); it must raise when the binning drops a triangle.
"""

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.io import synthetic as tsyn
from orbslam2_nmi_torch.ops import raster
from orbslam2_nmi_tpu.io import synthetic as jsyn

POSE_ATOL = 1e-6


@pytest.mark.parametrize("n", [190, 60])
def test_terrain_mesh_equal(n):
    t, j = tsyn.terrain_mesh(seed=0, n=n), jsyn.terrain_mesh(seed=0, n=n)
    for name in ("vertices", "uvs", "faces", "texture_gray"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.faces.shape == (2 * (n - 1) ** 2, 3) and t.texture_gray.shape == (512, 512)


def test_world_generate_and_camera():
    t, j = tsyn.SyntheticMeshWorld.generate(seed=0), jsyn.SyntheticMeshWorld.generate(seed=0)
    assert (t.fx, t.radius_x, t.radius_y, t.overlap) == (j.fx, j.radius_x, j.radius_y, j.overlap)
    assert len(t.mesh.faces) == 71442
    np.testing.assert_array_equal(t.camera_K(960, 540), j.camera_K(960, 540))
    assert t.near_far() == j.near_far() == (4.0, 45.0)


def test_pose_at_matches_reference():
    t = tsyn.SyntheticMeshWorld(mesh=None)
    j = jsyn.SyntheticMeshWorld(mesh=None)
    for i in [0, 1, 7, 8, 55, 260, 519, 600]:
        np.testing.assert_allclose(t.pose_at(i, 520), j.pose_at(i, 520), atol=POSE_ATOL, rtol=0)
        assert t.pose_at(i, 520).dtype == np.float32


def test_raycast_lands_on_the_terrain():
    """The ground-truth oracle: rays from a circuit pose land on the
    analytic height field, and the oracle equals the JAX package's copy."""
    from orbslam2_nmi_tpu.tools import fused_probe

    world = tsyn.SyntheticMeshWorld(mesh=None)
    T = world.pose_at(8, 520)
    rng = np.random.default_rng(0)
    px = np.concatenate([rng.uniform(0, 960, (50, 1)), rng.uniform(0, 540, (50, 1)),
                         np.ones((50, 1))], 1)
    dirs = px @ np.linalg.inv(world.camera_K(960, 540).astype(np.float64)).T @ T[:3, :3]
    o = -T[:3, :3].T.astype(np.float64) @ T[:3, 3]
    p = tsyn.raycast_terrain(o, dirs)
    np.testing.assert_array_equal(p, fused_probe.raycast_terrain(o, dirs))
    # 12 fixed-point iterations leave the slant rays short of convergence by
    # up to 2 mm (measured 1.9e-3 m here)
    np.testing.assert_allclose(p[:, 2], tsyn.terrain_height(p[:, 0], p[:, 1]), atol=5e-3)


def test_render_frames_raises_on_dropped_triangle(monkeypatch):
    """A tile list that overflows its capacity would punch holes in the
    ground truth: render_frames raises instead of rendering them."""
    world = tsyn.SyntheticMeshWorld(mesh=tsyn.terrain_mesh(n=60), fx=60.0)
    frame = world.render_frames([8], 520, 128, 48, device="cpu")
    assert frame.shape == (1, 48, 128) and frame.dtype == torch.uint8
    assert (frame > 0).float().mean() > 0.99  # the terrain fills the view
    monkeypatch.setattr(raster, "MAX_CAPACITY", 0)
    with pytest.raises(ValueError, match="dropped"):
        world.render_frames([8], 520, 128, 48, device="cpu")


def test_render_frames_match_one_render():
    """render_frames renders each frame at its own pose, as one
    render_mesh_grid call of its binning does."""
    world = tsyn.SyntheticMeshWorld(mesh=tsyn.terrain_mesh(n=60), fx=60.0)
    frames = world.render_frames([8, 9], 520, 128, 48, device="cpu")
    K = world.camera_K(128, 48)
    for k, i in enumerate([8, 9]):
        T = world.pose_at(i, 520)
        b = raster.bin_mesh(world.mesh, T, K, 48, 128, 4.0, 45.0, device="cpu")
        one = raster.render_mesh_grid(b, torch.from_numpy(T), K, torch.zeros(1, 3), 4.0, 45.0,
                                      out_u8=True)[0]
        assert torch.equal(frames[k], one)
    assert not torch.equal(frames[0], frames[1])



# --- the point world of the end-to-end tests, and the domain-gap tools -------

WORLD_POSE_ATOL = 1e-7


def test_point_world_generate_equal():
    t, j = tsyn.SyntheticWorld.generate(seed=3), jsyn.SyntheticWorld.generate(seed=3)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.gray, j.gray)
    assert t.fx == j.fx and t.points.dtype == np.float32
    np.testing.assert_array_equal(t.camera_K(320, 240), j.camera_K(320, 240))


def test_point_world_pose_at_matches_reference():
    """Rotations within 1e-7; translations (up to 12 m, -R t in float32)
    within 1e-7 relative, one float32 ulp (measured: 4.8e-7 m at 12 m)."""
    t, j = tsyn.SyntheticWorld.generate(seed=3), jsyn.SyntheticWorld.generate(seed=3)
    for i in range(0, 25, 3):
        a, b = t.pose_at(i, 25), j.pose_at(i, 25)
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=WORLD_POSE_ATOL, rtol=0)
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=WORLD_POSE_ATOL,
                                   rtol=WORLD_POSE_ATOL)
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("i", [0, 13])
def test_point_world_render_frame_equal(i):
    """The port's splat renders the JAX package's frames pixel for pixel at
    the end-to-end tests' 320x240."""
    t, j = tsyn.SyntheticWorld.generate(seed=3), jsyn.SyntheticWorld.generate(seed=3)
    a, b = t.render_frame(i, 25, 320, 240, device="cpu"), j.render_frame(i, 25, 320, 240)
    assert a.dtype == np.uint8 and a.shape == (240, 320)
    np.testing.assert_array_equal(a, b)


def test_wide_world_and_lit_mesh_equal():
    t, j = tsyn.SyntheticMeshWorld.generate_wide(seed=1, n_grid=40), \
        jsyn.SyntheticMeshWorld.generate_wide(seed=1, n_grid=40)
    assert (t.fx, t.radius_x, t.radius_y, t.overlap) == (j.fx, j.radius_x, j.radius_y, j.overlap)
    np.testing.assert_array_equal(t.mesh.texture_gray, j.mesh.texture_gray)
    lt, lj = t.lit_mesh(), j.lit_mesh()
    np.testing.assert_array_equal(lt.texture_gray, lj.texture_gray)
    np.testing.assert_array_equal(lt.vertices, t.mesh.vertices)
    assert not np.array_equal(lt.texture_gray, t.mesh.texture_gray)


def test_photometric_gap_equal():
    frames = np.random.default_rng(0).integers(0, 256, (3, 24, 32)).astype(np.uint8)
    a = tsyn.apply_photometric_gap(frames, seed=1)
    np.testing.assert_array_equal(a, jsyn.apply_photometric_gap(frames, seed=1))
    assert a.dtype == np.uint8 and not np.array_equal(a, frames)
    np.testing.assert_array_equal(tsyn._bilinear_resize(frames[0].astype(float), 7, 9),
                                  jsyn._bilinear_resize(frames[0].astype(float), 7, 9))


def test_synthetic_sequence_files(tmp_path):
    """io/datasets.make_synthetic_sequence writes the rendered frames as .npy
    files that the loader reads back."""
    from orbslam2_nmi_torch.io import datasets

    seq, world = datasets.make_synthetic_sequence(str(tmp_path), n_frames=2, seed=3,
                                                  device="cpu")
    assert len(seq) == 2 and np.allclose(seq.timestamps, [0.0, 1 / 30.0])
    got = [img for _, _, img in seq.frames()]
    np.testing.assert_array_equal(got[1], world.render_frame(1, 2, 320, 240, device="cpu"))
    (tmp_path / "eth").mkdir()
    (tmp_path / "eth" / "_times.txt").write_text("0.0\n0.1\n")
    eth = datasets.load_eth_sequence(str(tmp_path / "eth"), start_index=20513)
    assert [p.rsplit("/", 1)[1] for p in eth.image_paths] == ["20513.jpg", "20514.jpg"]
