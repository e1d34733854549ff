"""Parity of orbslam2_nmi_torch.ops.render (the point-splat renderer) with the
JAX package.

Bars, each measured on these inputs:
  * renders: equal pixel for pixel, against the reference's jitted
    `render_translation_grid` (which the localizer runs) and against its
    `render_pointcloud` both eager and jitted. Eager, the reference divides
    (z - near) by (far - near); compiled, it multiplies by the reciprocal,
    as the port does; the two quantized depths differ on about 7 % of points
    by one of 2^22 levels, and that moved no pixel on any input here.
  * `_min_pool` against `jax.lax.reduce_window` (the reference's min-pool):
    equal key for key, keys up to 2^30.
  * `mesh_to_points`: the same numpy operations and random draws, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device, make_world  # noqa: F401  (fixture)

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.io.model_loader import MeshModel as TMeshModel
from orbslam2_nmi_torch.ops import render as tr
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.io.model_loader import MeshModel
from orbslam2_nmi_tpu.ops import render as jr

H, W = 120, 160
K = np.array([[120.0, 0, 80.0], [0, 120.0, 60.0], [0, 0, 1]], np.float32)
NEAR, FAR = 1.0, 30.0


def _models(pts, gray):
    return (jr.RenderModel(points=jnp.asarray(pts), gray=jnp.asarray(gray)),
            convert.render_model_from_numpy(pts, gray, "cpu"))


def _pose(seed):
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.05)))
    T[:3, 3] = rng.normal(size=3).astype(np.float32) * 0.3
    return T


_jit_render = jax.jit(jr.render_pointcloud, static_argnums=(3, 4, 5, 6, 7))

SCENES = {
    # two points on one pixel area: the nearer (gray 50) must win
    "occlusion": (np.array([[0.0, 0.0, 10.0], [0.05, 0.05, 5.0]], np.float32),
                  np.array([200.0, 50.0], np.float32), np.eye(4, dtype=np.float32)),
    # a point behind the camera: nothing rendered
    "background": (np.array([[0.0, 0.0, -5.0]], np.float32), np.array([100.0], np.float32),
                   np.eye(4, dtype=np.float32)),
    "world": (*make_world(), _pose(1)),
}


@pytest.mark.parametrize("point_size", [1, 3])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_pointcloud_matches_reference(scene, point_size):
    pts, gray, T = SCENES[scene]
    jm, tm = _models(pts, gray)
    out = tr.render_pointcloud(tm, torch.from_numpy(T), K, H, W, NEAR, FAR, point_size).numpy()
    assert out.shape == (H, W) and out.dtype == np.float32
    eager = np.asarray(jr.render_pointcloud(jm, jnp.asarray(T), jnp.asarray(K), H, W, NEAR, FAR,
                                            point_size))
    compiled = np.asarray(_jit_render(jm, jnp.asarray(T), jnp.asarray(K), H, W, NEAR, FAR,
                                      point_size))
    np.testing.assert_array_equal(out, compiled)
    np.testing.assert_array_equal(out, eager)
    if scene == "occlusion":  # the near point lands on (61, 81), the far on (60, 80)
        assert out[60, 80] == (50.0 if point_size == 3 else 200.0) and out[61, 81] == 50.0
    elif scene == "background":
        assert (out == 0).all()
    else:
        assert 0.3 < (out > 0).mean() < 1.0


@pytest.mark.parametrize("point_size", [1, 2, 3])
def test_render_translation_grid_matches_reference(point_size):
    """The batched grid (one scatter over S x P points) against the
    reference's vmapped render, 125 candidates; and each candidate against the
    port's single render at its pose."""
    pts, gray = make_world(40000, seed=7)
    jm, tm = _models(pts, gray)
    T = _pose(2)
    offsets = np.array(jr.translation_grid_offsets((5, 5, 5), (0.3, 0.3, 0.3)))
    ref = np.asarray(jr.render_translation_grid(jm, jnp.asarray(T), jnp.asarray(K),
                                                jnp.asarray(offsets), H, W, NEAR, FAR,
                                                point_size))
    out = tr.render_translation_grid(tm, torch.from_numpy(T), K, torch.from_numpy(offsets),
                                     H, W, NEAR, FAR, point_size).numpy()
    assert out.shape == (125, H, W)
    np.testing.assert_array_equal(out, ref)
    for s in (0, 62, 124):
        Ts = T.copy()
        Ts[:3, 3] -= offsets[s]
        single = tr.render_pointcloud(tm, torch.from_numpy(Ts), K, H, W, NEAR, FAR, point_size)
        np.testing.assert_array_equal(out[s], single.numpy())


def test_render_translation_grid_moves_image():
    """Camera moved +1 m along x: the scene shifts by about fx * dx / depth =
    8 px (tests/test_nmi.py:256-274)."""
    _, tm = _models(*make_world())
    offsets = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    imgs = tr.render_translation_grid(tm, torch.eye(4), K, offsets, H, W, NEAR, FAR, 3).numpy()
    a, b = imgs[0], imgs[1]
    corr = [np.corrcoef(a[:, 20:-20].ravel(), np.roll(b, lag, axis=1)[:, 20:-20].ravel())[0, 1]
            for lag in range(-12, 13)]
    assert abs(int(np.argmax(corr)) - 12 - 8.0) < 3


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5])
def test_min_pool_matches_reduce_window(size):
    rng = np.random.default_rng(size)
    keys = rng.integers(0, 2**30, (2, 17, 23), dtype=np.int64).astype(np.int32)
    keys[rng.random(keys.shape) < 0.5] = 2**30  # empty pixels
    keys[0, 0, 0] = 2**30 - 1
    keys[1, -1, -1] = 2**24 + 1  # not representable in f32
    ref = np.stack([np.asarray(jr._min_pool(jnp.asarray(k), size)) for k in keys])
    out = tr._min_pool(torch.from_numpy(keys), size).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


def _triangle():
    return (np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32),
            np.array([[0, 0], [1, 0], [0, 1]], np.float32), np.array([[0, 1, 2]], np.int32),
            np.full((4, 4), 99.0, np.float32))


@pytest.mark.parametrize("case", ["triangle", "toy_mesh", "capped"])
def test_mesh_to_points_bit_for_bit(case):
    if case == "triangle":
        arrays, kw = _triangle(), dict(samples_per_unit_area=100.0)
    else:
        m = tentry._toy_mesh(n=24)
        arrays = (m.vertices, m.uvs, m.faces, m.texture_gray)
        # "capped": over max_points, so the per-face counts are scaled down
        kw = dict(seed=3) if case == "toy_mesh" else dict(max_points=20_000, seed=5)
    ref = jr.mesh_to_points(MeshModel(*arrays), **kw)
    out = tr.mesh_to_points(TMeshModel(*arrays), **kw)
    assert out.points.dtype == np.float32 and out.gray.dtype == np.float32
    np.testing.assert_array_equal(out.points, ref.points)
    np.testing.assert_array_equal(out.gray, ref.gray)
    if case == "triangle":
        assert len(out.points) > 100 and (out.gray == 99.0).all()
    if case == "capped":
        assert len(out.points) <= 20_000 + len(arrays[2])


@pytest.mark.gpu
@pytest.mark.parametrize("point_size", [1, 3])
def test_render_translation_grid_on_card_matches_cpu(cuda_device, point_size, record_property):
    """The splat on the card against the CPU: the projection's products are
    rounded by other libraries there (cuBLAS for the rotation), which could
    move a point across a pixel or depth-quantum edge. On an H100 (80GB
    HBM3, 700 W) no pixel differed at either point size (recorded as the
    `pixel_mismatch` property), so the bar is 1e-4 of the pixels (51 of the
    27 renders' 518,400)."""
    pts, gray = make_world(40000, seed=7)
    T = _pose(2)
    offsets = torch.from_numpy(np.array(jr.translation_grid_offsets((3, 3, 3), (0.3,) * 3)))
    outs = []
    for dev in (cuda_device, "cpu"):
        m = convert.render_model_from_numpy(pts, gray, dev)
        outs.append(tr.render_translation_grid(m, torch.from_numpy(T), K, offsets, H, W, NEAR,
                                               FAR, point_size).cpu().numpy())
    record_property("pixel_mismatch", float((outs[0] != outs[1]).mean()))
    assert (outs[0] != outs[1]).mean() <= 1e-4
