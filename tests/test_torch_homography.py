"""Parity of orbslam2_nmi_torch.ops.homography (and the grid offsets of
ops.render) with the JAX package.

Tolerances, as measured at tests/test_nmi.py:437-451's sizes (96x128 random
image, 27 rotations of 0.02/0.02/0.04 rad, fx = 150):
  * angles and translation offsets: equal;
  * homographies: within 1e-6 of the largest entry (measured 3.8e-6 on
    entries up to ~100; f32 products and K^-1 rounded in another order);
  * warps, given the same homographies: mean |diff| 2.2e-4 and max 0.0076
    gray-levels for both the exact and the two-pass warp. The bars are mean
    < 1e-3 and max < 0.5, the latter allowed to fail on at most 0.1 % of
    pixels, where a source coordinate lies so close to an integer that its
    floor() flips between the two packages (none did at this size);
  * the roll bank of the two-pass warp's 1-D resample equals the port's
    gather exactly, wrap-around taps included;
  * `warp_plan` is `homographies_from_angles` and `shift_bounds_for_angles`
    bit for bit, and every warp of the port (the localizer's sweep, the
    entry's grid step, the sharded search) takes its plan from it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import run_ranks, sharding_mesh_problem, warp_plan_calls_rank

from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.geometry import se3 as tse3
from orbslam2_nmi_torch.ops import homography as th
from orbslam2_nmi_torch.ops import render as trender
from orbslam2_nmi_torch.slam.nmi import search_kernel as tsk
from orbslam2_nmi_tpu.config import CameraConfig
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.ops import homography as jh
from orbslam2_nmi_tpu.ops import render as jrender

K = CameraConfig(fx=150, fy=150, cx=64, cy=48).K
GRID = ((3, 3, 3), (0.02, 0.02, 0.04))


def _img(h=96, w=128, seed=11):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def _assert_warp_close(ref, out):
    d = np.abs(np.asarray(ref) - np.asarray(out))
    assert d.mean() < 1e-3, d.mean()
    assert (d >= 0.5).mean() <= 1e-3, (d >= 0.5).mean()


@pytest.mark.parametrize("num,step", [GRID, ((3, 1, 2), (0.5, 0.0, 0.1)), ((1, 1, 1), (1, 1, 1))])
def test_grid_angles_and_offsets_equal(num, step):
    np.testing.assert_array_equal(
        th.rotation_grid_angles(num, step, device="cpu").numpy(),
        np.asarray(jh.rotation_grid_angles(num, step)))
    np.testing.assert_array_equal(
        trender.translation_grid_offsets(num, step, device="cpu").numpy(),
        np.asarray(jrender.translation_grid_offsets(num, step)))


def test_hat_and_so3_exp_match():
    """Batched over ordinary, small (Taylor branch) and zero rotation vectors;
    f32 on both sides, held to 1e-6."""
    rng = np.random.default_rng(2)
    w = np.concatenate([rng.normal(0, 1.0, (8, 3)), rng.normal(0, 1e-5, (4, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_array_equal(tse3.hat(torch.from_numpy(w)).numpy(),
                                  np.asarray(jse3.hat(jnp.asarray(w))))
    np.testing.assert_allclose(tse3.so3_exp(torch.from_numpy(w)).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(w))), atol=1e-6)


def test_homographies_match():
    ang = np.array(jh.rotation_grid_angles(*GRID))
    ref = np.asarray(jh.homographies_from_angles(jnp.asarray(K), jnp.asarray(ang)))
    out = th.homographies_from_angles(torch.from_numpy(K), torch.from_numpy(ang)).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("warp", ["bilinear", "two_pass"])
def test_warps_match_given_the_same_homographies(warp):
    img = _img()
    ang = np.asarray(jh.rotation_grid_angles(*GRID))
    Hs = np.array(jh.homographies_from_angles(jnp.asarray(K), jnp.asarray(ang)))
    if warp == "bilinear":
        ref = jh._warp_grid_gather_jit(jnp.asarray(img), jnp.asarray(Hs))
        out = th.warp_bilinear(torch.from_numpy(img), torch.from_numpy(Hs))
    else:
        bound = jh.shift_bounds_for_angles(K, ang, *img.shape)
        ref = jh._warp_grid_two_pass_jit(jnp.asarray(img), jnp.asarray(Hs), bound)
        out = th.warp_two_pass(torch.from_numpy(img), torch.from_numpy(Hs), bound)
    assert out.shape == (27, 96, 128)
    _assert_warp_close(ref, out.numpy())


@pytest.mark.parametrize("axis", [0, 1])
def test_shift_resample_gather_equals_roll_bank(axis):
    """For every pixel the reference's bank of rolls is a 1-D bilinear lookup
    at (i + k0) mod n and (i + k0 + 1) mod n, each tap zeroed outside
    [k_min, k_max]; the port's gather gives the same values and mask, bit for
    bit, including pixels whose taps wrap around the image edge."""
    rng = np.random.default_rng(5)
    img = _img(40, 56)
    n = img.shape[axis]
    src = rng.uniform(-12, n + 11, img.shape).astype(np.float32)
    src[::7] = np.floor(src[::7])  # exact integers: weight-0 second taps
    ref_v, ref_ok = jh._shift_resample(jnp.asarray(img), jnp.asarray(src), axis, -8, 8)
    out_v, out_ok = th._shift_resample(
        torch.from_numpy(img)[None], torch.from_numpy(src)[None], axis + 1, -8, 8)
    np.testing.assert_array_equal(out_v[0].numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(out_ok[0].numpy(), np.asarray(ref_ok))
    i = np.arange(n)[:, None] if axis == 0 else np.arange(n)[None, :]
    k0 = np.floor(src - i)
    wraps = ((i + k0 < 0) | (i + k0 + 1 > n - 1)) & (np.abs(k0) <= 8)
    assert wraps.sum() > 20  # the wrap-around taps were exercised


@pytest.mark.parametrize("grid", [GRID, ((3, 1, 1), (0.8, 0.0, 0.0))])
def test_warp_rotation_grid_same_path_and_images(grid):
    """Small grids take the two-pass warp, large ones the exact warp, in both
    packages, and the images agree."""
    img = _img()
    ang = np.array(jh.rotation_grid_angles(*grid))
    bound = jh.shift_bounds_for_angles(K, ang, *img.shape)
    assert th.shift_bounds_for_angles(K, ang, *img.shape) == bound
    ref = jh.warp_rotation_grid(jnp.asarray(img), jnp.asarray(K), jnp.asarray(ang))
    out = th.warp_rotation_grid(torch.from_numpy(img), K, torch.from_numpy(ang))
    Hs = np.array(jh.homographies_from_angles(jnp.asarray(K), jnp.asarray(ang)))
    if max(bound) <= 64:
        same_path = jh._warp_grid_two_pass_jit(jnp.asarray(img), jnp.asarray(Hs), bound)
    else:
        same_path = jh._warp_grid_gather_jit(jnp.asarray(img), jnp.asarray(Hs))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(same_path))
    _assert_warp_close(ref, out.numpy())


def test_identity_warp_preserves_image():
    img = _img(48, 64)
    Kc = CameraConfig(fx=100, fy=100, cx=32, cy=24).K
    out = th.warp_rotation_grid(torch.from_numpy(img), Kc, np.zeros((1, 3), np.float32))
    np.testing.assert_allclose(out[0].numpy(), img, atol=1e-2)


ETH = tsk.SearchKernel()  # the ETH_small grid: 3^3 rotations of (0.02, 0.02, 0.05) rad
PLAN_GRIDS = {
    "eth": ETH,
    "drift_collapsed": tsk.initial_kernel_for_drift(ETH, (1.0, 0.5, 0.001), (0.5, 0.0, 0.02)),
    "init": tsk.initial_kernel_for_init(ETH),
    "gather": tsk.SearchKernel(num_warp=(3, 1, 1), step_warp=(0.8, 0.0, 0.0)),
}


def _assert_same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("grid", sorted(PLAN_GRIDS))
def test_warp_plan_is_the_builders(grid):
    """The plan holds `homographies_from_angles` and `shift_bounds_for_angles`
    of the host angles bit for bit, and `warp_rotation_grid` is the warp its
    bound picks, bit for bit. The drift grid has collapsed axes, the last
    grid's bound is over MAX_TWO_PASS_SHIFT and takes the gather."""
    kernel = PLAN_GRIDS[grid]
    ang, img = kernel.angles(), torch.from_numpy(_img())
    plan = th.warp_plan(K, ang, *img.shape, "cpu")
    Hs = th.homographies_from_angles(torch.from_numpy(K), torch.from_numpy(ang))
    bound = th.shift_bounds_for_angles(K, ang, *img.shape)
    _assert_same_bits(plan.homographies, Hs)
    assert plan.bound == bound
    assert (max(bound) > th.MAX_TWO_PASS_SHIFT) == (grid == "gather")
    want = th.warp_bilinear(img, Hs) if grid == "gather" else th.warp_two_pass(img, Hs, bound)
    _assert_same_bits(th.warp_rotation_grid(img, K, ang), want)


@pytest.mark.parametrize("caller", ["warp_sweep", "grid_step", "sharded_one_rank"])
def test_every_warp_takes_its_plan_from_warp_plan(caller, monkeypatch):
    """Two warps each: the localizer's `warp_sweep` and the sharded search
    build one plan a warp, the entry's grid step one for its life."""
    if caller == "sharded_one_rank":  # counted inside the spawned rank
        assert run_ranks(warp_plan_calls_rank, 1, sharding_mesh_problem(), 2) == [2]
        return
    calls = []
    build = th.warp_plan
    monkeypatch.setattr(th, "warp_plan", lambda *a: calls.append(a) or build(*a))
    if caller == "warp_sweep":
        loc, frame, T = tentry.localizer_entry(device="cpu", height=32, width=64)
        sweep = loc.prepare_sweep(frame, T, loc.initial_kernel)
        warps = [loc.warp_sweep(sweep) for _ in range(2)]
    else:
        fn, (frame, _) = tentry.entry(device="cpu", height=32, width=64)
        warps = [fn.warp(frame) for _ in range(2)]
    assert len(calls) == (2 if caller == "warp_sweep" else 1)
    _assert_same_bits(warps[0], warps[1])
