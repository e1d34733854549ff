"""Parity of the port's NMI localizer (orbslam2_nmi_torch/slam/nmi/) with the
JAX package.

Bars, each measured on these inputs:
  * the search kernel's logic (a copy): equal, field for field;
  * pose math on the host (`geometry/se3.py`'s SE(3) functions and
    `euler_zyx`, `_apply_best_cell`) and the coarse passes'
    `_box_pool`: within 1e-6;
  * one grid on the mesh path, 48x256, 3 renders x 1 warp, against the JAX
    localizer with `force_mesh_raster=True` (its Pallas rasterizer in
    interpret mode): within test_torch_entry's whole-step bar of 8.1e-4, the
    renders differing where a UV quantum flips (test_torch_raster);
  * the whole strategy on a point model, 60x80, two iterations: the same
    iterations, best cells of every sweep and acceptance, Tcw and the poses
    before each sweep within 1e-5, the score within 1e-4 (measured: poses
    equal, scores within 1.2e-7; the reference's histograms are f32
    scatter-adds, the port's exact counts).
The state crosses over as numpy arrays and config dicts (`convert`).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import (MESH_CAMERA, cuda_device, height_field_mesh,  # noqa: F401
                                 make_world, mesh_frame)

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.geometry import se3 as tse3
from orbslam2_nmi_torch.io.model_loader import MeshModel as TMeshModel
from orbslam2_nmi_torch.ops import raster as traster
from orbslam2_nmi_torch.ops import render as trender
from orbslam2_nmi_torch.slam.nmi import localizer as tloc
from orbslam2_nmi_torch.slam.nmi import search_kernel as tsk
from orbslam2_nmi_tpu.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.io.model_loader import MeshModel
from orbslam2_nmi_tpu.ops import render as jrender
from orbslam2_nmi_tpu.slam.nmi import localizer as jloc
from orbslam2_nmi_tpu.slam.nmi import search_kernel as jsk

POSE_ATOL = 1e-6
MESH_GRID_ATOL = 8.1e-4
STRATEGY_POSE_ATOL = 1e-5
STRATEGY_NMI_ATOL = 1e-4

# --------------------------------------------------------------- search kernel

SK_CASES = {
    "resized_halves_non_peripheral":
        lambda m: m.SearchKernel(best_synth=(1, 1, 1), best_warp=(0, 1, 2)).resized(),
    "resized_keeps_peripheral":
        lambda m: m.SearchKernel(num_synth=(5, 3, 1), best_synth=(4, 0, 0),
                                 best_warp=(2, 1, 0)).resized(),
    "resized_collapses_below_min":
        lambda m: m.SearchKernel(step_synth=(0.008, 0.2, 0.0101), step_warp=(0.0015, 0.02, 0.05),
                                 best_synth=(1, 1, 1), best_warp=(1, 1, 1)).resized(),
    "is_middle":
        lambda m: [m.SearchKernel(num_synth=n, best_synth=b, best_warp=w).is_middle()
                   for n in ((3, 3, 3), (5, 1, 3)) for b in ((1, 1, 1), (2, 0, 1), (0, 1, 1))
                   for w in ((1, 1, 1), (1, 2, 1))],
    "with_best_from_flat":
        lambda m: [m.SearchKernel(num_synth=(5, 3, 2), num_warp=(3, 1, 3))
                   .with_best_from_flat(s, r, 0.25 * s + r) for s in range(30) for r in range(9)],
    "drift_sizing":
        lambda m: [m.initial_kernel_for_drift(m.SearchKernel(), d, r, f)
                   for d, r, f in (((1.0, 0.5, 0.001), (0.5, 0.0, 0.0), 0.02),
                                   ((1e-4,) * 3, (1.5,) * 3, 0.02),
                                   ((15.0, 0.2, 7.0), (0.04, 0.06, 1.0), 0.03))],
    "init_sizing":
        lambda m: m.initial_kernel_for_init(m.SearchKernel(num_warp=(3, 1, 3),
                                                           step_synth=(0.1, 0.2, 0.3))),
    "adaptive_threshold":
        lambda m: [m.adaptive_threshold(t, d) for t in (0.1, 0.3)
                   for d in (0.0, 2.0, 4.999, 5.0, 7.5, 10.0, 100.0)],
}


def _plain(x):
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("case", sorted(SK_CASES))
def test_search_kernel_matches_reference(case):
    assert _plain(SK_CASES[case](tsk)) == _plain(SK_CASES[case](jsk))


@pytest.mark.parametrize("num_synth, num_warp", [((3, 3, 3), (3, 3, 3)), ((5, 5, 5), (3, 1, 3)),
                                                 ((1, 1, 1), (3, 3, 3))])
def test_best_flat_inverts_with_best_from_flat(num_synth, num_warp):
    """On every cell, `best_flat()` gives back the flat indices that
    `with_best_from_flat` decoded, and `best_cell()` is that row of
    `offsets()` and `angles()`, bit for bit."""
    kernel = tsk.SearchKernel(num_synth=num_synth, num_warp=num_warp,
                              step_synth=(0.3, 0.2, 0.5), step_warp=(0.02, 0.03, 0.05))
    offsets, angles = kernel.offsets(), kernel.angles()
    assert offsets.shape == (kernel.n_synth, 3) and angles.shape == (kernel.n_warp, 3)
    for s in range(kernel.n_synth):
        for r in range(kernel.n_warp):
            best = kernel.with_best_from_flat(s, r, 0.5)
            assert best.best_flat() == (s, r)
            off, ang = best.best_cell()
            np.testing.assert_array_equal(off.view(np.uint32), offsets[s].view(np.uint32))
            np.testing.assert_array_equal(ang.view(np.uint32), angles[r].view(np.uint32))


# --------------------------------------------------------------------- pose math


def _cfg(**kw):
    grid = NMIGridConfig(synth_num=kw.pop("synth_num", (3, 3, 3)),
                         warp_num=kw.pop("warp_num", (3, 3, 3)),
                         synth_step=kw.pop("synth_step", (0.3, 0.3, 0.3)),
                         warp_step=(0.03, 0.03, 0.03))
    return NMIConfig(grid=grid, **{"render_near": 1.0, "render_far": 30.0, **kw})


def _port_loc(cfg, cam, model=None, mesh=None, device="cpu", log_fn=None):
    """The port's localizer on the reference's configuration and state."""
    return tloc.NMILocalizer(
        convert.nmi_config_from_dict(dataclasses.asdict(cfg)),
        convert.camera_config_from_dict(dataclasses.asdict(cam)),
        None if model is None else convert.render_model_from_numpy(*model, "cpu"),
        log_fn=log_fn, mesh=None if mesh is None else TMeshModel(*mesh), device=device)


def _pose(seed):
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = tse3.euler_zyx(torch.from_numpy(
        rng.normal(size=3).astype(np.float32) * 0.2)).numpy()
    T[:3, 3] = rng.normal(size=3).astype(np.float32) * 2.0
    return T


@pytest.mark.parametrize("fn", ["se3", "euler_zyx_matrix", "box_pool", "apply_best_cell"])
def test_pose_math_matches_reference(fn):
    rng = np.random.default_rng(4)
    if fn == "se3":
        Ts = np.stack([_pose(i) for i in range(6)])
        pts = rng.normal(size=(6, 50, 3)).astype(np.float32) * 10
        for name, args in (("make_se3", (Ts[:, :3, :3], Ts[:, :3, 3])), ("se3_inverse", (Ts,)),
                           ("se3_apply", (Ts[:, None], pts)), ("se3_compose", (Ts, Ts[::-1]))):
            out = getattr(tse3, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
            ref = getattr(jse3, name)(*(jnp.asarray(a) for a in args))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(  # T^-1 T = I
            tse3.se3_compose(tse3.se3_inverse(torch.from_numpy(Ts)), torch.from_numpy(Ts)).numpy(),
            np.broadcast_to(np.eye(4, dtype=np.float32), Ts.shape), atol=POSE_ATOL)
    elif fn == "euler_zyx_matrix":
        for a in rng.normal(size=(8, 3)).astype(np.float32) * 0.3:
            np.testing.assert_allclose(tse3.euler_zyx(torch.from_numpy(a)).numpy(),
                                       np.asarray(jloc._euler_zyx_matrix(jnp.asarray(a))),
                                       atol=POSE_ATOL, rtol=0)
    elif fn == "box_pool":
        img = rng.uniform(0, 255, (61, 83)).astype(np.float32)
        for scale in (1, 2, 3):
            out = tloc._box_pool(torch.from_numpy(img), scale).numpy()
            np.testing.assert_allclose(out, np.asarray(jloc._box_pool(jnp.asarray(img), scale)),
                                       atol=POSE_ATOL, rtol=0)
    else:
        cam = CameraConfig(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)
        pts, gray = make_world(10)
        cfg = _cfg()
        ref = jloc.NMILocalizer(cfg, cam, jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray)))
        port = _port_loc(cfg, cam, model=(pts, gray))
        for i, (ns, nw) in enumerate((((3, 3, 3), (3, 3, 3)), ((5, 5, 5), (3, 1, 3)),
                                      ((1, 1, 1), (3, 3, 3)))):
            n_s, n_w = int(np.prod(ns)), int(np.prod(nw))
            for s, r in ((0, 0), (n_s - 1, n_w - 1), (n_s // 3, n_w // 2)):
                kw = dict(num_synth=ns, num_warp=nw, step_synth=(0.3, 0.2, 0.5),
                          step_warp=(0.02, 0.03, 0.05))
                jk = jsk.SearchKernel(**kw).with_best_from_flat(s, r, 0.5)
                tk = tsk.SearchKernel(**kw).with_best_from_flat(s, r, 0.5)
                T = _pose(i)
                np.testing.assert_allclose(port._apply_best_cell(T, tk),
                                           ref._apply_best_cell(T, jk), atol=POSE_ATOL, rtol=0)


# ------------------------------------------------------------- the mesh grid


MESH_CAM = CameraConfig(**MESH_CAMERA)


@pytest.mark.parametrize("frame_x", [0.3, 0.4])
def test_evaluate_grid_mesh_path_matches_reference(frame_x):
    """The frame is the port's render at I, the grid centered at x = frame_x:
    at 0.3 no candidate renders the frame's pose (measured max |diff| 4.8e-5);
    at 0.4 candidate 2 does, and there the port's render equals the frame
    (score 1) while the reference's differs where a UV quantum flips
    (measured 0.999001), so that cell is held to 1.1e-3."""
    mesh = height_field_mesh()
    cfg = _cfg(synth_num=(3, 1, 1), warp_num=(1, 1, 1), synth_step=(0.4, 0.4, 0.4),
               render_far=50.0, threshold=0.05, max_iteration_count=2)
    ref = jloc.NMILocalizer(cfg, MESH_CAM, None, mesh=MeshModel(*mesh), force_mesh_raster=True)
    assert ref.mesh is not None
    port = _port_loc(cfg, MESH_CAM, mesh=mesh)
    frame = mesh_frame(mesh)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = frame_x
    want = ref.evaluate_grid(jnp.asarray(frame.numpy()), T, ref.initial_kernel)
    got = port.evaluate_grid(frame, T, port.initial_kernel)
    assert got.shape == want.shape == (3, 1) and got.dtype == np.float32
    exact = frame_x == 0.4
    np.testing.assert_allclose(got[:2 if exact else 3], want[:2 if exact else 3],
                               atol=MESH_GRID_ATOL, rtol=0)
    if exact:
        assert got[2, 0] == 1.0 and abs(want[2, 0] - 1.0) <= 1.1e-3
    assert int(got.argmax()) == int(want.argmax()) == 2


# ----------------------------------------------------------- the whole strategy

STRAT_CAM = CameraConfig(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)


def _strategy_case(case):
    """(cfg, Tcw, kwargs) of one strategy case on the 60x80 point world."""
    cfg = _cfg(threshold=0.3, max_iteration_count=2,
               coarse_scale=2 if case == "coarse" else 1)
    T = np.eye(4, dtype=np.float32)
    kw = {}
    if case in ("translation", "coarse"):
        T[0, 3] += 0.3  # one grid step
    else:  # a one-step rotation about y, with the drift sizing of a rotation-only kernel
        T[:3, :3] = tse3.euler_zyx(torch.tensor([0.0, 0.03, 0.0])).numpy()
        kw = dict(dist_since=(1e-4,) * 3, rot_since=(1.5,) * 3)
    return cfg, T, kw


_CELLS = re.compile(r"best_s=\(.*?\) best_w=\(.*?\)")


@pytest.mark.parametrize("case", ["translation", "rotation", "coarse"])
def test_strategy_point_model_matches_reference(case):
    pts, gray = make_world(40000, seed=7)
    jmodel = jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray))
    cfg, T, kw = _strategy_case(case)
    frame = np.asarray(jrender.render_pointcloud(jmodel, jnp.eye(4), jnp.asarray(STRAT_CAM.K),
                                                 60, 80, 1.0, 30.0, 3))
    logs_j, logs_t = [], []
    ref = jloc.NMILocalizer(cfg, STRAT_CAM, jmodel, log_fn=logs_j.append)
    port = _port_loc(cfg, STRAT_CAM, model=(pts, gray), log_fn=logs_t.append)
    want = ref.relocalize_strategy(jnp.asarray(frame), T, **kw)
    got = port.relocalize_strategy(torch.from_numpy(frame), T, **kw)
    assert got.iterations == want.iterations
    cells = [_CELLS.findall(line) for line in logs_t]
    assert cells == [_CELLS.findall(line) for line in logs_j] and any(cells)
    assert (got.relocalized, got.failed) == (want.relocalized, want.failed) == (True, False)
    assert (got.num_synth, got.num_warp) == (want.num_synth, want.num_warp)
    np.testing.assert_allclose(got.Tcw, want.Tcw, atol=STRATEGY_POSE_ATOL, rtol=0)
    assert abs(got.nmi - want.nmi) <= STRATEGY_NMI_ATOL
    assert len(got.previous_poses) == len(want.previous_poses)
    for a, b in zip(got.previous_poses, want.previous_poses):
        np.testing.assert_allclose(a, b, atol=STRATEGY_POSE_ATOL, rtol=0)
    assert np.abs(got.Tcw[:3, 3]).max() < 1e-5  # snapped back to T_true = I


# ----------------------------------------------------------- debug overlays

_OVERLAY = re.compile(r"(\d{4})_(best|middle)_s(\d+)_r(\d+)_nmi(-?[\d.]+)\.png")


def _overlays(d):
    """[(seq, tag, s, r, nmi)] of the overlay files in d (PNG, or .npy
    where PIL is absent), and the arrays."""
    out, imgs = [], []
    for p in sorted(d.iterdir()):
        m = _OVERLAY.fullmatch(p.name.removesuffix(".npy"))
        assert m, p.name
        out.append((*m.groups()[:2], int(m[3]), int(m[4]), float(m[5])))
        if p.suffix == ".npy":
            imgs.append(np.load(p))
        else:
            from PIL import Image

            imgs.append(np.asarray(Image.open(p)))
    return out, imgs


@pytest.mark.parametrize("case", ["point", "mesh"])
def test_debug_overlays_match_reference(case, tmp_path):
    """With `debug_dir` set, each grid evaluation writes its best and middle
    cell's overlay (red: the warped frame, green: the render), named by the
    grid cell: the point model's whole strategy (test_strategy_point_model's
    translation case) and one mesh grid (test_evaluate_grid_mesh_path's at
    x = 0.3, Pallas in interpret mode). The names carry the same sequence,
    cells (s, r) and tags in both packages, the scores within the grid's
    bar (printed to 4 decimals), and the images have the camera's shape."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    if case == "point":
        pts, gray = make_world(40000, seed=7)
        jmodel = jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray))
        cfg, T, kw = _strategy_case("translation")
        frame = np.array(jrender.render_pointcloud(
            jmodel, jnp.eye(4), jnp.asarray(STRAT_CAM.K), 60, 80, 1.0, 30.0, 3))
        ref = jloc.NMILocalizer(cfg, STRAT_CAM, jmodel)
        port = _port_loc(cfg, STRAT_CAM, model=(pts, gray))
        ref.debug_dir, port.debug_dir = str(tmp_path / "j"), str(tmp_path / "t")
        ref.relocalize_strategy(jnp.asarray(frame), T, **kw)
        port.relocalize_strategy(torch.from_numpy(frame), T, **kw)
        shape, atol = (60, 80, 3), STRATEGY_NMI_ATOL
    else:
        mesh = height_field_mesh()
        cfg = _cfg(synth_num=(3, 1, 1), warp_num=(1, 1, 1), synth_step=(0.4, 0.4, 0.4),
                   render_far=50.0, threshold=0.05, max_iteration_count=2)
        ref = jloc.NMILocalizer(cfg, MESH_CAM, None, mesh=MeshModel(*mesh),
                                force_mesh_raster=True)
        port = _port_loc(cfg, MESH_CAM, mesh=mesh)
        ref.debug_dir, port.debug_dir = str(tmp_path / "j"), str(tmp_path / "t")
        frame = mesh_frame(mesh)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.3
        ref.relocalize_once(jnp.asarray(frame.numpy()), T, ref.initial_kernel)
        port.relocalize_once(frame, T, port.initial_kernel)
        shape, atol = (48, 256, 3), MESH_GRID_ATOL
    got, imgs = _overlays(tmp_path / "t")
    want, _ = _overlays(tmp_path / "j")
    assert [g[:4] for g in got] == [w[:4] for w in want] and len(got) >= 2
    assert [g[1] for g in got[:2]] == ["best", "middle"]
    for g, w in zip(got, want):
        assert abs(g[4] - w[4]) <= atol + 1e-4, (g, w)
    for img in imgs:
        assert img.shape == shape and img.dtype == np.uint8 and not img[..., 2].any()
        assert img[..., 0].any() and img[..., 1].any()


# ----------------------------------------------------------------- contracts


def test_localizer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = CameraConfig(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)
    with pytest.raises(RuntimeError, match="CUDA"):
        _port_loc(_cfg(), cam, model=make_world(10), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.localizer_entry()


def test_profile_tool_refuses_without_cuda(monkeypatch, capsys):
    from orbslam2_nmi_torch.tools import profile_localizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_localizer.main() == 1
    assert "CUDA is not available" in capsys.readouterr().err


def _point_grid(n_bins):
    """One point-model grid of `test_localizer_rejects_other_bin_counts`:
    (the port's scores, the JAX localizer's)."""
    pts, gray = make_world(40000, seed=7)
    cfg = _cfg(n_bins=n_bins, warp_num=(1, 1, 1))
    jmodel = jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray))
    frame = np.asarray(jrender.render_pointcloud(
        jmodel, jnp.eye(4), jnp.asarray(STRAT_CAM.K), 60, 80, 1.0, 30.0, 3))
    ref = jloc.NMILocalizer(cfg, STRAT_CAM, jmodel)
    port = _port_loc(cfg, STRAT_CAM, model=(pts, gray))
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.3
    return (port.evaluate_grid(torch.from_numpy(frame), T, port.initial_kernel),
            np.asarray(ref.evaluate_grid(jnp.asarray(frame), T, ref.initial_kernel)))


@pytest.mark.parametrize("n_bins", [2, 64, 128, 256, 512])
def test_localizer_rejects_other_bin_counts(n_bins):
    """`NMIConfig.n_bins` reaches the scores: one point-model grid (60x80,
    27 renders x the identity warp, grays in [28, 228], so that fewer bins
    clamp most of them) equals the JAX localizer's within the strategy's
    score bar. At 512 bins the port packs the levels in one byte, clamped at
    255; on renders and frames in [0, 255] the reference's clip at 511 moves
    no level either. The identity warp keeps the warps' parity gap (0.0076
    gray levels, which moves pixels across bin edges) out of this test."""
    got, want = _point_grid(n_bins)
    np.testing.assert_allclose(got, want, atol=STRATEGY_NMI_ATOL, rtol=0)
    assert int(got.argmax()) == int(want.argmax())


def test_localizer_512_bins_scores_like_256():
    """A localizer built with 512 bins scores a sweep as one built with 256,
    bit for bit: the levels of its [0, 255] renders and frame fit one byte
    either way (fault C8: the port raised here, the reference scores)."""
    np.testing.assert_array_equal(_point_grid(512)[0], _point_grid(256)[0])


@pytest.mark.parametrize("case", ["point_grid", "mesh_strategy"])
def test_image_scale_matches_reference(case):
    """`image_scale=2`: the camera's height, width and K[:2] halved, the
    splat's point size with them. One point-model grid (40x30 of the 80x60
    camera, point size 2) within the strategy's score bar, and one mesh
    strategy (128x24 of the 256x48 camera, the JAX localizer's Pallas
    rasterizer in interpret mode) with the same iterations, cells and pose
    within the mesh grid's score bar. The point grid's 27 warps carry the
    warps' parity gap, which weighs more on 1,200 pixels: held to the mesh
    grid's bar (the whole step's, test_torch_entry; measured 3.2e-4)."""
    if case == "point_grid":
        pts, gray = make_world(40000, seed=7)
        jmodel = jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray))
        K2 = STRAT_CAM.K.copy()
        K2[:2] /= 2
        frame = np.asarray(jrender.render_pointcloud(jmodel, jnp.eye(4), jnp.asarray(K2), 30, 40,
                                                     1.0, 30.0, 2))
        cfg = _cfg()
        ref = jloc.NMILocalizer(cfg, STRAT_CAM, jmodel, image_scale=2)
        port = tloc.NMILocalizer(convert.nmi_config_from_dict(dataclasses.asdict(cfg)),
                                 convert.camera_config_from_dict(dataclasses.asdict(STRAT_CAM)),
                                 convert.render_model_from_numpy(pts, gray, "cpu"),
                                 image_scale=2, device="cpu")
        assert (port.height, port.width) == (ref.height, ref.width) == (30, 40)
        np.testing.assert_array_equal(port.K, np.asarray(ref.K))
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.3
        want = ref.evaluate_grid(jnp.asarray(frame), T, ref.initial_kernel)
        got = port.evaluate_grid(torch.from_numpy(frame), T, port.initial_kernel)
        np.testing.assert_allclose(got, want, atol=MESH_GRID_ATOL, rtol=0)
        assert int(got.argmax()) == int(want.argmax())
        return
    mesh = height_field_mesh()
    cfg = _cfg(synth_num=(3, 1, 1), warp_num=(1, 1, 1), synth_step=(0.4, 0.4, 0.4),
               render_far=50.0, threshold=0.05, max_iteration_count=2)
    ref = jloc.NMILocalizer(cfg, MESH_CAM, None, mesh=MeshModel(*mesh), force_mesh_raster=True,
                            image_scale=2)
    port = tloc.NMILocalizer(convert.nmi_config_from_dict(dataclasses.asdict(cfg)),
                             convert.camera_config_from_dict(dataclasses.asdict(MESH_CAM)),
                             None, mesh=TMeshModel(*mesh), image_scale=2, device="cpu")
    b = traster.bin_mesh(TMeshModel(*mesh), np.eye(4, dtype=np.float32), port.K, 24, 128, 1.0,
                         50.0, device="cpu")
    frame = traster.render_mesh_grid(b, torch.eye(4), port.K, torch.zeros(1, 3), 1.0, 50.0)[0]
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.4
    logs_j, logs_t = [], []
    ref.log, port.log = logs_j.append, logs_t.append
    want = ref.relocalize_strategy(jnp.asarray(frame.numpy()), T)
    got = port.relocalize_strategy(frame, T)
    assert got.iterations == want.iterations
    cells = [_CELLS.findall(line) for line in logs_t]
    assert cells == [_CELLS.findall(line) for line in logs_j] and any(cells)
    assert (got.relocalized, got.failed) == (want.relocalized, want.failed)
    np.testing.assert_allclose(got.Tcw, want.Tcw, atol=STRATEGY_POSE_ATOL, rtol=0)
    assert abs(got.nmi - want.nmi) <= MESH_GRID_ATOL + 1.1e-3
    assert np.abs(got.Tcw[:3, 3]).max() < 1e-5  # snapped back to I


def test_search_scale_attribute_widens_steps():
    """With no `search_scale` in the call, the strategy takes the attribute
    (the JAX localizer's default): the first sweep's steps are widened."""
    pts, gray = make_world(40000, seed=7)
    logs = []
    port = _port_loc(_cfg(max_iteration_count=1), STRAT_CAM, model=(pts, gray),
                     log_fn=logs.append)
    assert port.search_scale == 1.0
    port.search_scale = 2.0
    frame = torch.zeros(60, 80)
    port.relocalize_strategy(frame, np.eye(4, dtype=np.float32))
    assert "steps=(0.6, 0.6, 0.6)" in logs[0], logs


def test_mesh_is_never_rendered_by_the_splat(monkeypatch):
    """A mesh goes through bin_mesh and render_mesh_grid, once per grid, even
    when a point model is given too; the splat is never called."""
    def refuse(*a, **k):
        raise AssertionError("the point splat rendered a mesh")

    calls = []
    render_mesh_grid = traster.render_mesh_grid

    def counted(*a, **k):
        calls.append(a[3].shape[0])
        return render_mesh_grid(*a, **k)

    mesh = height_field_mesh()
    frame = mesh_frame(mesh)
    monkeypatch.setattr(trender, "render_translation_grid", refuse)
    monkeypatch.setattr(trender, "render_pointcloud", refuse)
    monkeypatch.setattr(traster, "render_mesh_grid", counted)
    cfg = _cfg(synth_num=(3, 1, 1), warp_num=(3, 1, 1), render_far=50.0)
    port = _port_loc(cfg, MESH_CAM, model=make_world(10), mesh=mesh)
    scores = port.evaluate_grid(frame, np.eye(4, dtype=np.float32), port.initial_kernel)
    assert scores.shape == (3, 3) and calls == [3]


# ----------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("render_mode", [1, 4])
def test_strategy_on_card_matches_cpu(cuda_device, render_mode, record_property):
    """The strategy on the card (kernels) against the CPU (plain versions):
    the same sweeps and outcome, and Tcw within 1e-5. Mesh: 48x256; points:
    the 60x80 world. On an H100 (80GB HBM3, 700 W) both modes measured nmi
    and Tcw gaps of exactly 0 (recorded as the `nmi_gap` and `tcw_gap`
    properties), so the nmi bar is 1e-6 in both modes: a few f32 steps of a
    score near 1."""
    outs = []
    for dev in (cuda_device, "cpu"):
        logs = []
        if render_mode == 1:
            mesh = height_field_mesh()
            cfg = _cfg(synth_step=(0.4,) * 3, render_far=50.0, threshold=0.5,
                       max_iteration_count=2)
            loc = _port_loc(cfg, MESH_CAM, mesh=mesh, device=dev, log_fn=logs.append)
            frame = mesh_frame(mesh, dev)
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.4
            kw = {}
        else:
            cfg, T, kw = _strategy_case("translation")
            pts, gray = make_world(40000, seed=7)
            loc = _port_loc(cfg, STRAT_CAM, model=(pts, gray), device=dev, log_fn=logs.append)
            frame = trender.render_pointcloud(loc.model, torch.eye(4), STRAT_CAM.K, 60, 80,
                                              1.0, 30.0, 3)
        out = loc.relocalize_strategy(frame, T, **kw)
        outs.append((out, [_CELLS.findall(line) for line in logs]))
    (card, cells_card), (cpu, cells_cpu) = outs
    record_property("nmi_gap", abs(card.nmi - cpu.nmi))
    record_property("tcw_gap", float(np.abs(card.Tcw - cpu.Tcw).max()))
    assert cells_card == cells_cpu
    assert (card.iterations, card.relocalized) == (cpu.iterations, cpu.relocalized)
    np.testing.assert_allclose(card.Tcw, cpu.Tcw, atol=STRATEGY_POSE_ATOL, rtol=0)
    assert abs(card.nmi - cpu.nmi) <= 1e-6
