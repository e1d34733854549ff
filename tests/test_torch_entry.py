"""The port's NMI grid step as a whole, against the JAX package.

The reference is the same composition of JAX functions that
`__graft_entry__.entry()` runs: `raster.bin_mesh`, `raster.render_mesh_grid`
(Pallas in interpret mode), `homography.warp_rotation_grid` and
`histogram_nmi.nmi_scores(use_pallas=False)`. The binned mesh passes to the
port through `convert.binned_from_numpy`. Size: 64x256 frames, 9 renders x 9
warps (the entry's toy mesh and steps).

Three bars, each measured on these inputs (random and rendered frames, both
values of use_background):
  * the port's score, fed the reference's renders and warps, agrees to
    atol=1e-5 (exact histograms; see test_torch_histogram_nmi);
  * the port's warp and score, fed the reference's renders, agree to
    atol=5e-4. The warped grays differ by at most 0.015 levels (the
    homographies are rounded in another order), which moves 0.008 % of warped
    pixels across an integer bin edge; measured max |score diff| 7.9e-5;
  * the whole port, render included, agrees to atol=2e-3. Its renders differ
    from the reference's where a UV quantum flips (about 0.04 % of pixels, see
    test_torch_raster), which moves a random texture's gray by up to tens of
    levels there; measured max |score diff| 8.1e-4.
The argmax must agree wherever the top two scores differ by more than ten
times the bar in force.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import THREADS, cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch import config as tconfig
from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.ops import histogram_nmi as thn
from orbslam2_nmi_tpu import config as jconfig
from orbslam2_nmi_tpu.ops import histogram_nmi as jhn
from orbslam2_nmi_tpu.ops import homography as jhom
from orbslam2_nmi_tpu.ops import raster as jr
from orbslam2_nmi_tpu.ops import render as jrender

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 256
NUM = (3, 3, 1)
SCORE_ATOL_SAME_IMAGES = 1e-5
SCORE_ATOL_SAME_RENDERS = 5e-4
SCORE_ATOL_WHOLE = 2e-3


def _assert_argmax_agrees(out, ref, atol):
    top2 = np.sort(ref.reshape(-1))[-2:]
    if top2[1] - top2[0] > 10 * atol:
        assert int(out.argmax()) == int(ref.argmax())


@pytest.fixture(scope="module")
def slice_setup():
    fn, (frame, Tcw) = tentry.entry(device="cpu", height=H, width=W, synth_num=NUM,
                                    warp_num=NUM)
    K = tentry.camera_K(H, W)
    jb = jr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), K, H, W, tentry.NEAR,
                     tentry.FAR, max_offset=tentry.SYNTH_STEP, device_arrays=False)
    offsets = jnp.asarray(jrender.translation_grid_offsets(NUM, tentry.SYNTH_STEP))
    angles = jhom.rotation_grid_angles(NUM, tentry.WARP_STEP)
    jb_dev = jb._replace(tri_data=jnp.asarray(jb.tri_data), texture=jnp.asarray(jb.texture),
                         tex_origin=jnp.asarray(jb.tex_origin))
    synth_j = jr.render_mesh_grid(jb_dev, np.eye(4, dtype=np.float32), K, offsets,
                                  tentry.NEAR, tentry.FAR, interpret=True)
    frames = {"random": frame.numpy(), "rendered": np.array(synth_j[len(offsets) // 2])}
    return fn, jb, K, angles, np.array(synth_j), frames


@pytest.mark.parametrize("frame_kind", ["random", "rendered"])
@pytest.mark.parametrize("use_background", [True, False])
def test_slice_matches_reference(slice_setup, frame_kind, use_background):
    fn, jb, K, angles, synth_j, frames = slice_setup
    frame = frames[frame_kind]
    warped_j = jhom.warp_rotation_grid(jnp.asarray(frame), jnp.asarray(K), angles)
    ref = np.asarray(jhn.nmi_scores(jnp.asarray(synth_j), warped_j, use_pallas=False,
                                    use_background=use_background))

    # the port's state comes across from the reference's binned mesh
    tb = convert.binned_from_numpy(jb._asdict(), "cpu")
    step = tentry.NMIGridStep(tb, K, fn.offsets, fn.angles, use_background=use_background)
    frame_t, Tcw_t = torch.from_numpy(frame), torch.eye(4)

    # 1. the score alone, on the reference's renders and warps
    warped_t = torch.from_numpy(np.array(warped_j))
    same = step.score(torch.from_numpy(synth_j), warped_t).numpy()
    np.testing.assert_allclose(same, ref, atol=SCORE_ATOL_SAME_IMAGES)
    _assert_argmax_agrees(same, ref, SCORE_ATOL_SAME_IMAGES)

    # 2. warp and score, on the reference's renders
    warp_score = step.score(torch.from_numpy(synth_j), step.warp(frame_t)).numpy()
    np.testing.assert_allclose(warp_score, ref, atol=SCORE_ATOL_SAME_RENDERS)
    _assert_argmax_agrees(warp_score, ref, SCORE_ATOL_SAME_RENDERS)

    # 3. the whole step, render included
    scores, best = step(frame_t, Tcw_t)
    assert scores.shape == (9, 9) and scores.dtype == torch.float32
    assert int(best) == int(scores.argmax())
    np.testing.assert_allclose(scores.numpy(), ref, atol=SCORE_ATOL_WHOLE)
    _assert_argmax_agrees(scores.numpy(), ref, SCORE_ATOL_WHOLE)
    if frame_kind == "rendered":  # rendered at the center pose: best at the center
        assert int(best) == 4 * 9 + 4


def test_entry_defaults_match_the_reference_entry():
    """At its defaults the port's entry has the reference entry's intrinsics,
    grid and binning (960x540, 27 x 27); checked on the host without running
    the step."""
    K = tentry.camera_K(540, 960)
    np.testing.assert_array_equal(
        K, np.array([[435.0, 0, 480.0], [0, 435.0, 270.0], [0, 0, 1]], np.float32))
    jb = jr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), K, 540, 960, 5.0, 40.0,
                     max_offset=(0.2, 0.2, 0.5), device_arrays=False)
    assert (jb.tiles_y, jb.tiles_x, jb.capacity, jb.overflow, jb.tex_win) == (34, 8, 128, 0, 128)
    assert tentry.NEAR == 5.0 and tentry.FAR == 40.0


@pytest.mark.parametrize("name", ["CameraConfig", "NMIGridConfig", "NMIConfig"])
def test_config_copies_match_reference(name):
    """The copied dataclasses have the reference's fields and defaults."""
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if name == "CameraConfig":
        np.testing.assert_array_equal(t.K, j.K)
        assert t.has_distortion == j.has_distortion


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()


def test_port_never_imports_jax():
    """Running the port's entry, its localizer (one strategy on the textured
    mesh, and one grid on the point model), its tracking step (one frame
    of `tracking_entry`), the native map core, a bundle adjustment, a
    vocabulary's training and descent, a pose graph, a Sim3 RANSAC, a PnP,
    the system on six frames through the pipelined front-end (its keyframe
    decisions counted by `tools/circuit_diag`), a saved
    trajectory, a two-view initialization, a rendered circuit sequence
    (`tools/replay_bench`), its descriptors (`tools/build_vocabulary`) and
    an overlay (`viz/replay`), the sharded pose graph and BA on a world of
    one rank on the CPU, a settings scene written to disk and replayed
    through `run_replay --settings --sequence` (the first NMI latch on its
    OBJ), and
    `tools/circuit_diag.run_diag`'s pipelined drive, with every mapping, loop-closing,
    system, replay, tool, visualization and multi-rank module imported,
    leaves jax and the JAX package out of sys.modules, and no file of the
    port (nor chip_smoke.py) imports them."""
    code = (
        "import sys, json\n"
        "import numpy as np, torch\n"
        "from orbslam2_nmi_torch.entry import entry, localizer_entry\n"
        "from orbslam2_nmi_torch.ops import render\n"
        "from orbslam2_nmi_torch.slam.nmi import async_worker, localizer\n"
        "fn, args = entry(device='cpu', height=32, width=128, synth_num=(1, 1, 1),"
        " warp_num=(1, 1, 1))\n"
        "fn(*args)\n"
        "loc, frame, T = localizer_entry(device='cpu', height=32, width=128)\n"
        "T[0, 3] = -0.2\n"
        "out = loc.relocalize_strategy(frame, T)\n"
        "assert out.relocalized and abs(out.Tcw[0, 3]) < 1e-6, out\n"
        "pts = render.mesh_to_points(loc.mesh, samples_per_unit_area=4.0)\n"
        "loc.model = render.model_from_pointcloud(pts, 'cpu')\n"
        "loc.mesh = None\n"
        "assert loc.evaluate_grid(frame, T, loc.initial_kernel).shape == (27, 27)\n"
        "from orbslam2_nmi_torch.entry import tracking_entry\n"
        "step, frames, carry, cands, poses = tracking_entry(device='cpu', height=120,"
        " width=160, count=2)\n"
        "out = step(frames[0], carry, *cands(carry.Tcw.numpy()))\n"
        "assert out.packed.shape == (35 + 17 * step.n_feat + step.n_cand,), out.packed.shape\n"
        "from orbslam2_nmi_torch import convert, native\n"
        "from orbslam2_nmi_torch.entry import mapping_entry, MappingSession\n"
        "from orbslam2_nmi_torch.slam import checkpoint, initialization, local_mapping, pipeline\n"
        "from orbslam2_nmi_torch.utils import bucketing\n"
        "from orbslam2_nmi_torch.solvers import local_ba\n"
        "native.median_hamming_best(np.arange(32, dtype=np.uint32).reshape(4, 8))\n"
        "prob = local_ba.BAProblem(K=torch.eye(3), cam_Tcw=torch.eye(4)[None],"
        " cam_fixed=torch.ones(1, dtype=torch.bool), cam_valid=torch.ones(1, dtype=torch.bool),"
        " pts_w=torch.ones(1, 3), pts_valid=torch.ones(1, dtype=torch.bool),"
        " obs_cam=torch.zeros(1, dtype=torch.int32), obs_pt=torch.zeros(1, dtype=torch.int32),"
        " obs_uv=torch.ones(1, 2), obs_inv_sigma2=torch.ones(1),"
        " obs_valid=torch.ones(1, dtype=torch.bool))\n"
        "assert torch.equal(local_ba.bundle_adjust(prob, 1, 1).cam_Tcw, prob.cam_Tcw)\n"
        "from orbslam2_nmi_torch.entry import add_revisit_arc, loop_entry, relocalize_pnp\n"
        "from orbslam2_nmi_torch.slam import keyframe_database, loop_closing, vocabulary\n"
        "from orbslam2_nmi_torch.solvers import pnp, pose_graph, sim3\n"
        "d = np.random.default_rng(0).integers(0, 2**32, (300, 8), dtype=np.uint32)\n"
        "voc = vocabulary.Vocabulary.train(d, k=4, depth=2)\n"
        "assert (voc.quantize(d) >= 0).all()\n"
        "S = pose_graph.optimize_pose_graph(pose_graph.PoseGraphProblem(Scw=torch.eye(4).repeat("
        "3, 1, 1), fixed=torch.tensor([True, False, False]), valid=torch.ones(3, dtype=torch.bool),"
        " edge_i=torch.tensor([0, 1], dtype=torch.int32), edge_j=torch.tensor([1, 2],"
        " dtype=torch.int32), edge_Sji=torch.eye(4).repeat(2, 1, 1),"
        " edge_valid=torch.ones(2, dtype=torch.bool)), iters=2)\n"
        "assert torch.allclose(S, torch.eye(4).repeat(3, 1, 1))\n"
        "g = torch.Generator().manual_seed(0)\n"
        "p = torch.randn(16, 3, generator=g) + torch.tensor([0.0, 0.0, 8.0])\n"
        "K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)\n"
        "uv = p[:, :2] / p[:, 2:] * 300.0 + torch.tensor([160.0, 120.0])\n"
        "one = torch.ones(16)\n"
        "r = sim3.sim3_ransac(torch.arange(3).repeat(4, 1), K, p, p, uv, uv, one, one,"
        " one.bool(), min_inliers=3)\n"
        "assert bool(r.ok)\n"
        "samples = torch.stack([torch.randperm(16, generator=g)[:4] for _ in range(8)])\n"
        "r = pnp.pnp_ransac(samples, K, p, uv, one, one.bool())\n"
        "assert bool(r.ok)\n"
        "import tempfile\n"
        "from orbslam2_nmi_torch import run_replay\n"
        "from orbslam2_nmi_torch.config import (CameraConfig, NMIConfig, ORBConfig,"
        " SystemConfig, TrackingConfig)\n"
        "from orbslam2_nmi_torch.io import datasets, trajectory\n"
        "from orbslam2_nmi_torch.io.synthetic import SyntheticWorld\n"
        "from orbslam2_nmi_torch.slam import frontend_pipelined, system, tracking\n"
        "from orbslam2_nmi_torch.solvers import two_view_init\n"
        "from orbslam2_nmi_torch.tools import circuit_diag\n"
        "w = SyntheticWorld.generate(seed=3, n_points=20000)\n"
        "cfg = SystemConfig(camera=CameraConfig(fx=w.fx, fy=w.fx, cx=80.0, cy=60.0, width=160,"
        " height=120), orb=ORBConfig(n_features=200, n_levels=3), nmi=NMIConfig(offset=2),"
        " tracking=TrackingConfig(max_keyframes=8, max_map_points=2048, max_features=256))\n"
        "s = system.SLAMSystem(cfg, use_nmi=False, output_dir=tempfile.mkdtemp(), device='cpu')\n"
        "s.set_init_poses(w.pose_at(0, 40), w.pose_at(2, 40))\n"
        "fe = frontend_pipelined.PipelinedFrontend(s, n_cand=256)\n"
        "res = fe.run([w.render_frame(i, 40, 160, 120, device='cpu') for i in range(6)],"
        " np.arange(6) / 10.0)\n"
        "assert len(res) == 6 and s.tracker.state != tracking.TrackingState.NOT_INITIALIZED\n"
        "assert circuit_diag.decision_counts(fe.records)['decisions'] <= 6\n"
        "s.save_full_trajectory('F')\n"
        "s.shutdown()\n"
        "assert trajectory.ate_rmse([np.eye(4)] * 3, [np.eye(4)] * 3) == 0.0\n"
        "uv1 = torch.rand(16, 2) * 100\n"
        "r = two_view_init.initialize_two_view(np.tile(np.arange(4), (8, 1)),"
        " np.tile(np.arange(8), (8, 1)), K, uv1, uv1 + 1.0, torch.ones(16, dtype=torch.bool))\n"
        "assert r.Tcw2.shape == (4, 4)\n"
        "from orbslam2_nmi_torch.tools import (bench, build_vocabulary, device_budget,"
        " fused_probe, locmode_bench, loop_bench, loop_live, replay_bench)\n"
        "from orbslam2_nmi_torch.utils import profiling\n"
        "from orbslam2_nmi_torch.viz import replay as viz\n"
        "assert device_budget.classify('fused_step') == 'tracking_fused_step'\n"
        "assert bench.bench_K(540, 960)[0, 0] == 435.0 and 'fused_step' in profiling.NAMES\n"
        "world, fr = replay_bench.generate_sequence(2, 160, 96, cache=False, device='cpu')\n"
        "assert fr.shape == (2, 96, 160) and len(build_vocabulary.descriptors(fr[0],"
        " ORBConfig(n_features=50, n_levels=2), 'cpu')) > 0\n"
        "viz.save_nmi_debug_overlay(np.zeros((4, 4)), np.ones((4, 4)),"
        " tempfile.mkdtemp() + '/o.png')\n"
        "from orbslam2_nmi_torch.parallel import (distributed, mesh, sharded_ba, sharded_nmi,"
        " sharded_pose_graph)\n"
        "from orbslam2_nmi_torch.tools import scaling_bench\n"
        "distributed.init_runtime(device='cpu')\n"
        "m = mesh.make_mesh()\n"
        "S1 = sharded_pose_graph.sharded_optimize_pose_graph(m, pose_graph.PoseGraphProblem("
        "Scw=torch.eye(4).repeat(3, 1, 1), fixed=torch.tensor([True, False, False]),"
        " valid=torch.ones(3, dtype=torch.bool), edge_i=torch.tensor([0, 1], dtype=torch.int32),"
        " edge_j=torch.tensor([1, 2], dtype=torch.int32), edge_Sji=torch.eye(4).repeat(2, 1, 1),"
        " edge_valid=torch.ones(2, dtype=torch.bool)), iters=2)\n"
        "assert torch.equal(S1, S)\n"
        "assert torch.equal(sharded_ba.sharded_bundle_adjust(m, prob, 1, 1).cam_Tcw, prob.cam_Tcw)\n"
        "assert sharded_nmi.pad_to_multiple(torch.ones(3, 2), 2).shape == (4, 2)\n"
        "distributed.shutdown()\n"
        "from orbslam2_nmi_torch.entry import write_settings_scene\n"
        "from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh\n"
        "mw = SyntheticMeshWorld(mesh=terrain_mesh(seed=1, n=20), fx=80.0)\n"
        "sc = write_settings_scene(tempfile.mkdtemp(), 4, n_total=120, world=mw, width=128,"
        " height=96, n_features=150, n_levels=3, cloud_density=1.0, device='cpu')\n"
        "assert run_replay.main(['--settings', sc.settings, '--sequence', sc.sequence,"
        " '--output', tempfile.mkdtemp(), '--device', 'cpu']) == 0\n"
        "d = circuit_diag.run_diag(mw, sc.frames, True, False, 0.45, tempfile.mkdtemp() + '/d',"
        " n_total=120, async_mapping=False, device='cpu')\n"
        "assert d['n_frames'] == 4 and 'online_err_p95_m' in d, d\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'orbslam2_nmi_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(THREADS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

    files = sorted((ROOT / "orbslam2_nmi_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "orbslam2_nmi_tpu"), (path, name)


@pytest.mark.gpu
def test_entry_on_card_matches_cpu(cuda_device):
    """The step on the card (kernels) agrees with the step on the CPU (plain
    versions) at a small size, within the whole-step bar: the homographies are
    inverted by another library on each device, which can flip a floor()."""
    fn_c, (frame_c, Tcw_c) = tentry.entry(device=cuda_device, height=H, width=W,
                                          synth_num=NUM, warp_num=NUM)
    fn_h, (frame_h, Tcw_h) = tentry.entry(device="cpu", height=H, width=W, synth_num=NUM,
                                          warp_num=NUM)
    s_c, _ = fn_c(frame_c, Tcw_c)
    s_h, _ = fn_h(frame_h, Tcw_h)
    np.testing.assert_allclose(s_c.cpu().numpy(), s_h.numpy(), atol=SCORE_ATOL_WHOLE)


@pytest.mark.gpu
def test_tf32_changes_neither_grid_step_nor_localizer(cuda_device, record_property):
    """Fault C1: with TF32 on for the whole process, the grid step at 960x540
    and the localizer's case (b) (a 0.03 rad rotation, rotation-only kernel)
    give max |diff| 0 against the default run. The flags are restored."""
    from orbslam2_nmi_torch.geometry import se3

    fn, (frame, Tcw) = tentry.entry(device=cuda_device)
    loc, lframe, T_true = tentry.localizer_entry(device=cuda_device)
    T_rot = T_true.copy()
    T_rot[:3, :3] = se3.euler_zyx(torch.tensor([0.0, 0.03, 0.0])).numpy()
    kw = dict(dist_since=(1e-4,) * 3, rot_since=(1.5,) * 3)

    def run():
        scores, _ = fn(frame, Tcw)
        out = loc.relocalize_strategy(lframe, T_rot.copy(), **kw)
        return scores.cpu().numpy(), out

    base_scores, base = run()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_scores, tf32 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    d_step = float(np.abs(tf32_scores - base_scores).max())
    d_tcw = float(np.abs(tf32.Tcw - base.Tcw).max())
    record_property("step_gap", d_step)
    record_property("tcw_gap", d_tcw)
    assert d_step == 0.0 and d_tcw == 0.0 and tf32.nmi == base.nmi
    assert base.relocalized and (tf32.iterations, tf32.num_warp) == (base.iterations,
                                                                     base.num_warp)


def test_kernel_ablations_apply_to_the_sources():
    """Each ablation of tools/ablate_kernels.py is one edit of the committed
    kernel source, each found exactly once, so the tool times what it names."""
    from orbslam2_nmi_torch.tools import ablate_kernels as ab

    for kernel, name, edits, _ in ab.ABLATIONS:
        src = ab._source(kernel, edits)
        assert (src != ab._source(kernel, [])) == bool(edits), name
