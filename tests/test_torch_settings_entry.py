"""The settings-file entry (a reference-format settings YAML, the prior model
and an image sequence from disk) and `tools/circuit_diag`'s classic and
pipelined drives, in the port against the JAX package, on the CPU.

The scene: `entry.write_settings_scene` on the seed-1 circuit at a quarter
of its size (240x135, fx 112.5, the 60x60 terrain mesh), the first 25 frames
of its 520-frame cadence, 300 ORB features, NMI offset 8, a keyframe at
least every 10 frames (Camera.fps 10); the pointcloud at 8 samples a square
metre. Bars, each measured here:
  * the writer round-trips: the YAML reads back into the config it was
    given, in both packages; the OBJ loads back equal to the world's mesh
    corner for corner (`load_obj` numbers vertices by first use, the
    reference's unindexed expansion), the texture and the XYZ pointcloud
    (offset removed, colours of exact luma) bit for bit; both layouts list
    the frames in order, stamped SETTINGS_T0 + i / fps;
  * `SLAMSystem.from_yaml`: the same `SystemConfig` and init poses in both
    packages, the same mesh from the OBJ; one sweep of the OBJ's mesh (3
    renders x 1 warp, the JAX localizer's Pallas rasterizer in interpret
    mode) within the localizer tests' mesh-grid bar of 8.1e-4, the same
    argmax; the XYZ model at `render_mode` 4 (which no settings file can
    select, in either package) one sweep of 27 renders x the identity warp
    within the same bar (measured 1.5e-4: the warps' parity gap on integer
    gray levels), the same argmax;
  * `run_replay.main --settings --sequence` in both layouts, the port
    (`--device cpu`) beside the JAX tool (`--platform cpu`) on the same
    files: the same frames tracked, keyframes within one, the same anchors,
    the unaligned ATE of the saved FullTrajectory within 0.01 m of each
    other (test_run_replay_matches_reference's bar; measured: 17 and 17
    tracked, keyframes at frames 8, 10 and 20 in both, 0.1262 and 0.1261 m).
    These runs go without NMI: off the TPU the JAX localizer renders a mesh
    by a splat of its sampled points (its scores are not the rasterizer's),
    and its rasterizer in interpret mode takes ~13 s a 125-render sweep at
    160x96, so the OBJ's NMI is held at the sweep above and on the card
    (chip_smoke.py's settings phase);
  * a missing model: both packages log "NMI disabled" and track on, alike;
  * `circuit_diag.run_diag` beside the JAX tool's on the same frames and a
    synchronous system (classic and pipelined, no NMI): the JAX summary's
    keys, the same frames tracked, keyframes within one, the same anchors,
    ATE within 0.01 m (measured: 17 and 17 tracked both ways; classic
    0.0939 and 0.0938 m, pipelined 0.0516 and 0.0516 m, aligned as the JAX
    tool aligns without NMI);
  * the larger of `homography.shift_bounds_for_angles`' two bounds equals
    the JAX package's joint `shift_bound_for_angles` on tests/test_nmi.py's
    angle grids.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch import run_replay as trun
from orbslam2_nmi_torch.config import load_yaml_config
from orbslam2_nmi_torch.io import datasets as tdatasets
from orbslam2_nmi_torch.io import model_loader as tloader
from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh
from orbslam2_nmi_torch.ops import homography as thom
from orbslam2_nmi_torch.slam.nmi import search_kernel as tsk
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.tools import circuit_diag as tdiag
from orbslam2_nmi_torch.tools import replay_bench as trb
from orbslam2_nmi_tpu import config as jconfig
from orbslam2_nmi_tpu import run_replay as jrun
from orbslam2_nmi_tpu.io import datasets as jdatasets
from orbslam2_nmi_tpu.io import model_loader as jloader
from orbslam2_nmi_tpu.ops import homography as jhom
from orbslam2_nmi_tpu.tools import replay_bench as jrb
from torch_port_fixtures import jax_system_config

WIDTH, HEIGHT, N_TOTAL, N_FRAMES = 240, 135, 520, 25
MESH_GRID_ATOL = 8.1e-4  # tests/test_torch_localizer.py's mesh-grid bar
ATE_GAP_M = 0.01  # tests/test_torch_replay_bench.py's bar

_SCENES: dict = {}


def _world():
    return SyntheticMeshWorld(mesh=terrain_mesh(seed=1, n=60), fx=112.5)


def _jworld():
    from orbslam2_nmi_tpu.io.synthetic import SyntheticMeshWorld as JWorld
    from orbslam2_nmi_tpu.io.synthetic import terrain_mesh as jterrain

    return JWorld(mesh=jterrain(seed=1, n=60), fx=112.5)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """layout -> the scene written in that layout (written on first use)."""
    root = tmp_path_factory.mktemp("settings")
    world = _world()
    frames = trb.render_sequence(world, N_FRAMES, WIDTH, HEIGHT, N_TOTAL, device="cpu")

    def get(layout="eth"):
        if layout not in _SCENES:
            _SCENES[layout] = tentry.write_settings_scene(
                str(root / layout), N_FRAMES, n_total=N_TOTAL, layout=layout, world=world,
                width=WIDTH, height=HEIGHT, fps=10.0, n_features=300, cloud_density=8.0,
                frames=frames, device="cpu")
        return _SCENES[layout]

    yield get
    _SCENES.clear()


def _asdict_without_inits(cfg) -> tuple:
    d = dataclasses.asdict(cfg)
    return d, (d["nmi"].pop("init1"), d["nmi"].pop("init2"))


@pytest.mark.parametrize("layout", tentry.SETTINGS_LAYOUTS)
def test_writer_round_trips(scenes, layout):
    sc = scenes(layout)
    want, want_inits = _asdict_without_inits(sc.cfg)
    for load in (load_yaml_config, jconfig.load_yaml_config):
        got, inits = _asdict_without_inits(load(sc.settings))
        assert got == want
        for a, b in zip(inits, want_inits):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want_inits[0], np.linalg.inv(sc.poses[0].astype(np.float64))
                                  .astype(np.float32))
    n = sc.cfg.nmi
    mesh = sc.world.mesh
    port = tloader.load_obj(n.model_obj_path, n.model_texture_path)
    ref = jloader.load_obj(n.model_obj_path, n.model_texture_path)
    for name in ("vertices", "uvs", "faces", "texture_gray"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port.faces.shape == mesh.faces.shape and len(port.vertices) == len(mesh.vertices)
    np.testing.assert_array_equal(port.vertices[port.faces], mesh.vertices[mesh.faces])
    np.testing.assert_array_equal(port.uvs[port.faces], mesh.uvs[mesh.faces])
    np.testing.assert_array_equal(port.texture_gray, mesh.texture_gray)
    for load in (tloader.load_xyz_pointcloud, jloader.load_xyz_pointcloud):
        pc = load(n.model_cloud_path, n.model_offset_path)
        np.testing.assert_array_equal(pc.points, sc.cloud.points)
        np.testing.assert_array_equal(pc.gray, sc.cloud.gray)
    stamps = tentry.SETTINGS_T0 + np.arange(N_FRAMES) / 10.0
    loaders = ((tdatasets.load_eth_sequence, jdatasets.load_eth_sequence) if layout == "eth"
               else (tdatasets.load_newer_college_sequence,
                     jdatasets.load_newer_college_sequence))
    seqs = [load(sc.sequence) for load in loaders]
    assert seqs[0].image_paths == seqs[1].image_paths and len(seqs[0]) == N_FRAMES
    np.testing.assert_array_equal(seqs[0].timestamps, seqs[1].timestamps)
    np.testing.assert_allclose(seqs[0].timestamps, stamps, rtol=0, atol=1e-6)
    for i, t, img in seqs[0].frames():
        np.testing.assert_array_equal(img, sc.frames[i].numpy())


def test_from_yaml_matches_reference(scenes, tmp_path, monkeypatch):
    """`from_yaml` in both packages: the same config and init poses, the
    same mesh from the OBJ; the port's passes `device` through, and its
    default is CUDA, as the constructor's."""
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem

    sc = scenes()
    port = SLAMSystem.from_yaml(sc.settings, device="cpu", output_dir=str(tmp_path / "port"))
    ref = JSystem.from_yaml(sc.settings, use_nmi=False, output_dir=str(tmp_path / "jax"))
    try:
        assert port.device == torch.device("cpu")
        got, got_inits = _asdict_without_inits(port.cfg)
        want, want_inits = _asdict_without_inits(ref.cfg)
        assert got == want
        for a, b in zip(got_inits, want_inits):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.tracker._init_T1, ref.tracker._init_T1)
        np.testing.assert_array_equal(port.tracker._init_T2, ref.tracker._init_T2)
        loc = port.localizer
        assert loc is not None and loc.mesh is not None and loc.model is None
        model, mesh = ref._load_model_from_config()
        assert model is None
        for name in ("vertices", "uvs", "faces", "texture_gray"):
            np.testing.assert_array_equal(getattr(loc.mesh, name), getattr(mesh, name))
    finally:
        port.shutdown()
        ref.shutdown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem.from_yaml(sc.settings, output_dir=str(tmp_path / "cuda"))


def _sweep_pair(sc, tmp_path, render_mode, kernel_kw):
    """One sweep of the settings' model at frame 8, one translation step
    off its true pose on x, by the port's localizer and the JAX one's (the
    mesh through its Pallas rasterizer in interpret mode)."""
    import jax.numpy as jnp

    from orbslam2_nmi_tpu.slam.nmi import localizer as jloc
    from orbslam2_nmi_tpu.slam.nmi import search_kernel as jsk
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem

    cfg = load_yaml_config(sc.settings)
    cfg = cfg.replace(nmi=dataclasses.replace(cfg.nmi, render_mode=render_mode))
    jcfg = jax_system_config(cfg)
    port = SLAMSystem(cfg, device="cpu", output_dir=str(tmp_path / "port"))
    jsys = JSystem(jcfg, use_nmi=False, output_dir=str(tmp_path / "jax"))
    try:
        model, mesh = jsys._load_model_from_config()
        ref = jloc.NMILocalizer(jcfg.nmi, jcfg.camera, model, mesh=mesh, force_mesh_raster=True)
        loc = port.localizer
        assert (loc.mesh is None) == (render_mode == 4) and (loc.model is None) == (render_mode == 1)
        g = cfg.nmi.grid
        kw = dict(step_synth=g.synth_step, step_warp=g.warp_step, **kernel_kw)
        T = sc.poses[8].copy()
        T[0, 3] -= g.synth_step[0]
        frame = sc.frames[8]
        got = loc.evaluate_grid(frame.float(), T, tsk.SearchKernel(**kw))
        want = np.asarray(ref.evaluate_grid(jnp.asarray(frame.numpy(), jnp.float32), T,
                                            jsk.SearchKernel(**kw)))
    finally:
        port.shutdown()
        jsys.shutdown()
    return got, want


@pytest.mark.parametrize("render_mode", [1, 4])
def test_model_sweep_matches_reference(scenes, tmp_path, render_mode):
    """The OBJ (render mode 1: 3 renders x 1 warp) and the XYZ with its
    offset (render mode 4, set on the config: 27 renders x the identity
    warp) score one sweep as the JAX localizer does on the same files,
    within the mesh grid's bar. Measured: mode 4 1.5e-4, its renders equal
    bit for bit: the camera frame's gray levels are integers, on the bin
    edges, and the two packages' identity warps differ by 1.5e-5, which
    moves pixels across them (the warps' parity gap, as
    test_image_scale_matches_reference's point grid)."""
    sc = scenes()
    kernel = (dict(num_synth=(3, 1, 1), num_warp=(1, 1, 1)) if render_mode == 1
              else dict(num_synth=(3, 3, 3), num_warp=(1, 1, 1)))
    got, want = _sweep_pair(sc, tmp_path, render_mode, kernel)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MESH_GRID_ATOL, rtol=0)
    assert int(got.argmax()) == int(want.argmax())
    # the sweep finds the step back to the truth: the center's x-neighbour
    assert got.max() > 0.3, got


def _outputs(out_dir, poses) -> dict:
    """The saved trajectories of a run_replay output directory: tracked
    frames, keyframes, anchored keyframes and the unaligned ATE of the
    recomposed trajectory's camera centres against `poses`."""
    rows = [ln.replace(",", " ").split() for ln in open(os.path.join(out_dir,
                                                                     "FullTrajectory.txt"))]
    ids = np.array([int(r[0]) for r in rows])
    centers = np.array([[float(x) for x in r[-7:-4]] for r in rows])
    truth = np.array([-T[:3, :3].T @ T[:3, 3] for T in poses[ids]])
    with open(os.path.join(out_dir, "KeyFrameTrajectory.txt")) as f:
        n_kf = sum(1 for ln in f if ln.strip())
    return dict(frames=ids.tolist(), keyframes=n_kf,
                anchors=[int(r[0]) for r in rows if "NMI" in r],
                ate=float(np.sqrt(((centers - truth) ** 2).sum(1).mean())),
                map_points=os.path.getsize(os.path.join(out_dir, "MapPoints.xyz")) > 0)


@pytest.mark.parametrize("layout", tentry.SETTINGS_LAYOUTS)
def test_run_replay_settings_matches_reference(scenes, tmp_path, capsys, layout):
    sc = scenes(layout)
    args = ["--settings", sc.settings, "--sequence", sc.sequence, "--no-nmi"]
    assert trun.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jrun.main(args + ["--output", str(tmp_path / "jax"), "--platform", "cpu"]) == 0
    jax_out = capsys.readouterr().out
    tracked = [next(ln for ln in out.splitlines() if ln.startswith("tracked ")).split(",")[0]
               for out in (port_out, jax_out)]
    assert tracked[0] == tracked[1], tracked
    got, want = _outputs(tmp_path / "port", sc.poses), _outputs(tmp_path / "jax", sc.poses)
    assert got["frames"] == want["frames"] and len(got["frames"]) >= N_FRAMES - 10, (got, want)
    assert abs(got["keyframes"] - want["keyframes"]) <= 1, (got, want)
    assert got["anchors"] == want["anchors"]
    assert abs(got["ate"] - want["ate"]) <= ATE_GAP_M, (got, want)
    assert got["map_points"] and want["map_points"]


def test_missing_model_disables_nmi(scenes, tmp_path):
    """A settings file whose model is missing: both packages log "NMI
    disabled", build no localizer and track on (the reference's
    behaviour), frame for frame alike."""
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem
    from orbslam2_nmi_torch.slam.tracking import TrackingState

    sc = scenes()
    path = tmp_path / "missing.yaml"
    text = open(sc.settings).read().replace(sc.cfg.nmi.model_obj_path,
                                            str(tmp_path / "no_such_model.obj"))
    path.write_text(text)
    port = SLAMSystem.from_yaml(str(path), device="cpu", output_dir=str(tmp_path / "port"))
    ref = JSystem.from_yaml(str(path), output_dir=str(tmp_path / "jax"))
    try:
        assert port.localizer is None and ref.localizer is None
        for d in ("port", "jax"):
            assert "NMI disabled" in (tmp_path / d / "_log.txt").read_text()
        states = []
        for i in range(12):
            img = sc.frames[i].numpy()
            a, b = port.track_monocular(img, i / 10.0), ref.track_monocular(img, i / 10.0)
            states.append((a.state.name, str(b.state).split(".")[-1]))
        assert all(a == b for a, b in states), states
        assert states[-1][0] == TrackingState.OK.name
    finally:
        port.shutdown()
        ref.shutdown()


def _diag_both(sc, pipelined, monkeypatch, tmp_path):
    """run_diag of both packages on the scene's frames, each tool's
    build_system replaced by a synchronous system on the scene's config
    without NMI (the JAX tool builds async mapping: thread timing would
    part the runs)."""
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem
    from orbslam2_nmi_tpu.tools import circuit_diag as jdiag

    def port_system(world, width, height, **kw):
        return SLAMSystem(sc.cfg, use_nmi=False, output_dir=str(tmp_path / "port"),
                          device="cpu")

    def jax_system(world, width, height, **kw):
        return JSystem(jax_system_config(sc.cfg), use_nmi=False,
                       output_dir=str(tmp_path / "jax"))

    monkeypatch.setattr(trb, "build_system", port_system)
    monkeypatch.setattr(jrb, "build_system", jax_system)
    got = tdiag.run_diag(sc.world, sc.frames, pipelined, False, 0.45,
                         str(tmp_path / "port.jsonl"), n_total=N_TOTAL, device="cpu")
    want = jdiag.run_diag(_jworld(), sc.frames.numpy(), pipelined, False, 0.45,
                          str(tmp_path / "jax.jsonl"), n_total=N_TOTAL)
    return got, want


@pytest.mark.parametrize("pipelined", [False, True])
def test_circuit_diag_matches_reference(scenes, monkeypatch, tmp_path, pipelined):
    got, want = _diag_both(scenes(), pipelined, monkeypatch, tmp_path)
    assert set(got) == set(want) | {"online_err_p50_m", "online_err_p95_m", "online_err_max_m"}
    assert got["n_frames"] == want["n_frames"] == N_FRAMES and got["pipelined"] == pipelined
    assert got["n_tracked"] == want["n_tracked"] >= N_FRAMES - 10, (got, want)
    assert abs(got["n_keyframes"] - want["n_keyframes"]) <= 1, (got, want)
    # without a localizer both packages flag the init pair anchored
    assert got["nmi_anchor_frame_ids"] == want["nmi_anchor_frame_ids"] == [0, 8]
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= ATE_GAP_M, (got, want)
    rows = [ln for ln in open(tmp_path / "port.jsonl")]
    jrows = [ln for ln in open(tmp_path / "jax.jsonl")]
    assert len(rows) == len(jrows) == N_FRAMES + 1  # a row a frame and the log
    rows = [json.loads(ln) for ln in rows[:-1]]
    jrows = [json.loads(ln) for ln in jrows[:-1]]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert [r["state"] for r in rows] == [r["state"] for r in jrows]
    e = np.array([r["err_m"] for r in rows if "err_m" in r])
    assert got["online_err_max_m"] == pytest.approx(e.max())
    assert got["online_err_p50_m"] == pytest.approx(np.median(e))


@pytest.mark.parametrize("num, step, size", [
    ((3, 3, 3), (0.02, 0.02, 0.04), (96, 128)),
    ((3, 3, 3), (0.01, 0.01, 0.01), (64, 64)),
    ((3, 1, 1), (0.8, 0.0, 0.0), (64, 64)),
])
def test_shift_bound_for_angles_matches_reference(num, step, size):
    """tests/test_nmi.py's two-pass warp grids (fx 150 at 96x128, fx 100 at
    64x64, and the large angle that falls back to the gather)."""
    h, w = size
    f = 150.0 if h == 96 else 100.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    angles = np.asarray(jhom.rotation_grid_angles(num, step))
    got = max(thom.shift_bounds_for_angles(K, thom.rotation_grid_angles(num, step, device="cpu")
                                           .numpy(), h, w))
    assert got == jhom.shift_bound_for_angles(K, angles, h, w)
    assert got == max(thom.shift_bounds_for_angles(K, angles, h, w))


def test_circuit_diag_cli_refuses(monkeypatch, capsys):
    """`--frames` drives the async and sync mapper modes only; without CUDA
    the tool refuses unless `--device cpu` is asked for."""
    with pytest.raises(SystemExit):
        tdiag.main(["--frames", "2", "--mapper", "idle"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdiag.main(["--frames", "2"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
