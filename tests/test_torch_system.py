"""The port's SLAMSystem end to end against the JAX package's
(`tests/test_slam_e2e.py`, `tests/test_trajectory.py`'s full-pipeline case).

Both packages run the same 25 frames of the seed-3 point world (320x240,
400 features, no NMI) from the true init poses of frames 0 and 4. Two full
runs cannot agree frame for frame (the pose LMs part in their accept
decisions, `tests/test_torch_tracking.py`), so the runs are held by outcome:
the reference's own bars (at least N-6 frames tracked synchronously, N-8
asynchronously, at least 3 keyframes, more than 100 points, unaligned ATE
under 0.5 m and 0.8 m), and against the JAX package's run: the same number
of frames tracked (measured: 21 and 21) and of keyframes within one
(measured: 6 and 6). The saved files follow the reference's formats and
parse like the JAX package's. A checkpoint and a vocabulary written by the
JAX package resume in the port, which then relocalizes into the map; and
localization-only mode tracks a second pass with the map frozen, survives
an induced loss and resumes.
"""

import os
import tempfile

import numpy as np
import pytest

from orbslam2_nmi_torch.io.trajectory import ate_rmse
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.slam.tracking import TrackingState
from torch_port_fixtures import E2E, e2e_config, e2e_frames, jax_e2e_run

N = E2E["n_frames"]


def run_port(frames, poses, async_mapping=False, output_dir=None):
    sys_ = SLAMSystem(e2e_config(), use_nmi=False, output_dir=output_dir or tempfile.mkdtemp(),
                      async_mapping=async_mapping, device="cpu")
    sys_.set_init_poses(poses[0], poses[4])
    res = [sys_.track_monocular(img, i / 10.0) for i, img in enumerate(frames)]
    return sys_, res


def outcome(sys_, results, poses):
    ok = [i for i, r in enumerate(results) if r.state.name == "OK" and r.Tcw is not None]
    ate = ate_rmse([results[i].Tcw for i in ok], [poses[i] for i in ok], align=False)
    return dict(tracked=len(ok), keyframes=int(sys_.map.n_keyframes),
                points=len(sys_.map.valid_point_indices()), ate=ate)


@pytest.fixture(scope="module")
def scene():
    world, frames, poses = e2e_frames()
    return frames, poses


@pytest.fixture(scope="module")
def reference(scene, tmp_path_factory):
    """The JAX package's synchronous run: its outcome, its saved files, a map
    checkpoint and its vocabulary."""
    frames, poses = scene
    d = tmp_path_factory.mktemp("jax")
    jsys, results, _ = jax_e2e_run(frames, output_dir=str(d))
    out = outcome(jsys, results, poses)
    jsys.save_full_trajectory("Full")
    jsys.save_keyframe_trajectory_tum("KF.txt")
    jsys.print_map_points("Map.xyz")
    jsys.save_map(str(d / "map.npz"))
    jsys.vocabulary.save(str(d / "voc.npz"))
    jsys.shutdown()
    return dict(outcome=out, dir=d)


@pytest.fixture(scope="module")
def port_sync(scene, tmp_path_factory):
    frames, poses = scene
    sys_, results = run_port(frames, poses, output_dir=str(tmp_path_factory.mktemp("port")))
    yield sys_, outcome(sys_, results, poses)
    sys_.shutdown()


def test_sync_run_tracks_like_reference(port_sync, reference):
    _, out = port_sync
    ref = reference["outcome"]
    for o in (out, ref):
        assert o["tracked"] >= N - 6 and o["keyframes"] >= 3 and o["points"] > 100, o
        assert o["ate"] < 0.5, o  # the reference's bound over a 12 m path
    assert out["tracked"] == ref["tracked"], (out, ref)
    assert abs(out["keyframes"] - ref["keyframes"]) <= 1, (out, ref)


def test_async_run_tracks_sequence(scene):
    frames, poses = scene
    sys_, results = run_port(frames, poses, async_mapping=True)
    assert sys_.pipeline.flush(timeout=120.0), "mapping worker failed to drain"
    assert sys_.errors() == []
    out = outcome(sys_, results, poses)
    sys_.shutdown()
    assert out["tracked"] >= N - 8 and out["keyframes"] >= 3, out
    assert out["ate"] < 0.8, out


def _parse(d, full, kf, xyz):
    rows = (d / full).read_text().strip().splitlines()
    kf_rows = (d / kf).read_text().strip().splitlines()
    return dict(ids=[int(r.split()[0]) for r in rows],
                kf_ids=[int(r.split()[0]) for r in rows if " KF" in r],
                widths={len(r.replace(",", "").split()) for r in rows},
                kf_widths={len(r.split()) for r in kf_rows}, n_kf=len(kf_rows),
                xyz=np.loadtxt(d / xyz))


def test_outputs_follow_reference_format(port_sync, reference, tmp_path):
    sys_, _ = port_sync
    sys_.output_dir = str(tmp_path)
    sys_.save_full_trajectory("Full")
    sys_.save_keyframe_trajectory_tum("KF.txt")
    sys_.print_map_points("Map.xyz")
    t = _parse(tmp_path, "Full.txt", "KF.txt", "Map.xyz")
    j = _parse(reference["dir"], "Full.txt", "KF.txt", "Map.xyz")
    # rows: id t [KF[, NMI][, FAILED]] x y z qx qy qz qw; TUM rows: t x y z qx qy qz qw
    assert t["widths"] <= {9, 10, 11, 12} and j["widths"] <= {9, 10, 11, 12}
    assert t["kf_widths"] == j["kf_widths"] == {8}
    assert t["ids"] == j["ids"] and len(t["kf_ids"]) >= 2
    assert t["xyz"].shape[1] == j["xyz"].shape[1] == 3 and len(t["xyz"]) > 50
    assert (tmp_path / "Full_twc.txt").exists()

    # a correction to every keyframe reaches every recomposed frame
    m = sys_.map
    kfs = m.valid_keyframe_indices()
    saved = m.kf_Tcw[kfs].copy()
    base = [r[2] for r in sys_.full_trajectory()]
    corr = np.eye(4, dtype=np.float32)
    corr[0, 3] = 0.5
    m.kf_Tcw[kfs] = (m.kf_Tcw[kfs] @ corr).astype(np.float32)
    moved = [r[2] for r in sys_.full_trajectory()]
    m.kf_Tcw[kfs] = saved
    assert len(base) == len(moved) >= 8
    assert min(np.abs(a - b).max() for a, b in zip(base, moved)) > 0.1


def _resumed(reference, tmp_path):
    """A port system with the JAX package's vocabulary file, resumed from
    its checkpoint (state LOST: the next frame relocalizes)."""
    cfg = e2e_config()
    cfg = cfg.replace(vocabulary_path=str(reference["dir"] / "voc.npz"))
    sys_ = SLAMSystem(cfg, use_nmi=False, output_dir=str(tmp_path), device="cpu")
    sys_.load_map(str(reference["dir"] / "map.npz"))
    return sys_


def test_load_map_resumes_from_reference_checkpoint(scene, reference, tmp_path):
    frames, poses = scene
    sys_ = _resumed(reference, tmp_path)
    assert sys_.tracker.state == TrackingState.LOST
    assert sys_.database is not None and sys_.database.active.sum() == sys_.map.kf_valid.sum()
    n_kf = int(sys_.map.n_keyframes)
    res = [sys_.track_monocular(frames[i], (N + i) / 10.0, frame_id=N + i) for i in range(12, 18)]
    ok = [r.state == TrackingState.OK for r in res]
    # relocalization accepts at >= 50 inliers: frames 12 and 13 fall short
    # (measured), frame 14 relocalizes, and tracking carries on
    assert any(ok[:3]) and all(ok[ok.index(True):]), [r.state.name for r in res]
    assert len(sys_.tracker.relocalizations) == 1
    i = ok.index(True)
    err = np.linalg.norm(-res[i].Tcw[:3, :3].T @ res[i].Tcw[:3, 3]
                         + poses[12 + i][:3, :3].T @ poses[12 + i][:3, 3])
    assert err < 0.5, err
    assert int(sys_.map.n_keyframes) >= n_kf
    sys_.shutdown()


def test_localization_only_mode(scene, reference, tmp_path):
    """System::ActivateLocalizationMode (System.cc:298-310) on the resumed
    map: a pass over the same path with zero map growth, an induced loss
    recovered by relocalization, then full SLAM again (tests/
    test_slam_e2e.py:151-198)."""
    frames, poses = scene
    sys_ = _resumed(reference, tmp_path)
    sys_.activate_localization_mode()
    n_kf, n_mp = int(sys_.map.n_keyframes), len(sys_.map.valid_point_indices())
    res = [sys_.track_monocular(img, (N + i) / 10.0, frame_id=N + i)
           for i, img in enumerate(frames)]
    ok = [i for i, r in enumerate(res) if r.state == TrackingState.OK and r.Tcw is not None]
    assert len(ok) >= N - 8, f"only {len(ok)}/{N} frames in localization-only mode"
    assert int(sys_.map.n_keyframes) == n_kf and len(sys_.map.valid_point_indices()) == n_mp
    assert ate_rmse([res[i].Tcw for i in ok], [poses[i] for i in ok], align=False) < 0.8

    rng = np.random.default_rng(0)
    fid = 2 * N
    for j in range(3):
        sys_.track_monocular(rng.integers(0, 255, frames[0].shape).astype(np.uint8),
                             (fid + j) / 10.0, frame_id=fid + j)
    assert sys_.tracker.state == TrackingState.LOST
    back = [sys_.track_monocular(frames[6 + j], (fid + 3 + j) / 10.0, frame_id=fid + 3 + j)
            for j in range(6)]
    assert any(r.state == TrackingState.OK for r in back), "no recovery after the loss"
    assert int(sys_.map.n_keyframes) == n_kf
    sys_.deactivate_localization_mode()
    assert sys_.tracker.only_tracking is False
    sys_.shutdown()
    assert os.path.exists(os.path.join(str(tmp_path), "_log.txt"))
