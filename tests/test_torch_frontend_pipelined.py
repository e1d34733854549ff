"""The port's lag-1 pipelined front-end (`slam/frontend_pipelined.py`)
against the JAX package's, both run on the same frames
(`tests/test_fused_track.py::test_pipelined_frontend_tracks_sequence` at
the end-to-end scene's size: 320x240, 400 features, 25 frames, 1,024
candidates, synchronous mapping, no NMI).

Two whole runs cannot agree frame for frame (the pose LMs part in their
accept decisions, `tests/test_torch_tracking.py`), so each run is held by
outcome against the JAX package's run of the same frames: the same number of
frames tracked, keyframes within one, and unaligned ATE within
`ATE_TOL_M` of the reference's own (measured on this CPU: 21 and 21 frames,
5 and 5 keyframes, 0.4725 and 0.4726 m; with the injected failure 14 and 14,
5 and 5, 0.5044 and 0.5045 m).

Also: the dispatch order of the pipeline (frame i is dispatched on frame
i-1's carry before frame i-1 is read back; its candidates come from the
last processed frame), a "fail" rewind through the classic path, the chain
rebase when the map moves between a frame's dispatch and its processing
(held against the JAX tracker's `_update_last_frame` on the same state,
within 1e-6), and the split readback.
"""

import tempfile
import time

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.io.trajectory import ate_rmse
from orbslam2_nmi_torch.slam import frontend_pipelined as fp
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.slam.tracking import TrackingState
from orbslam2_nmi_torch.utils.readback import HostCopy, to_host
from torch_port_fixtures import (E2E, cuda_device, e2e_config, e2e_frames,  # noqa: F401
                                 jax_map_from_fields, jax_system_config, map_fields)

N = E2E["n_frames"]
TS = np.arange(N) / 10.0
FAIL_FRAME = 12  # the fused frame made to miss the gates in the fail-rewind runs
ATE_TOL_M = 0.01  # the port's unaligned ATE against the JAX package's on the same frames


@pytest.fixture(scope="module")
def scene():
    _, frames, poses = e2e_frames()
    return frames, poses


def failing_unpack(unpack, tracker, failed: list):
    """`unpack_step` that makes frame FAIL_FRAME miss the gates once: the
    first step read back while the last processed frame is its predecessor
    (either package's tracker)."""
    def unpack_or_fail(buf, n_feat, n_cand):
        u = unpack(buf, n_feat, n_cand)
        if not failed and tracker.last_frame.frame_id == FAIL_FRAME - 1:
            failed.append(FAIL_FRAME)
            return u._replace(n_matches1=0)
        return u
    return unpack_or_fail


@pytest.fixture(scope="module")
def reference(scene):
    """The JAX package's PipelinedFrontend on the same frames: the run in two
    chunks and the fail-rewind run over frames 0-17. Returns each run's
    outcome (`outcome`)."""
    from orbslam2_nmi_tpu.slam import fused_track as jft
    from orbslam2_nmi_tpu.slam.frontend_pipelined import PipelinedFrontend as JFrontend
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem

    frames, poses = scene
    out = {}
    for run in ("chunks", "fail"):
        jsys = JSystem(jax_system_config(e2e_config()), use_nmi=False,
                       output_dir=tempfile.mkdtemp())
        jsys.set_init_poses(poses[0], poses[4])
        fe = JFrontend(jsys, n_cand=1024)
        if run == "chunks":
            results = fe.run(frames[:10], TS[:10]) + fe.run(frames[10:], TS[10:], start_id=10)
        else:
            unpack, failed = jft.unpack_step, []
            jft.unpack_step = failing_unpack(unpack, jsys.tracker, failed)
            try:
                results = fe.run(frames[:18], TS[:18])
            finally:
                jft.unpack_step = unpack
            assert failed == [FAIL_FRAME]
        out[run] = outcome(jsys, results, poses)
        jsys.shutdown()
    return out


def port_system(poses, async_mapping=False):
    sys_ = SLAMSystem(e2e_config(), use_nmi=False, output_dir=tempfile.mkdtemp(), device="cpu",
                      async_mapping=async_mapping)
    sys_.set_init_poses(poses[0], poses[4])
    return sys_


def tracked(results, poses):
    ok = [i for i, r in enumerate(results)
          if r is not None and r.state.name == "OK" and r.Tcw is not None]
    return ok, ate_rmse([results[i].Tcw for i in ok], [poses[i] for i in ok], align=False)


def outcome(sys_, results, poses) -> dict:
    ok, err = tracked(results, poses)
    return dict(tracked=ok, keyframes=int(sys_.map.n_keyframes), ate=err)


def assert_like_reference(out, ref):
    assert out["tracked"] == ref["tracked"], (out, ref)
    assert abs(out["keyframes"] - ref["keyframes"]) <= 1, (out, ref)
    assert abs(out["ate"] - ref["ate"]) <= ATE_TOL_M, (out, ref)


def test_pipelined_frontend_tracks_sequence(scene, reference):
    """Two chunks (carry persistence across calls), held against the JAX
    package's run of the same chunks, and the reference test's bars."""
    frames, poses = scene
    sys_ = port_system(poses)
    fe = fp.PipelinedFrontend(sys_, n_cand=1024)
    events = []
    dispatch, process = fe._dispatch, fe._process

    def rec_dispatch(gray, idx):
        events.append(("dispatch", fe._start + idx, fe._carry_src, sys_.tracker.last_frame.frame_id))
        return dispatch(gray, idx)

    def rec_process(item, *a):
        events.append(("process", fe._start + item[0]))
        return process(item, *a)

    fe._dispatch, fe._process = rec_dispatch, rec_process
    results = fe.run(frames[:10], TS[:10], start_id=0) + fe.run(frames[10:], TS[10:], start_id=10)
    out = outcome(sys_, results, poses)
    assert_like_reference(out, reference["chunks"])
    ok = out["tracked"]
    assert len(ok) >= N - 6, f"only {len(ok)} frames tracked"
    assert sys_.map.n_keyframes >= 3
    assert out["ate"] < 0.5, f"pipelined ATE {out['ate']:.3f} m"
    assert fe._carry is not None
    assert len(sys_.tracker.trajectory) >= len(ok) - 2
    fused = [i for i, r in fe.records.items() if r["path"] == "fused"]
    assert len(fused) >= N - 10

    # lag-1 order: frame i goes out on frame i-1's carry before frame i-1 is
    # read back, its candidates built from the last processed frame, i-2;
    # after a keyframe ("reseed") frame i is dispatched again on the
    # re-anchored carry of frame i-1, processed by then, and a chunk's first
    # frame after the last chunk drained
    first = {}
    for k, e in enumerate(events):
        first.setdefault(e[:2], k)
    lag1 = 0
    for k, e in enumerate(events):
        if e[0] != "dispatch" or e[2] != e[1] - 1 or ("process", e[1] - 1) not in first:
            continue  # the first dispatch on a carry seeded by the classic path
        _, i, _, last_processed = e
        if first[("process", i - 1)] > k:
            assert last_processed == i - 2, (i, last_processed)
            lag1 += 1
        else:
            assert fe.records[i - 1]["outcome"] == "reseed" or i == 10, (i, e)
            assert last_processed == i - 1, (i, e)
    assert lag1 >= N - 14
    sys_.shutdown()


def test_fail_rewinds_through_classic_path(scene, reference, monkeypatch):
    """A fused frame that misses the gates drops the frames in flight, which
    go through the classic path; then the chain reseeds. The run is held
    against the JAX package's with the same failure."""
    frames, poses = scene
    sys_ = port_system(poses)
    fe = fp.PipelinedFrontend(sys_, n_cand=1024)
    failed = []
    monkeypatch.setattr(fp.fused_track, "unpack_step",
                        failing_unpack(fp.fused_track.unpack_step, sys_.tracker, failed))
    results = fe.run(frames[:18], TS[:18], start_id=0)
    assert failed == [FAIL_FRAME] and fe.n_rewinds["fail"] == 1
    assert fe.records[12]["path"] == "classic" and fe.records[12]["state"] == "OK"
    assert fe.records[14]["path"] == "fused"
    out = outcome(sys_, results, poses)
    assert_like_reference(out, reference["fail"])
    ok = out["tracked"]
    assert ok[-1] == 17 and set(range(12, 18)) <= set(ok)
    sys_.shutdown()


def test_chain_rebase_matches_reference(scene):
    """A map correction lands between frame 11's dispatch and its
    processing: the chain's pose is rebased through the previous frame's
    reference keyframe, Tcw <- delta @ Tcw, with delta the JAX tracker's
    `_update_last_frame` on the same state."""
    from orbslam2_nmi_tpu.slam import tracking as jtr

    from torch_port_fixtures import set_tracker_state

    frames, poses = scene
    sys_ = port_system(poses)
    fe = fp.PipelinedFrontend(sys_, n_cand=1024)
    fe.run(frames[:11], TS[:11], start_id=0)
    tr, m = sys_.tracker, sys_.map
    assert tr.state == TrackingState.OK and fe._carry is not None
    fe._start = 11
    item = fe._dispatch(frames[11], 0)
    prev = tr.last_frame
    k = prev.ref_kf
    corr = np.eye(4, dtype=np.float32)
    corr[:3, 3] = [0.05, -0.02, 0.03]
    m.kf_Tcw[k] = (corr @ m.kf_Tcw[k]).astype(np.float32)
    m.bump_version()
    # the JAX tracker's re-anchoring of the previous frame on the same state
    jcfg = jax_system_config(sys_.cfg)
    jt = jtr.Tracker(jcfg, jax_map_from_fields(map_fields(m), jcfg))
    set_tracker_state(jt, {"last_frame": prev})
    T_old = prev.Tcw.copy()
    jt._update_last_frame(jt.last_frame)
    delta = jt.last_frame.Tcw @ np.linalg.inv(T_old)
    seen = []
    fe.debug_hook = lambda fid, frame, u: seen.append(u.Tcw.copy())
    results = [None]
    status = fe._process(item, [frames[11]], [TS[11]], results)
    assert status == "reseed" and fe.records[11]["rebased"] and fe.n_rebases == 1
    np.testing.assert_allclose(results[0].Tcw, delta @ seen[0], atol=1e-6, rtol=0)
    assert np.abs(delta - np.eye(4)).max() > 0.01
    np.testing.assert_allclose(fe._carry.Tcw.numpy(), results[0].Tcw, atol=1e-6, rtol=0)
    sys_.shutdown()


def test_split_readback():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    h = HostCopy(t)
    np.testing.assert_array_equal(h.wait(), t.numpy())
    np.testing.assert_array_equal(to_host(t), t.numpy())


@pytest.mark.gpu
def test_split_readback_does_not_wait(cuda_device):
    """On the card the copy is queued behind the stream's work and only the
    wait blocks: starting it behind a ~50 ms sleep kernel returns at once.
    One copy of the same size first, so the pinned buffer comes from the
    host allocator's cache (the first `cudaHostAlloc` alone can take as long
    as the sleep)."""
    x = torch.arange(1 << 20, device=cuda_device, dtype=torch.float32)
    HostCopy(x * 2).wait()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    h = HostCopy(x * 2)
    t_start = time.perf_counter() - t0
    got = h.wait()
    t_wait = time.perf_counter() - t0
    assert t_start < 0.5 * t_wait, (t_start, t_wait)
    np.testing.assert_array_equal(got, (x * 2).cpu().numpy())


@pytest.mark.gpu
def test_capture_beside_nmi_sweep_and_local_ba(cuda_device):
    """The tracking step captured on the card while the async NMI worker runs
    a sweep and the mapping worker a local BA (the reduced circuit, 480x270):
    the replay equals an eager run bit for bit."""
    from orbslam2_nmi_torch.entry import CIRCUIT_FRAMES, mapping_config
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh
    from orbslam2_nmi_torch.slam import fused_track

    world = SyntheticMeshWorld(mesh=terrain_mesh(seed=1, n=60), fx=225.0)
    n = CIRCUIT_FRAMES
    cfg = mapping_config(world, 270, 480, n_features=500, max_keyframes=32)
    system = SLAMSystem(cfg, nmi_mesh=world.mesh, async_mapping=True, async_nmi=True,
                        device=cuda_device, output_dir=tempfile.mkdtemp())
    system.set_init_poses(world.pose_at(0, n), world.pose_at(cfg.nmi.offset, n))
    frames = world.render_frames(list(range(41)), n, 480, 270, device=cuda_device)
    try:
        fe = fp.PipelinedFrontend(system, n_cand=512)
        fe.run(frames[:40], np.arange(40) / 30.0)
        system.nmi_worker.flush(600.0)
        system.pipeline.flush(600.0)
        tr, m = system.tracker, system.map
        step = fused_track.FusedTrackStep(system.cfg, 512, cuda_device)
        with m.lock:
            kfs = tr._local_keyframes(tr.last_frame)
            _, arrays = fp.local_candidates(m, system.cfg, kfs, tr.ref_kf, tr.last_frame.Tcw, 512)
            carry = fused_track.carry_from_frame(tr.last_frame, m, tr.velocity, cuda_device)
            k = int(m.valid_keyframe_indices()[-1])
            assert system.nmi_worker.submit(k, frames[int(m.kf_frame_id[k])].float(),
                                            m.kf_Tcw[k], tr.dist_since_nmi, tr.rot_since_nmi,
                                            int(m.kf_frame_id[k]))
            system.pipeline.insert_ba(k, m.epoch)
        args = (frames[40], carry, *(torch.from_numpy(a).to(cuda_device) for a in arrays))
        time.sleep(0.02)
        assert system.nmi_worker.busy()
        replayed = step(*args)
        system.nmi_worker.flush(600.0)
        system.pipeline.flush(600.0)
        eager = step.run_eager(*args)
        bits = lambda out: out.packed.view(torch.int32)  # noqa: E731 (int rows bitcast: NaN)
        assert torch.equal(bits(replayed), bits(eager))
        assert torch.equal(bits(step.replay(*args)), bits(eager))
        assert not system.errors()
    finally:
        system.shutdown()
