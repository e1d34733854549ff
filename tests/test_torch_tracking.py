"""The port's Tracker against the JAX package's, function by function, on
shared map states (`tests/test_tracking_unit.py`'s cases and the tracker's
per-frame functions).

The JAX package runs its synchronous system over the end-to-end scene
(`tests/test_slam_e2e.py`: 320x240, 400 features, 25 frames); the map's
fields and the tracker's state are copied after frame 14 (and at the end,
with the vocabulary and the keyframe database, for relocalization), each
package's tracker is given them, and each function runs on the same frame
(the JAX package's features of it). Bars: equal bindings, outlier masks and
counts, and Tcw within 1e-5 — or, where the gap is larger, a pose at least
as good as the reference's: its robust reprojection cost, taken in float64
over the frame's (equal) bindings, within 1e-6 relative of the JAX pose's
(the float32 resolution of a cost summed over a few dozen points), and the
gap within 1e-3. The pose-only LM on a frame with few bound points is that
ill-conditioned: on frame 15's local map (43 bound points) the port's pose
lies 1.3e-4 m from the JAX package's, both in float64 cost within 1.2e-7 of
each other, and the JAX package's own pose moves 5.5e-5 when the map's points
move by one float32 ulp (the motion model's problem). The float64 solve
lands within 2e-6 of the JAX pose: the two float32 LMs stall at different
points of the flat valley (the port composes with `se3.mm`, elementwise
float32; the JAX package with `Precision.HIGHEST`). Random draws are the JAX
package's (`JaxDraws`: PRNGKey(11) for relocalization, PRNGKey(13) for the
two-view init).
"""

import copy
import types

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.slam import tracking as ttr
from orbslam2_nmi_torch.slam.frame import FrameData as TFrame
from orbslam2_nmi_torch.slam.map_store import MapStore as TMapStore
from orbslam2_nmi_torch.slam.nmi.localizer import NMIOutcome as TOutcome
from orbslam2_nmi_tpu.slam import tracking as jtr
from orbslam2_nmi_tpu.slam.frame import FrameData as JFrame
from orbslam2_nmi_tpu.slam.map_store import MapStore as JMapStore
from orbslam2_nmi_tpu.slam.nmi.localizer import NMIOutcome as JOutcome
from torch_port_fixtures import (JaxDraws, cuda_device, e2e_config, e2e_frames,  # noqa: F401
                                 jax_e2e_run, jax_map_from_fields, jax_system_config,
                                 port_frame, set_tracker_state)

TCW_ATOL = 1e-5
SNAP = 14  # the state after this frame; frame 15 is tracked from it


@pytest.fixture(scope="module")
def run():
    world, frames, poses = e2e_frames()
    jsys, _, snap = jax_e2e_run(frames, snapshot_after=SNAP)
    tr = jsys.tracker
    feats = {i: tr._make_frame(i, i / 10.0, frames[i]) for i in (8, 14, 15)}
    end = dict(fields=convert_fields(jsys.map), vocab=jsys.vocabulary, db=jsys.database)
    yield dict(world=world, frames=frames, poses=poses, snap=snap, feats=feats, end=end,
               jsys=jsys)
    jsys.shutdown()


def convert_fields(m):
    from torch_port_fixtures import map_fields

    return map_fields(m)


def trackers(run, fields=None, state=None, system=(None, None)):
    """(port tracker, JAX tracker) on copies of the snapshot's map and state."""
    cfg = e2e_config()
    fields = run["snap"]["fields"] if fields is None else fields
    tm = convert.map_store_from_fields(copy.deepcopy(fields), cfg)
    jm = jax_map_from_fields(copy.deepcopy(fields), jax_system_config(cfg))
    t = ttr.Tracker(cfg, tm, system=system[0], device="cpu")
    j = jtr.Tracker(jax_system_config(cfg), jm, system=system[1])
    for tr in (t, j):
        set_tracker_state(tr, run["snap"]["tracker"] if state is None else state)
    return t, j


def frames_of(run, i):
    f = run["feats"][i]
    return port_frame(f), copy.deepcopy(f)


def robust_cost64(m, frame, K):
    """The float64 chi2 over the frame's bound points (Huber off, inliers
    at chi2 <= 5.991): the pose LM's objective at the end."""
    b = frame.mp_idx >= 0
    pts = m.mp_pos[frame.mp_idx[b]].astype(np.float64)
    pc = pts @ frame.Tcw[:3, :3].T.astype(np.float64) + frame.Tcw[:3, 3]
    uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                   K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
    inv_s2 = 1.0 / (1.2 ** (2.0 * frame.octave[b]))
    chi = ((frame.xy[b] - uv) ** 2).sum(-1) * inv_s2
    return float(chi[chi <= 5.991].sum())


def same_frame(t, a: TFrame, b: JFrame):
    """Equal bindings and outliers; Tcw within TCW_ATOL, or a pose at least
    as good as the reference's (see the module docstring)."""
    np.testing.assert_array_equal(a.mp_idx, b.mp_idx)
    np.testing.assert_array_equal(a.outlier, b.outlier)
    gap = float(np.abs(a.Tcw - b.Tcw).max())
    if gap <= TCW_ATOL:
        return
    c_t, c_j = robust_cost64(t.map, a, t.K), robust_cost64(t.map, b, t.K)
    assert gap <= 1e-3 and c_t <= c_j * (1 + 1e-6), (gap, c_t, c_j)


# --- the per-frame functions on the state after frame 14 -----------------------

def test_motion_model_matches_reference(run):
    t, j = trackers(run)
    ft, fj = frames_of(run, 15)
    ok_t, ok_j = t._track_with_motion_model(ft), j._track_with_motion_model(fj)
    assert ok_t == ok_j and ok_t
    same_frame(t, ft, fj)
    np.testing.assert_allclose(t.last_frame.Tcw, j.last_frame.Tcw, atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", [14, 15])
def test_reference_keyframe_matches_reference(run, i):
    """Frame 14 tracks against the reference keyframe; frame 15 finds fewer
    than 15 ratio-0.7 matches there, in both packages."""
    t, j = trackers(run)
    ft, fj = frames_of(run, i)
    ok = t._track_reference_keyframe(ft)
    assert ok == j._track_reference_keyframe(fj) == (i == 14)
    if ok:
        same_frame(t, ft, fj)


def test_local_map_matches_reference(run):
    """The local map on the motion model's result (the JAX package's, given
    to both): the same local keyframes and reference keyframe, bindings,
    visible and found counts, pose."""
    t, j = trackers(run)
    _, fj = frames_of(run, 15)
    assert j._track_with_motion_model(fj)
    ft = port_frame(fj)
    assert sorted(t._local_keyframes(ft).tolist()) == sorted(j._local_keyframes(fj).tolist())
    assert t.ref_kf == j.ref_kf
    n_t, n_j = t._track_local_map(ft), j._track_local_map(fj)
    assert n_t == n_j >= 10
    same_frame(t, ft, fj)
    assert t.ref_kf == j.ref_kf
    np.testing.assert_array_equal(t.map.mp_visible, j.map.mp_visible)
    np.testing.assert_array_equal(t.map.mp_found, j.map.mp_found)


def test_record_frame_matches_reference(run):
    t, j = trackers(run)
    _, fj = frames_of(run, 15)
    fj.Tcw = run["poses"][15].copy()
    fj.previous_poses = [np.eye(4, dtype=np.float32)]
    ft = port_frame(fj)
    t.record_frame(15, 1.5, ft)
    j.record_frame(15, 1.5, fj)
    np.testing.assert_allclose(t.dist_since_nmi, j.dist_since_nmi, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t.rot_since_nmi, j.rot_since_nmi, atol=1e-12, rtol=0)
    n_rows = len(run["snap"]["tracker"]["trajectory"])
    assert len(t.trajectory) == len(j.trajectory) == n_rows + 1
    for a, b in zip(t.trajectory, j.trajectory):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3] and a[4] == b[4]
        np.testing.assert_array_equal(a[2], b[2])
        assert len(a[5]) == len(b[5])
    np.testing.assert_array_equal(t._last_good_Tcw, j._last_good_Tcw)
    # a lost frame replicates the last row, flagged lost
    for tr, f in ((t, port_frame(fj)), (j, copy.deepcopy(fj))):
        f.Tcw = None
        tr.ref_kf = -1
        tr.record_frame(16, 1.6, f)
    assert t.trajectory[-1][4] and j.trajectory[-1][4] and t.trajectory[-1][3] == j.trajectory[-1][3]


def test_reset_leaves_the_same_state(run):
    t, j = trackers(run)
    t.reset()
    j.reset()
    for k in ("ref_kf", "last_kf_frame_id", "kfs_since_last_nmi", "n_resets", "nmi_fail_streak",
              "init_frame", "velocity", "trajectory"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.state.name == j.state.name == "NOT_INITIALIZED"
    assert t.map.n_keyframes == j.map.n_keyframes == 0 and not t.map.mp_valid.any()
    np.testing.assert_array_equal(t.dist_since_nmi, j.dist_since_nmi)


def test_relocalize_matches_reference(run):
    """BoW candidates, PnP on the reference's draws and the guided expansion
    to 50 inliers, against the map at the end of the run, for frame 8."""
    end = run["end"]
    t_voc = convert.vocabulary_from_numpy(vars(end["vocab"]), "cpu")
    t_db = convert.database_from_fields(copy.deepcopy(vars(end["db"])), t_voc)
    t_sys = types.SimpleNamespace(database=t_db, loop_closer=None, pipeline=None,
                                  nmi_worker=None)
    j_sys = types.SimpleNamespace(database=end["db"], loop_closer=None, pipeline=None,
                                  nmi_worker=None)
    t, j = trackers(run, fields=end["fields"], system=(t_sys, j_sys))
    t.draw_samples = JaxDraws(11)
    ft, fj = frames_of(run, 8)
    ok_t, ok_j = t._relocalize(ft), j._relocalize(fj)
    assert ok_t == ok_j is True
    assert t.ref_kf == j.ref_kf
    assert int((ft.mp_idx >= 0).sum()) == int((fj.mp_idx >= 0).sum()) >= 50
    same_frame(t, ft, fj)
    err = np.linalg.norm(-ft.Tcw[:3, :3].T @ ft.Tcw[:3, 3]
                         + run["poses"][8][:3, :3].T @ run["poses"][8][:3, 3])
    assert err < 0.5, err  # the map's own drift at frame 8 is of this order


def _two_view_frames(cls, cfg):
    """Two frames of one rigid scene of 300 points (5-15 m deep) seen from
    the identity and from a pose 0.8 m to the side: each point's feature
    has the same random descriptor in both (rows shuffled in the second),
    so the windowed matching pairs them all."""
    rng = np.random.default_rng(7)
    n = 300
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 15, n)], -1)
    T2 = np.eye(4)
    c, s_ = np.cos(0.03), np.sin(0.03)
    T2[:3, :3] = [[c, 0, s_], [0, 1, 0], [-s_, 0, c]]
    T2[:3, 3] = [-0.8, 0.05, 0.1]
    K = cfg.camera.K.astype(np.float64)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    out = []
    for T, perm in ((np.eye(4), np.arange(n)), (T2, rng.permutation(n))):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = (pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]])[perm]
        out.append(cls(frame_id=len(out) * 3, timestamp=0.3 * len(out), Tcw=None,
                       xy=uv.astype(np.float32), xy_raw=uv.astype(np.float32),
                       octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
                       desc=desc[perm], valid=np.ones(n, bool)))
    return out


def test_initialize_classic_matches_reference():
    """The classic two-view init with the reference's draws (PRNGKey(13)):
    the same model and map, points (unit median depth) within 1e-4 relative,
    the second pose within 1e-4."""
    cfg = e2e_config()
    tm, jm = TMapStore(cfg), JMapStore(jax_system_config(cfg))
    t = ttr.Tracker(cfg, tm, device="cpu")
    j = jtr.Tracker(jax_system_config(cfg), jm)
    t.draw_two_view = JaxDraws(13).two_view
    res = []
    for tr, cls in ((t, TFrame), (j, JFrame)):
        f0, f1 = _two_view_frames(cls, cfg)
        f0.Tcw = np.eye(4, dtype=np.float32)
        tr.init_frame = f0
        res.append((tr._initialize_classic(f1), f1))
    (rt, ft), (rj, fj) = res
    assert rt.state.name == rj.state.name == "OK"
    assert rt.n_inliers == rj.n_inliers and tm.n_points == jm.n_points > 200
    np.testing.assert_array_equal(ft.mp_idx, fj.mp_idx)
    np.testing.assert_allclose(ft.Tcw, fj.Tcw, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm.mp_pos[: tm.n_points], jm.mp_pos[: jm.n_points], atol=1e-4,
                               rtol=1e-4)
    assert t.ref_kf == j.ref_kf == 1 and tm.n_keyframes == 2


# --- tests/test_tracking_unit.py's cases, both packages side by side --------------

def _unit_trackers(nmi=(None, None)):
    from orbslam2_nmi_torch.config import CameraConfig, SystemConfig, TrackingConfig

    cfg = SystemConfig(camera=CameraConfig(fx=100, fy=100, cx=50, cy=50, width=100, height=100),
                       tracking=TrackingConfig(max_keyframes=8, max_map_points=64,
                                               max_features=16))
    tm, jm = TMapStore(cfg), JMapStore(jax_system_config(cfg))
    return (ttr.Tracker(cfg, tm, nmi_localizer=nmi[0], device="cpu"),
            jtr.Tracker(jax_system_config(cfg), jm, nmi_localizer=nmi[1]))


def _unit_frame(cls, fid=0):
    n = 4
    return cls(frame_id=fid, timestamp=0.0, Tcw=np.eye(4, dtype=np.float32),
               xy=np.zeros((n, 2), np.float32), xy_raw=np.zeros((n, 2), np.float32),
               octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
               desc=np.zeros((n, 8), np.uint32), valid=np.ones(n, bool))


FEATS = dict(feat_xy=np.zeros((4, 2), np.float32), feat_octave=np.zeros(4, np.int32),
             feat_angle=np.zeros(4, np.float32), feat_desc=np.zeros((4, 8), np.uint32),
             feat_valid=np.ones(4, bool))


class _FakeNMI:
    """A fixed outcome reporting which axes the kernel searched."""

    device = torch.device("cpu")

    def __init__(self, outcome, num_synth, num_warp):
        self.outcome, self.num_synth, self.num_warp = outcome, num_synth, num_warp

    def relocalize_strategy(self, gray, Tcw, **kw):
        return self.outcome(Tcw=Tcw, nmi=0.5, relocalized=True, failed=False, iterations=1,
                            previous_poses=[], num_synth=self.num_synth, num_warp=self.num_warp)


def test_drift_reset_is_per_axis():
    args = ((3, 1, 3), (1, 3, 1))
    t, j = _unit_trackers((_FakeNMI(TOutcome, *args), _FakeNMI(JOutcome, *args)))
    for tr, cls in ((t, TFrame), (j, JFrame)):
        tr._gray = np.zeros((8, 8), np.float32)
        tr.dist_since_nmi[:] = [1.0, 2.0, 3.0]
        tr.rot_since_nmi[:] = [0.1, 0.2, 0.3]
        assert tr._run_nmi(_unit_frame(cls), initializing=False)
        np.testing.assert_allclose(tr.dist_since_nmi, [0.0, 2.0, 0.0])
        np.testing.assert_allclose(tr.rot_since_nmi, [0.1, 0.0, 0.3])


@pytest.mark.parametrize("culled", [False, True])
def test_update_last_frame_matches_reference(culled):
    t, j = _unit_trackers()
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, 3] = [0.5, 0.0, 0.0]
    out = []
    for tr, cls in ((t, TFrame), (j, JFrame)):
        m = tr.map
        k0 = m.add_keyframe(T0, 0, 0.0, **FEATS)
        k1 = m.add_keyframe(T1, 1, 0.1, **FEATS)
        m.kf_parent[k1] = k0
        last = _unit_frame(cls, fid=2)
        last.ref_kf = k1
        last.Tcr = np.eye(4, dtype=np.float32)
        last.Tcr[:3, 3] = [0.0, 0.0, 0.5]
        last.Tcw = (last.Tcr @ T1).astype(np.float32)
        if culled:
            m.remove_keyframe(k1)  # stores kf_Tcp[k1]
            expect = last.Tcr @ m.kf_Tcp[k1] @ T0
        else:
            m.kf_Tcw[k1] = T1.copy()
            m.kf_Tcw[k1][:3, 3] = [1.0, 0.2, -0.1]  # BA refines the keyframe
            expect = last.Tcr @ m.kf_Tcw[k1]
        tr._update_last_frame(last)
        np.testing.assert_allclose(last.Tcw, expect, atol=1e-6)
        out.append(last.Tcw)
    np.testing.assert_array_equal(out[0], out[1])


class _Pipe:
    def __init__(self, is_idle, q_empty=True):
        self._idle, self._q_empty, self.interrupted = is_idle, q_empty, False

    def idle(self):
        return self._idle

    def queue_empty(self):
        return self._q_empty

    def interrupt_ba(self):
        self.interrupted = True


# (frame id, inliers, mapper idle, queue empty, ref points tracked) -> decision
KF_CASES = [
    (12, 30, True, True, 0),     # c1a cadence, idle: create
    (12, 30, False, True, 0),    # c1a, busy, queue empty: create, BA interrupted
    (12, 30, False, False, 0),   # c1a, busy, a keyframe queued: refuse
    (5, 200, False, True, 0),    # not due: no interrupt either
    (5, 20, True, True, 64),     # c1b (min_frames 0, idle) and c2 (20 < 0.9 * 64): create
    (5, 20, False, True, 64),    # c2 with the mapper busy, not c1a: refuse (strict gate)
    (5, 15, True, True, 64),     # c2 needs > 15 inliers
    (12, 60, True, True, 64),    # c1a without c2 but > 15 inliers: create
]


@pytest.mark.parametrize("fid, n_in, idle, q_empty, n_ref", KF_CASES)
def test_need_new_keyframe_matches_reference(fid, n_in, idle, q_empty, n_ref):
    """Async keyframe policy (Tracking.cc:1217-1302 and the c1a queue-empty
    rule), in both packages."""
    from orbslam2_nmi_torch.config import (CameraConfig, ORBConfig, SystemConfig,
                                           TrackingConfig)

    cfg = SystemConfig(camera=CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320, height=240),
                       orb=ORBConfig(n_features=64, n_levels=2),
                       tracking=TrackingConfig(max_frames=10, min_frames=0, max_keyframes=8,
                                               max_map_points=256, max_features=64))
    got = []
    for pkg, cls, mcls, c in ((ttr, TFrame, TMapStore, cfg),
                              (jtr, JFrame, JMapStore, jax_system_config(cfg))):
        m = mcls(c)
        rng = np.random.default_rng(0)
        for k in range(3):
            m.add_keyframe(np.eye(4, dtype=np.float32), k, 0.0, np.zeros((64, 2), np.float32),
                           np.zeros(64, np.int32), np.zeros(64, np.float32),
                           rng.integers(0, 2**32, (64, 8), dtype=np.uint32), np.ones(64, bool))
        for f in range(n_ref):  # points seen from all three keyframes
            p = m.add_map_point(np.zeros(3, np.float32), np.zeros(8, np.uint32), 0,
                                np.zeros(3, np.float32))
            for k in range(3):
                m.add_observation(k, f, p)
        sysm = types.SimpleNamespace(pipeline=_Pipe(idle, q_empty))
        kw = dict(device="cpu") if pkg is ttr else {}
        tr = pkg.Tracker(c, m, system=sysm, **kw)
        tr.ref_kf, tr.last_kf_frame_id = 0, 0
        f = cls(frame_id=fid, timestamp=fid / 10.0, Tcw=np.eye(4, dtype=np.float32),
                xy=np.zeros((64, 2), np.float32), xy_raw=np.zeros((64, 2), np.float32),
                octave=np.zeros(64, np.int32), angle=np.zeros(64, np.float32),
                desc=np.zeros((64, 8), np.uint32), valid=np.ones(64, bool))
        got.append((tr._need_new_keyframe(f, n_inliers=n_in), sysm.pipeline.interrupted))
    assert got[0] == got[1], got


@pytest.mark.gpu
def test_classic_frame_on_card_matches_cpu(run, cuda_device):
    """One classic frame (motion model, local map, pose LM) on the card and
    on the CPU from the same state: equal bindings, Tcw within 1e-5."""
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        cfg = e2e_config()
        tm = convert.map_store_from_fields(copy.deepcopy(run["snap"]["fields"]), cfg)
        tr = ttr.Tracker(cfg, tm, device=dev)
        set_tracker_state(tr, run["snap"]["tracker"])
        f, _ = frames_of(run, 15)
        assert tr._track_with_motion_model(f)
        n = tr._track_local_map(f)
        out.append((f, n))
    (a, na), (b, nb) = out
    assert na == nb
    np.testing.assert_array_equal(a.mp_idx, b.mp_idx)
    same_frame(tr, a, b)
