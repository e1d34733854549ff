"""System reset against the port's asynchronous mapping worker: the wiped map
must not be mutated by background work that was in flight.

Port of tests/test_reset_race.py, run against the port's `MapStore` and
`LocalMapper` on the CPU at the reference test's shapes. The reference
serializes this by draining the LocalMapping and LoopClosing threads inside
Tracking::Reset (Tracking.cc:1764-1779); both packages' pipelines instead tag
the map with a generation counter (`MapStore.epoch`, bumped by
`MapStore.clear()`), and a worker snapshot taken before the reset is
discarded at its next lock-acquiring phase. These tests pin that contract
and the `MapStore.clear()` invariants it depends on.
"""

import numpy as np

from orbslam2_nmi_torch.config import CameraConfig, ORBConfig, SystemConfig, TrackingConfig
from orbslam2_nmi_torch.slam.local_mapping import LocalMapper
from orbslam2_nmi_torch.slam.map_store import MapStore


def _cfg(max_kf=16):
    return SystemConfig(
        camera=CameraConfig(fx=100, fy=100, cx=64, cy=48, width=128, height=96),
        orb=ORBConfig(n_features=32, n_levels=2),
        tracking=TrackingConfig(max_keyframes=max_kf, max_map_points=256, max_features=32),
    )


def _add_kf(m, k_id):
    n = 8
    return m.add_keyframe(
        Tcw=np.eye(4, dtype=np.float32),
        frame_id=k_id,
        timestamp=float(k_id),
        feat_xy=np.random.RandomState(k_id).rand(32, 2).astype(np.float32) * 90,
        feat_octave=np.zeros(32, np.int32),
        feat_angle=np.zeros(32, np.float32),
        feat_desc=np.random.RandomState(k_id).randint(0, 2**32, (32, 8), np.uint64)
        .astype(np.uint32),
        feat_valid=np.arange(32) < n,
    )


def test_clear_preserves_lock_and_observers_bumps_epoch():
    m = MapStore(_cfg())
    lock_before = m.lock
    calls = []
    m.on_keyframe_removed.append(lambda k: calls.append(k))
    _add_kf(m, 0)
    _add_kf(m, 1)
    e0 = m.epoch
    with m.lock:
        m.clear()
    assert m.lock is lock_before, "clear() must not replace the map lock"
    assert m.on_keyframe_removed and m.epoch == e0 + 1
    assert m.n_keyframes == 0 and not m.kf_valid.any()
    # observers still wired: removing a fresh keyframe notifies
    k = _add_kf(m, 2)
    m.remove_keyframe(k)
    assert calls == [k]


def test_covisibility_queries_survive_stale_keyframe():
    m = MapStore(_cfg())
    k = _add_kf(m, 0)
    m.clear()
    # a stale index from before the reset: an empty result, no IndexError
    assert m.covisible_keyframes(k).size == 0
    assert m.best_covisible(k, 5).size == 0


def test_process_keyframe_is_noop_after_reset():
    cfg = _cfg()
    m = MapStore(cfg)
    lm = LocalMapper(cfg, m, device="cpu")
    k = _add_kf(m, 0)
    m.clear()
    before = m.n_points
    lm.process_keyframe(k)  # must not raise or mutate
    assert m.n_points == before and m.n_keyframes == 0


def test_stale_epoch_ba_writeback_discarded():
    cfg = _cfg()
    m = MapStore(cfg)
    lm = LocalMapper(cfg, m, device="cpu")
    _add_kf(m, 0)
    stale_epoch = m.epoch
    m.clear()
    k_new = _add_kf(m, 1)
    pose_before = m.kf_Tcw[k_new].copy()
    # a solve snapshotted before the reset must refuse to write back
    lm.local_bundle_adjust(k_new, epoch=stale_epoch)
    np.testing.assert_array_equal(m.kf_Tcw[k_new], pose_before)
