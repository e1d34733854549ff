"""The port's asynchronous NMI worker (slam/nmi/async_worker.py).

The worker reads a narrow slice of the SLAM system; `_System` below has
exactly the attributes it reads (the map's lock, epoch, keyframe arrays and
version, the tracker's drift accumulators, failure streak and trajectory,
the localizer, the mapping pipeline or local mapper, and the log). The JAX
worker and the port's, each on its own package's localizer over the same
60x80 point world, land the same keyframe pose within 1e-5.
"""

import dataclasses
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import torch
from torch_port_fixtures import make_world

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.slam.nmi import async_worker as tworker
from orbslam2_nmi_torch.slam.nmi import localizer as tloc
from orbslam2_nmi_tpu.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_tpu.ops import render as jrender
from orbslam2_nmi_tpu.slam.nmi import async_worker as jworker
from orbslam2_nmi_tpu.slam.nmi import localizer as jloc

POSE_ATOL = 1e-5
WAIT_S = 120.0
CAM = CameraConfig(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)
CFG = NMIConfig(grid=NMIGridConfig(synth_step=(0.3,) * 3, warp_step=(0.03,) * 3),
                render_near=1.0, render_far=30.0, threshold=0.3, max_iteration_count=2)
# drift since the last anchor; x 0.02 (drift_fraction) sizes 0.3 m / 0.03 rad steps
DIST, ROT = (15.0, 15.0, 15.0), (1.5, 1.5, 1.5)
FRAME_ID = 7


class _Map:
    def __init__(self, n_kf=3):
        self.lock = threading.Lock()
        self.epoch = 0
        self.version = 0
        self.kf_valid = np.ones(n_kf, bool)
        self.kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
        self.kf_nmi_reloc = np.zeros(n_kf, bool)
        self.kf_nmi_failed = np.zeros(n_kf, bool)

    def bump_version(self):
        self.version += 1


class _Tracker:
    def __init__(self):
        self.nmi_fail_streak = 0
        self.dist_since_nmi = [20.0, 20.0, 20.0]
        self.rot_since_nmi = [2.0, 2.0, 2.0]
        self.trajectory = [[FRAME_ID - 1, None, None, None, None, []],
                           [FRAME_ID, None, None, None, None, []]]


class _LocalMapper:
    def __init__(self):
        self.calls = []

    def local_bundle_adjust(self, k, epoch):
        self.calls.append((k, epoch))


class _System:
    def __init__(self, localizer):
        self.map = _Map()
        self.tracker = _Tracker()
        self.localizer = localizer
        self.pipeline = None
        self.local_mapper = _LocalMapper()
        self.logs = []

    def log(self, msg):
        self.logs.append(msg)


class _Gated:
    """A localizer whose sweeps wait until `go` is set."""

    def __init__(self, loc):
        self.loc = loc
        self.device = loc.device
        self.go = threading.Event()

    def relocalize_strategy(self, *args, **kw):
        assert self.go.wait(WAIT_S)
        return self.loc.relocalize_strategy(*args, **kw)


def _scene():
    pts, gray = make_world(40000, seed=7)
    jmodel = jrender.RenderModel(jnp.asarray(pts), jnp.asarray(gray))
    frame = np.asarray(jrender.render_pointcloud(jmodel, jnp.eye(4), jnp.asarray(CAM.K),
                                                 60, 80, 1.0, 30.0, 3))
    port = tloc.NMILocalizer(convert.nmi_config_from_dict(dataclasses.asdict(CFG)),
                             convert.camera_config_from_dict(dataclasses.asdict(CAM)),
                             convert.render_model_from_numpy(pts, gray, "cpu"), device="cpu")
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -0.3  # one translation step off
    return jloc.NMILocalizer(CFG, CAM, jmodel), port, frame, T


def _run(worker_cls, loc, frame, T):
    system = _System(loc)
    worker = worker_cls.AsyncNMI(system)
    try:
        assert worker.submit(1, frame, T, np.array(DIST), np.array(ROT), FRAME_ID)
        assert worker.flush(WAIT_S)
        assert worker.errors() == []
    finally:
        worker.shutdown(WAIT_S)
    assert not worker.thread.is_alive()
    return system, worker


def test_anchor_lands_like_reference():
    ref_loc, port_loc, frame, T = _scene()
    landed = []
    for worker_cls, loc in ((jworker, ref_loc), (tworker, port_loc)):
        system, worker = _run(worker_cls, loc, frame, T)
        m, tr = system.map, system.tracker
        assert (worker.n_applied, worker.n_failed) == (1, 0)
        assert m.kf_nmi_reloc[1] and not m.kf_nmi_failed[1] and m.version == 1
        assert not m.kf_nmi_reloc[[0, 2]].any()
        assert system.local_mapper.calls == [(1, 0)]
        # the drift measured at submit time is credited on the searched axes
        np.testing.assert_allclose(tr.dist_since_nmi, [5.0, 5.0, 5.0])
        np.testing.assert_allclose(tr.rot_since_nmi, [0.5, 0.5, 0.5])
        assert tr.nmi_fail_streak == 0
        assert tr.trajectory[0][5] == [] and len(tr.trajectory[1][5]) > 0
        landed.append(m.kf_Tcw[1].copy())
    np.testing.assert_allclose(landed[1], landed[0], atol=POSE_ATOL, rtol=0)
    assert np.abs(landed[1][:3, 3]).max() < 1e-5  # the anchor is T_true = I


def test_busy_worker_refuses_and_a_reset_drops_the_job():
    _, port_loc, frame, T = _scene()
    gated = _Gated(port_loc)
    system = _System(gated)
    worker = tworker.AsyncNMI(system)
    try:
        assert worker.submit(1, frame, T, np.array(DIST), np.array(ROT), FRAME_ID)
        assert worker.busy()
        assert not worker.submit(2, frame, T, np.array(DIST), np.array(ROT), FRAME_ID)
        with system.map.lock:
            system.map.epoch += 1  # a map reset while the sweep runs
        gated.go.set()
        assert worker.flush(WAIT_S) and not worker.busy()
        assert worker.errors() == []
        assert (worker.n_applied, worker.n_failed) == (0, 0)
        np.testing.assert_array_equal(system.map.kf_Tcw, np.tile(np.eye(4, dtype=np.float32),
                                                                  (3, 1, 1)))
        assert system.map.version == 0 and system.local_mapper.calls == []
        # idle again: the next keyframe's sweep is taken and lands
        assert worker.submit(2, frame, T, np.array(DIST), np.array(ROT), FRAME_ID)
        assert worker.flush(WAIT_S) and worker.n_applied == 1
        assert system.map.kf_nmi_reloc[2] and system.local_mapper.calls == [(2, 1)]
    finally:
        gated.go.set()
        worker.shutdown(WAIT_S)
    assert not worker.thread.is_alive()


def test_sweep_error_is_reported_and_frees_the_worker():
    class Broken:
        device = torch.device("cpu")

        def relocalize_strategy(self, *args, **kw):
            raise RuntimeError("sweep failed")

    system = _System(Broken())
    worker = tworker.AsyncNMI(system)
    try:
        assert worker.submit(0, np.zeros((60, 80), np.float32), np.eye(4), np.array(DIST),
                             np.array(ROT), FRAME_ID)
        assert worker.flush(WAIT_S) and not worker.busy()
        errors = worker.errors()
        assert len(errors) == 1 and "sweep failed" in errors[0]
        assert worker.n_applied == worker.n_failed == 0
    finally:
        worker.shutdown(WAIT_S)
    assert not worker.thread.is_alive()


def test_launch_counts_survive_concurrent_threads():
    """The worker thread and the caller's thread both launch kernels: the
    launch count, a read-modify-write, must lose no update under a tight
    switch interval with more threads than cores."""
    from orbslam2_nmi_torch import kernels

    n_threads, n_each = 2 * (os.cpu_count() or 4), 2000
    interval = sys.getswitchinterval()
    kernels.reset_launches()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(
            target=lambda: [kernels.count_launch("joint_entropy") for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["joint_entropy"] == n_threads * n_each
    finally:
        sys.setswitchinterval(interval)
        kernels.reset_launches()
