"""Asynchronous mapping pipeline: the reference's background threads.

Port of `orbslam2_nmi_tpu/slam/pipeline.py`, the equivalent of the
LocalMapping + LoopClosing threads the reference spawns at startup
(System.cc:116-120) with their queue, mutex and flag protocol
(LocalMapping::InsertKeyFrame, LocalMapping.h:58-71; LoopClosing.cc:98).
One worker thread drains the keyframe queue and runs local mapping, then
loop closing, per keyframe.

Concurrency contract (the JAX package's; Map::mMutexMapUpdate, held across
the whole Track() in the reference, Tracking.cc:377):
  * the tracker holds `map.lock` for each frame's host processing;
  * the worker holds it around map mutations, but not during the local-BA
    device solve, so tracking never blocks on BA;
  * a newer queued keyframe aborts the pending BA (mbAbortBA semantics):
    the BA reruns at the newest keyframe.

Global BA after a loop closure runs on its own transient thread
(LoopClosing.cc:587) with the mbStopGBA/mnFullBAIdx generation counter: a
newer launch makes the stale solve's result be discarded, and an accepted
result propagates to keyframes and points created during the solve
(`LocalMapper.global_ba_apply`).

Where the port differs: on CUDA the worker and the global-BA thread launch
their device work on a stream of their own (`self.stream`), so a tracking
step replayed on the tracking thread's stream does not queue behind a BA;
each thread's result reaches the host through a copy that waits for that
stream only. `system` is any object with `map`, `local_mapper`,
`loop_closer` and `ensure_vocabulary` (`slam/system.SLAMSystem`): while its
`loop_closer` is None the worker offers it each keyframe's descriptors
(the vocabulary may train then, and the loop closer appear); once it
exists, the worker runs loop closing on each keyframe after local mapping,
and the closer's global BA comes back here (`launch_global_ba`).

Tracing: the worker maps each keyframe inside a `mapping.keyframe` range,
and the keyframe's record (`LocalMapper.records`) keeps how long it waited
in the queue (`queued_ms`, from `insert_keyframe` to the worker taking it).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from typing import Optional

import torch

from orbslam2_nmi_torch.solvers import local_ba
from orbslam2_nmi_torch.utils.profiling import span
from orbslam2_nmi_torch.utils.readback import to_host

_MAPPING_KEYFRAME = span("mapping.keyframe")


class MappingPipeline:
    def __init__(self, system):
        self.system = system
        self.q: queue.Queue = queue.Queue()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._drained = threading.Event()
        self._drained.set()
        self._errors: list = []
        self._interrupt = False
        self._gba_lock = threading.Lock()
        self._gba_idx = 0  # mnFullBAIdx
        self._gba_thread: Optional[threading.Thread] = None
        self.gba_records: list = []  # one a global BA: sizes, solve time, applied
        dev = system.local_mapper.device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if system.loop_closer is not None:
            system.loop_closer.gba_launcher = self.launch_global_ba
        self.thread = threading.Thread(target=self._run, daemon=True, name="local-mapping")
        self.thread.start()

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    # ------------------------------------------------------------- producer

    def insert_keyframe(self, k: int):
        """LocalMapping::InsertKeyFrame (LocalMapping.cc:117) + InterruptBA."""
        with self._pending_lock:
            self._pending += 1
            self._drained.clear()
        self.q.put(("kf", int(k), time.perf_counter()))

    def insert_ba(self, k: int, epoch: int):
        """Queue a standalone local BA around keyframe k (the async NMI
        worker's post-anchor pull-in). All local-BA device solves run on this
        worker: two concurrent solvers whose write-backs interleave would
        lose the later map state to results from a stale snapshot."""
        with self._pending_lock:
            self._pending += 1
            self._drained.clear()
        self.q.put(("ba", int(k), int(epoch)))

    def abort_requested(self) -> bool:
        """True when a newer keyframe is waiting or the tracker asked for an
        interrupt (mbAbortBA)."""
        return not self.q.empty() or self._interrupt

    def idle(self) -> bool:
        """LocalMapping::AcceptKeyFrames equivalent: no keyframe queued or
        being processed (Tracking.cc:1259-1302)."""
        return self._pending == 0

    def queue_empty(self) -> bool:
        """No keyframe waiting (one may be mid-processing)."""
        return self.q.empty()

    def interrupt_ba(self):
        """LocalMapping::InterruptBA (Tracking.cc:1293): ask the in-flight
        local BA to stop early. Cleared when the worker picks up its next
        keyframe."""
        self._interrupt = True

    # ------------------------------------------------------------- consumer

    def _run(self):
        while True:
            k = self.q.get()
            if k is None:
                break
            try:
                self._interrupt = False
                sysm = self.system
                with self._on_stream():
                    if k[0] == "ba":  # ("ba", k, epoch): post-anchor BA
                        _, kk, epoch = k
                        sysm.local_mapper.local_bundle_adjust(kk, epoch=epoch)
                        continue
                    _, k, queued_at = k  # ("kf", k, when it was queued)
                    with _MAPPING_KEYFRAME():
                        sysm.local_mapper.process_keyframe(k, abort_fn=self.abort_requested,
                                                           queued_at=queued_at)
                    with sysm.map.lock:
                        if sysm.loop_closer is None:
                            sysm.ensure_vocabulary(sysm.map.kf_feat_desc[k],
                                                   sysm.map.kf_feat_valid[k])
                    if sysm.loop_closer is not None:
                        # loop detection + Sim3 + correction (LoopClosing::Run)
                        with sysm.map.lock:
                            sysm.loop_closer.process_keyframe(k)
            except Exception:  # surfaced via errors()
                self._errors.append(traceback.format_exc())
            finally:
                with self._pending_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._drained.set()

    # ----------------------------------------------------------- global BA

    def launch_global_ba(self, iters: int = 10):
        """RunGlobalBundleAdjustment on its own thread (LoopClosing.cc:587).
        A newer launch aborts the in-flight one (mbStopGBA/mnFullBAIdx: the
        stale result is discarded at apply time)."""
        with self._gba_lock:
            self._gba_idx += 1
            idx = self._gba_idx

        def run():
            try:
                lm = self.system.local_mapper
                with self.system.map.lock:
                    epoch = self.system.map.epoch
                    snap = lm.global_ba_snapshot()
                if snap is None:
                    return
                prob, kfs, pts, fixed = snap
                rec = dict(C=prob.cam_Tcw.shape[0], P=prob.pts_w.shape[0],
                           O=prob.obs_cam.shape[0], applied=False)
                self.gba_records.append(rec)
                t = time.perf_counter()
                with self._on_stream():
                    res = local_ba.bundle_adjust(prob, iters1=iters // 2,
                                                 iters2=iters - iters // 2)
                    res = local_ba.BAResult(*(to_host(x) for x in res))  # waits for the solve
                rec["solve_ms"] = (time.perf_counter() - t) * 1e3
                with self._gba_lock:
                    if idx != self._gba_idx:
                        return  # aborted by a newer loop closure
                with self.system.map.lock:
                    if self.system.map.epoch != epoch:
                        return  # System::Reset wiped the map mid-solve
                    lm.global_ba_apply(res, kfs, pts, fixed)
                    rec["applied"] = True
            except Exception:  # surfaced via errors()
                self._errors.append(traceback.format_exc())

        t = threading.Thread(target=run, daemon=True, name="global-ba")
        self._gba_thread = t
        t.start()

    # ------------------------------------------------------------- control

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued keyframe has been processed (the
        reference's Shutdown waits for LocalMapping::isFinished) and any
        in-flight global BA has landed."""
        ok = self._drained.wait(timeout)
        t = self._gba_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        return ok

    def errors(self) -> list:
        return list(self._errors)

    def shutdown(self, timeout: float = 60.0):
        self.flush(timeout)
        self.q.put(None)
        self.thread.join(timeout)
