"""Asynchronous NMI relocalization — the sweep off the tracking critical path.

Port of `orbslam2_nmi_tpu/slam/nmi/async_worker.py`. The reference runs
RelocalizeWithNMIStrategy INSIDE Track() every 2nd keyframe
(Tracking.cc:598-623): a <=4-iteration coarse-to-fine sweep blocks the frame
loop for the whole GPU grid search.

This worker moves the sweep to its own thread, like the mapping worker moves
BA (slam/pipeline.py). Timeline:

  * at keyframe creation (tracking thread): the KF is created at its tracked
    pose; the camera gray + pose + drift state are snapshotted and submitted.
  * worker thread: runs the full coarse-to-fine strategy (device work, no map
    lock held) against the SNAPSHOT pose.
  * landing (worker, under the map lock): if accepted, the keyframe's pose is
    set to the NMI absolute pose (the anchor is absolute — that is the point
    of localizing against a georeferenced prior, Tracking.cc:1976-1983), the
    KF is flagged NMI-relocalized (fixed in all later BA, Optimizer.cc:82/548)
    and a local BA around it pulls the neighborhood onto the anchor. The
    tracker's drift accumulators are credited with the drift measured at
    SUBMIT time (motion during the sweep keeps accumulating — correct
    bookkeeping for the next kernel sizing, Tracking.cc:648-662).

The anchor lands 1-2 keyframes late; because NMI keyframes are *fixed* in BA
rather than participating free, a late anchor is semantically identical to an
early one — the essential/BA graphs pull the map onto it whenever it lands.
Tracking reads the correction through the standard reseed path
(Tracking::UpdateLastFrame semantics; frontend_pipelined re-anchors its device
carry at the next keyframe).

Only one sweep is in flight; if a new NMI-due keyframe arrives while busy, the
caller keeps its every-2nd-keyframe counter un-reset so the NEXT keyframe
retries (the reference has no such case — its sweep is synchronous).
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Optional

import numpy as np
import torch


class AsyncNMI:
    def __init__(self, system):
        self.system = system
        self.q: queue.Queue = queue.Queue(maxsize=1)
        self._busy = False
        self._busy_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._errors: list = []
        self.n_applied = 0
        self.n_failed = 0
        self.thread = threading.Thread(target=self._run, daemon=True, name="nmi-worker")
        self.thread.start()

    # -------------------------------------------------------------- producer

    def busy(self) -> bool:
        return self._busy

    def submit(
        self,
        k: int,
        gray: np.ndarray,
        Tcw: np.ndarray,
        dist_since: np.ndarray,
        rot_since: np.ndarray,
        frame_id: int,
    ) -> bool:
        """Queue a sweep for keyframe k (False when one is already running).
        Called with the map lock held — all tracker state the sweep needs
        (incl. the failure streak that sizes the widening) is snapshotted
        HERE so the worker never reads mutable tracker/localizer state from
        its own thread."""
        with self._busy_lock:
            if self._busy:
                return False
            self._busy = True
            self._idle.clear()
        self.q.put(
            (
                int(k),
                np.asarray(gray, np.float32).copy(),
                np.asarray(Tcw, np.float32).copy(),
                np.asarray(dist_since, np.float64).copy(),
                np.asarray(rot_since, np.float64).copy(),
                int(frame_id),
                self.system.map.epoch,
                int(self.system.tracker.nmi_fail_streak),
            )
        )
        return True

    # -------------------------------------------------------------- consumer

    def _run(self):
        # kernels launch on this thread's current CUDA stream; the kernel
        # library and the launch counts are shared under kernels._lock
        while True:
            job = self.q.get()
            if job is None:
                break
            k, gray, Tcw, dist0, rot0, frame_id, epoch, streak = job
            try:
                loc = self.system.localizer
                # consecutive-failure widening (see Tracker.nmi_fail_streak):
                # without it a drift beyond the +-2%-of-motion span can never
                # re-enter the grid and failures cascade to divergence. The
                # streak was snapshotted under the map lock at submit time and
                # the widening is passed per-call — no shared localizer state
                # is mutated from this thread.
                widen = 1.0 + 0.75 * min(streak, 6) if streak else 1.0
                out = loc.relocalize_strategy(
                    torch.as_tensor(gray, device=loc.device),
                    Tcw,
                    dist_since=tuple(dist0),
                    rot_since=tuple(rot0),
                    initializing=False,
                    search_scale=widen,
                )
                self._apply(k, out, dist0, rot0, frame_id, epoch)
            except Exception:  # pragma: no cover - surfaced via errors()
                self._errors.append(traceback.format_exc())
            finally:
                with self._busy_lock:
                    self._busy = False
                    self._idle.set()

    def _apply(self, k: int, out, dist0, rot0, frame_id: int, epoch: int):
        sysm = self.system
        tr = sysm.tracker
        with sysm.map.lock:
            if sysm.map.epoch != epoch or not sysm.map.kf_valid[k]:
                return  # reset or culled mid-sweep: drop silently
            if out.relocalized:
                # absolute snap (CalculateNMIRelocalization result) + anchor
                sysm.map.kf_Tcw[k] = np.asarray(out.Tcw, np.float32)
                sysm.map.kf_nmi_reloc[k] = True
                sysm.map.kf_nmi_failed[k] = False
                sysm.map.bump_version()
                # credit the drift measured at submit time on searched axes
                # (Tracking.cc:600-612 per-axis reset; motion during the sweep
                # stays accumulated)
                for ax in range(3):
                    if out.num_synth[ax] > 1:
                        tr.dist_since_nmi[ax] = max(
                            tr.dist_since_nmi[ax] - dist0[ax], 0.0
                        )
                    if out.num_warp[ax] > 1:
                        tr.rot_since_nmi[ax] = max(
                            tr.rot_since_nmi[ax] - rot0[ax], 0.0
                        )
                self.n_applied += 1
                tr.nmi_fail_streak = 0
            else:
                sysm.map.kf_nmi_failed[k] = True
                self.n_failed += 1
                tr.nmi_fail_streak += 1
            # saver parity: the KF's trajectory row carries the pre-NMI poses
            # (System.cc:570-590 mvPreviousPoses)
            if out.previous_poses:
                for row in reversed(tr.trajectory):
                    if row[0] == frame_id:
                        row[5].extend(out.previous_poses)
                        break
        sysm.log(
            f"kf {k} (frame {frame_id}): async NMI "
            f"{'ok' if out.relocalized else 'FAILED'} score={out.nmi:.4f} "
            f"iters={out.iterations}"
        )
        if out.relocalized:
            # pull the neighborhood onto the fresh anchor (the sync path gets
            # this from the mapping worker processing the KF at the snapped
            # pose; here the anchor landed after that BA ran). Routed through
            # the mapping pipeline's single BA executor — running the solve on
            # THIS thread raced with the mapping worker's own local BA: both
            # snapshot/write-back under the lock but solve unlocked, so the
            # later write-back clobbered the fresher poses.
            if sysm.pipeline is not None:
                sysm.pipeline.insert_ba(k, epoch)
            else:
                sysm.local_mapper.local_bundle_adjust(k, epoch=epoch)

    # --------------------------------------------------------------- control

    def flush(self, timeout: Optional[float] = None) -> bool:
        return self._idle.wait(timeout)

    def errors(self) -> list:
        return list(self._errors)

    def shutdown(self, timeout: float = 60.0):
        self.flush(timeout)
        self.q.put(None)
        self.thread.join(timeout)
