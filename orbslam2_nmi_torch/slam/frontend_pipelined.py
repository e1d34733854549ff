"""Lag-1 pipelined front-end around the device tracking step.

Port of `orbslam2_nmi_tpu/slam/frontend_pipelined.py`. It drives
`slam/fused_track.FusedTrackStep`: frame i's step is dispatched BEFORE frame
i-1's results are read, so the device computes while the host does map
bookkeeping, one packed readback a frame instead of the classic path's
stage-by-stage waits. Initialization, relocalization, keyframe creation,
NMI, local mapping and loop closing stay on the classic `Tracker` (rare,
per-keyframe events); the step replaces the per-frame hot path (motion-
model and local-map tracking).

Failure handling: when a processed frame misses the reference's gates (20
motion matches / 10 local-map inliers, Tracking.cc:1110, :1201), every frame
in flight is discarded and those frames are re-tracked through the classic
path (the full fallback chain: wider window, reference-keyframe tracking,
BoW + PnP relocalization); then the chain reseeds ("fail"). A frame that
mutated the map (a keyframe) or met a landed map correction re-anchors the
carry, and the frames in flight are re-dispatched against it ("reseed").

Staleness contract (one dispatch, in the spirit of the reference's own
asynchronous mapping): the local-map candidate set and keyframe decision of
frame i derive from frame i-1's processed results, and map corrections (BA,
NMI, loop) reach the device chain at the next reseed, its pose rebased
through the reference keyframe (`Tcr`) at once.

Where the port differs: JAX dispatches asynchronously by itself. Here the
step is replayed from a CUDA graph on the tracking thread's stream, and its
packed buffer's readback is split (`utils/readback.HostCopy`): the copy
is queued with frame i's dispatch and waited for only after frame i+1 has
been dispatched. `FusedTrackStep.replay` returns copies of the graph's
outputs, so frame i+1's replay cannot overwrite frame i's buffer.

Tracing (`utils/profiling`): while a profiler runs, the front-end's phases
run inside ranges of their own (`frontend.dispatch`, `frontend.map_lock`,
`frontend.candidates`, `frontend.readback_wait`, `frontend.process`,
`frontend.keyframe`, `frontend.nmi_backpressure`, `frontend.classic`), and
each frame's record (`records`) keeps its host times whether or not one
runs. The records and `completion_walls` keep the newest `FRAME_RECORDS`
frames.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from orbslam2_nmi_torch.slam import fused_track
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_torch.slam.tracking import TrackingState, TrackResult
from orbslam2_nmi_torch.utils.readback import HostCopy
from orbslam2_nmi_torch.utils import profiling
from orbslam2_nmi_torch.utils.profiling import labelled, span

FRUSTUM_MARGIN = 64.0  # px, the candidate pre-filter's margin
FRAME_RECORDS = 8192  # frames whose record and completion time are kept

_MAP_LOCK = span("frontend.map_lock")
_READBACK_WAIT = span("frontend.readback_wait")
_KEYFRAME = span("frontend.keyframe")
_NMI_BACKPRESSURE = span("frontend.nmi_backpressure")
_CLASSIC = span("frontend.classic")


class _MapHeld:
    """`with _MapHeld(lock) as held:` holds the map lock, taken inside a
    `frontend.map_lock` range; `held.wait_ms` is the wait for it."""

    def __init__(self, lock):
        self.lock = lock
        self.wait_ms = 0.0

    def __enter__(self):
        t0 = time.perf_counter()
        with _MAP_LOCK():
            self.lock.acquire()
        self.wait_ms = (time.perf_counter() - t0) * 1e3
        return self

    def __exit__(self, *exc):
        self.lock.release()


def local_candidates(m, cfg, kfs: np.ndarray, ref_kf: int, Tcw_last, n_cand: int):
    """The step's local-map candidates (UpdateLocalKeyFrames/Points,
    Tracking.cc:1461-1486) from the local keyframes `kfs`: their points in
    keyframe order (the reference keyframe first, then its covisibles, each
    point once), a frustum pre-filter at `Tcw_last` with a 64 px margin when
    they exceed `n_cand`, then truncated and padded to `n_cand`; each with
    the map store's descriptor, distance range and normal. A plain id
    truncation would keep the oldest points, which on a large map are behind
    the camera. The caller holds the map lock.

    Returns (ids [k] map point ids, (pts [C, 3], desc [C, 8] int32 bit
    patterns, min_d [C], max_d [C], normal [C, 3], valid [C]))."""
    C = n_cand
    ids = np.zeros(0, np.int64)
    if len(kfs):
        order = [ref_kf] + [int(k) for k in kfs if int(k) != ref_kf]
        picked = np.zeros(m.mp_valid.shape[0], bool)
        out = []
        for k in order:
            ps = m.kf_mp_idx[k]
            ps = ps[ps >= 0]
            ps = ps[m.mp_valid[ps] & ~picked[ps]]
            if len(ps):
                picked[ps] = True
                out.append(ps)
        if out:
            ids = np.concatenate(out).astype(np.int64)
        if len(ids) > C and Tcw_last is not None:
            cam = cfg.camera
            pc = m.mp_pos[ids] @ Tcw_last[:3, :3].T + Tcw_last[:3, 3]
            z = np.maximum(pc[:, 2], 1e-9)
            u = cam.K[0, 0] * pc[:, 0] / z + cam.K[0, 2]
            v = cam.K[1, 1] * pc[:, 1] / z + cam.K[1, 2]
            mg = FRUSTUM_MARGIN
            ids = ids[(pc[:, 2] > 0) & (u >= -mg) & (u < cam.width + mg) & (v >= -mg)
                      & (v < cam.height + mg)]
        ids = ids[:C]
    k = len(ids)
    pts = np.zeros((C, 3), np.float32)
    desc = np.zeros((C, 8), np.int32)
    min_d = np.ones(C, np.float32)
    max_d = np.ones(C, np.float32)
    normal = np.zeros((C, 3), np.float32)
    valid = np.zeros(C, bool)
    if k:
        pts[:k] = m.mp_pos[ids]
        desc[:k] = m.mp_desc[ids].view(np.int32)
        min_d[:k] = m.mp_min_dist[ids]
        max_d[:k] = m.mp_max_dist[ids]
        normal[:k] = m.mp_normal[ids]
        valid[:k] = True
    return ids, (pts, desc, min_d, max_d, normal, valid)


@labelled("fused_step.upload")
def upload_candidates(arrays, device: torch.device):
    """Candidate arrays as tensors on `device`. On CUDA they go through pinned
    memory with non-blocking copies, so the upload does not wait for the
    device."""
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


def bind_step(u: fused_track.UnpackedStep, prev_mp_idx: np.ndarray, cand_ids: np.ndarray):
    """The map points a step bound (frontend_pipelined.py:246-268): each
    feature's landmark from the previous frame's bindings (`src_prev`) or
    the candidates (`src_cand`), a landmark bound twice (a motion match and a
    candidate duplicate) kept at its first row. Returns (mp_idx [N] int32,
    has_cand [N] bool: bound from a candidate, outlier [N] bool)."""
    n = len(u.src_prev)
    mp_idx = np.full(n, -1, np.int32)
    has_prev = u.src_prev >= 0
    mp_idx[has_prev] = prev_mp_idx[u.src_prev[has_prev]]
    has_cand = (u.src_cand >= 0) & (mp_idx < 0)
    if len(cand_ids):
        mp_idx[has_cand] = cand_ids[u.src_cand[has_cand]]
    else:
        has_cand[:] = False
    rows = np.nonzero(mp_idx >= 0)[0]
    _, first = np.unique(mp_idx[rows], return_index=True)
    dup = np.ones(len(rows), bool)
    dup[first] = False
    mp_idx[rows[dup]] = -1
    has_cand &= mp_idx >= 0  # the dedup may have dropped a binding
    return mp_idx, has_cand, (mp_idx >= 0) & ~u.inlier


def step_frame(u: fused_track.UnpackedStep, frame_id: int, timestamp: float, mp_idx,
               outlier) -> FrameData:
    """The host frame of a processed step."""
    return FrameData(frame_id=frame_id, timestamp=timestamp, Tcw=u.Tcw, xy=u.xy, xy_raw=u.xy,
                     octave=u.octave, angle=u.angle, desc=u.desc, valid=u.valid,
                     mp_idx=mp_idx, outlier=outlier)


def count_visible_found(m, cand_ids, u: fused_track.UnpackedStep, mp_idx, has_cand) -> None:
    """The visible and found counts of a step (Tracking.cc:1412, :1438):
    candidates in the frustum were visible, candidates bound as inliers
    found. The caller holds the map lock."""
    if len(cand_ids):
        m.mp_visible[cand_ids[u.cand_in_view[: len(cand_ids)]]] += 1
        m.mp_found[mp_idx[has_cand & u.inlier]] += 1


class PipelinedFrontend:
    def __init__(self, system, n_cand: int = 2048, lag: int = 1):
        self.sys = system
        self.tracker = system.tracker
        self.cfg = system.cfg
        self.n_cand = n_cand
        self.lag = lag
        self.device = system.device
        self.step = fused_track.FusedTrackStep(system.cfg, n_cand, self.device)
        self.n_feat = self.step.n_feat
        self._carry = None
        self._carry_src = -1  # global frame id whose features the carry holds
        self._mp_hist: dict = {}  # frame id -> post-processing mp_idx array
        self._reseed = False
        self._seen_version = -1  # map.version the carry was last anchored to
        self._start = 0
        # optional diagnostic callback: hook(frame_id, FrameData, UnpackedStep)
        # after the host processing of every fused frame (map lock NOT held)
        self.debug_hook = None
        # frame id -> wall-clock completion time (time.perf_counter); a
        # re-tracked frame overwrites its entry. Deltas between consecutive
        # completions are the real per-frame latencies, with anchor landings
        # and keyframe stalls in the tail (the reference times every frame,
        # mono_ETH.cc:107-151)
        self.completion_walls = profiling.Newest(FRAME_RECORDS)
        # per-frame host records: path ("fused" / "classic"), its host ms,
        # the NMI backpressure wait charged to it (`nmi_wait_ms`), its start
        # and completion on the profiler's clock (`t_dispatch_ns`,
        # `t_done_ns`), and for fused frames the waits for the map lock
        # (dispatch and processing), the candidate build, the dispatch, the
        # step's host time and its parts (`FusedTrackStep.times`), the wait
        # for the readback, the processing (lock wait excluded), the keyframe
        # made (`kf`, `kf_ms`), reseeds, rebases and the keyframe decision's
        # inputs (`Tracker.kf_check`)
        self.records = profiling.Newest(FRAME_RECORDS)
        self._nmi_wait_ms = 0.0  # backpressure wait not yet charged to a frame
        self.n_rewinds = {"fail": 0, "reseed": 0}
        self.n_rebases = 0

    # ------------------------------------------------------------ main drive

    def run(self, frames, timestamps, start_id: int = 0) -> list:
        """Track a sequence chunk (frame ids start_id .. start_id+len-1) of
        uint8 images [H, W] (numpy or tensors); returns a TrackResult a frame.
        Chunks may be fed one after another: the tracker's and the carry's
        state persist across calls."""
        self._start = start_id
        tr = self.tracker
        n = len(frames)
        results: list = [None] * n
        inflight: deque = deque()
        i = 0
        while i < n or inflight:
            # NMI backpressure, as Tracker.process_frame: after >= 2 NMI-due
            # keyframes skipped while the worker was busy, wait its sweep out
            # (outside the map lock: the worker's landing takes it)
            worker = getattr(self.sys, "nmi_worker", None)
            if worker is not None and tr.nmi_due_skips >= 2 and worker.busy():
                t0 = time.perf_counter()
                with _NMI_BACKPRESSURE():
                    worker.flush(timeout=600.0)
                self._nmi_wait_ms += (time.perf_counter() - t0) * 1e3
                tr.nmi_due_skips = 0
            if tr.state == TrackingState.OK and self._carry is not None and i < n:
                inflight.append(self._dispatch(frames[i], i))
                i += 1
                if len(inflight) > self.lag:
                    status = self._process(inflight.popleft(), frames, timestamps, results)
                    if status is not True:
                        i = self._rewind(status, inflight, results)
                continue

            if inflight:  # drain the fused results left
                status = self._process(inflight.popleft(), frames, timestamps, results)
                if status is not True:
                    i = self._rewind(status, inflight, results)
                continue

            if i >= n:
                break
            # the classic path (init / lost / recovery / first frame after a fail)
            t_ns = profiling.clock_ns()
            t0 = time.perf_counter()
            with _CLASSIC():
                res = tr.process_frame(start_id + i, float(timestamps[i]), frames[i])
            t1 = time.perf_counter()
            results[i] = res
            self.completion_walls[start_id + i] = t1
            self.records[start_id + i] = dict(path="classic", ms=(t1 - t0) * 1e3,
                                              state=res.state.name,
                                              nmi_wait_ms=self._take_nmi_wait(),
                                              t_dispatch_ns=t_ns, t_done_ns=profiling.clock_ns())
            i += 1
            if res.state == TrackingState.OK and tr.last_frame is not None \
                    and tr.last_frame.Tcw is not None:
                with self.sys.map.lock:
                    self._carry = fused_track.carry_from_frame(tr.last_frame, self.sys.map,
                                                               tr.velocity, self.device)
                    self._seen_version = self.sys.map.version
                self._carry_src = start_id + i - 1
                self._mp_hist[start_id + i - 1] = tr.last_frame.mp_idx.copy()
        return results

    def _rewind(self, status: str, inflight: deque, results: list) -> int:
        """Drop the frames in flight and return the first unprocessed frame:
        on "fail" the carry goes too, so they take the classic path; on
        "reseed" the re-anchored carry stays and they are re-dispatched
        against the fresh map (tracking a frame against a pre-keyframe carry
        and promoting it to a keyframe bakes stale poses into the map)."""
        self.n_rewinds[status] += 1
        inflight.clear()
        if status == "fail":
            self._carry = None
        return results.index(None) if None in results else len(results)

    # ------------------------------------------------------------- internals

    def _take_nmi_wait(self) -> float:
        """The backpressure wait not yet charged to a frame, charged now."""
        ms, self._nmi_wait_ms = self._nmi_wait_ms, 0.0
        return ms

    @labelled("frontend.dispatch")
    def _dispatch(self, gray, idx: int):
        t_ns = profiling.clock_ns()
        with _MapHeld(self.sys.map.lock) as held:
            t_lock = time.perf_counter()
            cand_ids, arrays = self._local_candidates()
        t1 = time.perf_counter()
        # the carry's feature rows belong to frame `self._carry_src`; its
        # landmark ids are resolved at processing time (that frame has been
        # processed by then: lag-1 ordering)
        src = self._carry_src
        img = torch.as_tensor(gray).to(self.device)
        out = self.step(img, self._carry, *upload_candidates(arrays, self.device))
        packed = HostCopy(out.packed)  # waited for after the next dispatch
        self._carry = out.carry
        self._carry_src = self._start + idx
        t2 = time.perf_counter()
        # the step's host times (a step a caller wrapped may keep none)
        return (idx, packed, src, cand_ids, dict(lock_ms=held.wait_ms,
                                                 cand_ms=(t1 - t_lock) * 1e3,
                                                 dispatch_ms=(t2 - t1) * 1e3,
                                                 **getattr(self.step, "times", {}),
                                                 t_dispatch_ns=t_ns))

    @labelled("frontend.candidates")
    def _local_candidates(self):
        """The candidate arrays from the most recently PROCESSED frame (one
        frame stale): `local_candidates` over its local keyframes, the
        pre-filter at its pose."""
        tr = self.tracker
        kfs = tr._local_keyframes(tr.last_frame)
        return local_candidates(self.sys.map, self.cfg, kfs, tr.ref_kf, tr.last_frame.Tcw,
                                self.n_cand)

    @labelled("frontend.process")
    def _process(self, item, frames, timestamps, results):
        """Read back and process one fused frame on the host. Returns True on
        success, "fail" when the frame misses the tracking gates, or
        "reseed" when this frame mutated the map or met a landed correction."""
        idx, packed, prev_src, cand_ids, rec = item
        tr = self.tracker
        fid = self._start + idx
        t0 = time.perf_counter()
        with _READBACK_WAIT():
            buf = packed.wait()
        u = fused_track.unpack_step(buf, self.n_feat, self.n_cand)
        t1 = time.perf_counter()
        if u.n_matches1 < 20 or u.n_inliers < 10:
            self.records[fid] = dict(rec, path="fused", wait_ms=(t1 - t0) * 1e3,
                                     outcome="fail", n_matches1=u.n_matches1,
                                     n_inliers=u.n_inliers)
            return "fail"
        mp_idx, has_cand, outlier = bind_step(u, self._mp_hist[prev_src], cand_ids)
        frame = step_frame(u, fid, float(timestamps[idx]), mp_idx, outlier)
        bound = mp_idx >= 0

        rebased = False
        with _MapHeld(self.sys.map.lock) as held:
            p_lock = held.wait_ms
            m = self.sys.map
            if m.version != self._seen_version:
                # An async map correction (BA write-back, NMI anchor, loop,
                # culling) landed since this frame was dispatched: the chain's
                # pose predates it. Rebase it through the PREVIOUS processed
                # frame, whose Tcr was recorded before the landing:
                # UpdateLastFrame semantics (Tracking.cc:1020) recover its
                # corrected pose, and the delta carries this frame onto the
                # corrected map; then reseed the carry below. Without it the
                # stale chain fights the corrected candidates in pose GN until
                # the next keyframe.
                self.rebase(frame)
                rebased = True
                self._seen_version = m.version
                self._reseed = True
            count_visible_found(m, cand_ids, u, mp_idx, has_cand)
            still = m.mp_valid[np.maximum(mp_idx, 0)] & bound
            frame.mp_idx = np.where(still, mp_idx, -1)

            tr.velocity = u.velocity
            tr._local_keyframes(frame)  # refresh ref_kf from the new bindings

            is_kf = False
            nmi_reloc = False
            made = {}
            tr.kf_check = None
            if tr._need_new_keyframe(frame, u.n_inliers):
                t_kf = time.perf_counter()
                with _KEYFRAME():
                    tr._gray = frames[idx]
                    nmi_reloc = tr.keyframe_with_nmi(frame)
                made = dict(kf=int(tr.ref_kf), kf_ms=(time.perf_counter() - t_kf) * 1e3)
                is_kf = True
                self._reseed = True  # the map mutated: re-anchor the device chain

            frame.mp_idx[frame.outlier] = -1
            frame.outlier[:] = False
            tr.record_frame(fid, float(timestamps[idx]), frame)
            self._mp_hist[fid] = frame.mp_idx.copy()
            # only ids >= the carry source are looked up again: prune
            for old in [k for k in self._mp_hist if k < fid - 8]:
                del self._mp_hist[old]

            reseed = self._reseed
            if reseed:
                tr._update_last_frame(frame)  # adopt the BA/NMI-corrected anchor
                self._carry = fused_track.carry_from_frame(frame, m, tr.velocity, self.device)
                self._carry_src = fid
                self._seen_version = m.version
                self._reseed = False

        if fid % 10 == 0:
            self.sys.log(f"frame {fid}: fused n1={u.n_matches1} inl={u.n_inliers} "
                         f"cand={int(len(cand_ids))}")
        if self.debug_hook is not None:
            self.debug_hook(fid, frame, u)
        results[idx] = TrackResult(TrackingState.OK, frame.Tcw, u.n_inliers, is_kf, nmi_reloc)
        t2 = time.perf_counter()
        self.completion_walls[fid] = t2
        self.records[fid] = dict(rec, path="fused", wait_ms=(t1 - t0) * 1e3,
                                 lock_ms=rec["lock_ms"] + p_lock,
                                 process_ms=(t2 - t1) * 1e3 - p_lock,
                                 outcome="reseed" if reseed else "ok",
                                 keyframe=is_kf, rebased=rebased, n_matches1=u.n_matches1,
                                 n_inliers=u.n_inliers, n_cand=int(len(cand_ids)),
                                 kf_check=tr.kf_check, nmi_wait_ms=self._take_nmi_wait(),
                                 t_done_ns=profiling.clock_ns(), **made)
        return "reseed" if reseed else True

    def rebase(self, frame: FrameData) -> np.ndarray:
        """Carry `frame`'s chain pose onto the corrected map: the previous
        processed frame re-anchored through its reference keyframe
        (`Tracker._update_last_frame`), and the same correction applied to
        `frame`: Tcw <- (T_prev_new inv(T_prev_old)) Tcw. Returns the
        correction (identity when there is nothing to rebase through)."""
        prev = self.tracker.last_frame
        delta = np.eye(4, dtype=np.float32)
        if prev is not None and prev.Tcw is not None and prev.Tcr is not None:
            T_old = prev.Tcw.copy()
            self.tracker._update_last_frame(prev)
            delta = prev.Tcw @ np.linalg.inv(T_old)
            frame.Tcw = (delta @ frame.Tcw).astype(np.float32)
            self.n_rebases += 1
        return delta
