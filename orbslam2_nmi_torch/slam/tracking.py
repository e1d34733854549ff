"""Tracking front-end: per-frame pose estimation, keyframe policy, NMI triggers.

Port of `orbslam2_nmi_tpu/slam/tracking.py`, the equivalent of
src/Tracking.cc. Host Python orchestrates; ORB extraction, windowed
matching, triangulation, PnP and the pose-only LM run as torch ops on the
tracker's device.

Pipeline (Tracking::Track, reference src/Tracking.cc:356-692):
  NOT_INITIALIZED -> InitializeWithNMI at frame 0 and frame NMI.Offset
                     (Tracking.cc:2181-2372; `slam/initialization`), or the
                     classic two-view init without init poses
  OK  -> TrackWithMotionModel (:1083) -> TrackReferenceKeyFrame fallback (:950)
      -> TrackLocalMap (:1172) -> NeedNewKeyFrame/CreateNewKeyFrame (:1217,:1313)
      -> NMI relocalization every `reloc_frequency`-th keyframe (:598-623)
  LOST -> BoW + PnP relocalization; reset if <= 5 keyframes (:637-643)

Drift accumulators mirror Tracking.cc:648-662: per-axis |delta| of camera
translation and Euler angles accumulated per frame, reset per axis after a
successful NMI relocalization of a searched axis (:600-612).

Where the port differs:
  * Random draws. The JAX package draws RANSAC rows from `jax.random` keys
    (PRNGKey(13) for the two-view init, PRNGKey(11) for relocalization). The
    tracker draws from one seeded CPU `torch.Generator` through two
    replaceable hooks, `draw_samples(n_rows, n_valid, n_hyp, size)` (PnP)
    and `draw_two_view(n_rows, n_valid, n_hyp)` (H and F rows), and the
    solvers take the rows as arguments; the tests plug in the JAX package's
    draws.
  * Readbacks. Every device result reaches the host through
    `utils/readback.to_host`, which waits on an event and so releases the
    interpreter lock: the classic path runs under `map.lock` beside the
    mapping and NMI workers, and a `.cpu()` there would starve them.
  * Frames may be numpy or torch images; a device image stays on the device
    (extraction and the NMI sweep read it there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import SystemConfig
from orbslam2_nmi_torch.geometry import camera as cam_geo
from orbslam2_nmi_torch.ops import matching
from orbslam2_nmi_torch.ops.orb import extract_orb
from orbslam2_nmi_torch.slam import initialization
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.solvers import pnp, pose_gn, two_view_init
from orbslam2_nmi_torch.utils import profiling
from orbslam2_nmi_torch.utils.bucketing import bucket, pad_rows, row_mask
from orbslam2_nmi_torch.utils.readback import to_host

PNP_HYPOTHESES = 128  # pnp_ransac's n_hypotheses in the JAX package
RELOC_SEED = 11  # the JAX tracker's relocalization key, PRNGKey(11)


class TrackingState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackResult:
    state: TrackingState
    Tcw: Optional[np.ndarray]
    n_inliers: int
    is_keyframe: bool
    nmi_relocalized: bool = False
    nmi_score: float = 0.0


def euler_zyx_angles(R: np.ndarray) -> np.ndarray:
    """Euler angles as used by the drift accumulator
    (rotationMatrixToEulerAngles, Tracking.cc:655)."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        return np.array(
            [np.arctan2(R[2, 1], R[2, 2]), np.arctan2(-R[2, 0], sy), np.arctan2(R[1, 0], R[0, 0])]
        )
    return np.array([np.arctan2(-R[1, 2], R[1, 1]), np.arctan2(-R[2, 0], sy), 0.0])


def local_keyframes(map_store: MapStore, mp_idx: np.ndarray, ref_kf: int):
    """UpdateLocalKeyFrames (Tracking.cc:1486): the keyframes that observe
    the bound points `mp_idx`, most shared first (at most 80; ties in the
    order each was first seen, point by point), the first of them the new
    reference keyframe, and the 10 best covisibles of the first 10. Without
    bound points, the reference keyframe alone. Returns (keyframes, reference
    keyframe). The counting is numpy; the order is that of the JAX package's
    dict and sort (tracking.py:779-798)."""
    m = map_store
    bound = mp_idx[mp_idx >= 0]
    if len(bound) == 0:
        return (np.array([ref_kf], np.int64) if ref_kf >= 0 else np.zeros(0, np.int64)), ref_kf
    obs = m.mp_obs_kf[bound]
    seen = obs[np.arange(obs.shape[1])[None, :] < m.mp_obs_n[bound][:, None]]
    if len(seen) == 0:
        return np.zeros(0, np.int64), ref_kf
    uniq, first, counts = np.unique(seen, return_index=True, return_counts=True)
    kfs = [int(k) for k in uniq[np.lexsort((first, -counts))][:80]]
    ref_kf = kfs[0]
    expanded = set(kfs)
    for k in kfs[:10]:
        expanded.update(m.best_covisible(k, 10).tolist())
    return np.fromiter(expanded, np.int64), ref_kf


def _draw(generator: torch.Generator, n_valid: int, n_hypotheses: int, size: int) -> np.ndarray:
    """[n_hypotheses, size] rows, each drawn uniformly without replacement
    from rows 0 .. n_valid - 1, on a CPU generator."""
    keys = torch.rand((n_hypotheses, n_valid), generator=generator)
    return torch.argsort(keys, dim=1)[:, :size].numpy()


class Tracker:
    def __init__(
        self,
        cfg: SystemConfig,
        map_store: MapStore,
        local_mapper=None,
        nmi_localizer=None,
        log_fn: Optional[Callable[[str], None]] = None,
        system=None,
        device="cuda",
    ):
        self.device = kernels.resolve_device(device, "Tracker")
        self.cfg = cfg
        self.map = map_store
        self.local_mapper = local_mapper
        self.nmi = nmi_localizer
        self.system = system  # for vocabulary / database / loop closer / workers
        self.log = log_fn or (lambda s: None)
        self.generator = torch.Generator().manual_seed(RELOC_SEED)  # on the CPU
        self.draw_samples = self._draw_samples
        self.draw_two_view = self._draw_two_view

        self.state = TrackingState.NOT_INITIALIZED
        self.velocity: Optional[np.ndarray] = None  # Tcw_cur @ inv(Tcw_last)
        self.last_frame: Optional[FrameData] = None
        self.init_frame: Optional[FrameData] = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.kfs_since_last_nmi: int = 0
        self.dist_since_nmi = np.zeros(3)
        self.rot_since_nmi = np.zeros(3)
        # consecutive failed NMI relocalizations: each widens the next search
        # window (the 2 %-of-motion step sizing, Tracking.cc:2003, assumes
        # ~1 % drift; past the +-1-step span failures would cascade)
        self.nmi_fail_streak: int = 0
        # consecutive NMI-due keyframes skipped because the async worker was
        # busy: at >= 2 the frame loop waits for the in-flight sweep
        # (backpressure), so anchors keep their cadence
        self.nmi_due_skips: int = 0
        self.n_resets: int = 0
        # localization-only mode (System::ActivateLocalizationMode,
        # System.cc:298-310); vo_mode is the reference's mbVO
        # (Tracking.cc:402-530, :1163-1165)
        self.only_tracking: bool = False
        self.vo_mode: bool = False
        # last OK-tracked pose; survives reset() and seeds NMI re-initialization
        self._last_good_Tcw: Optional[np.ndarray] = None
        self._reinit_fails: int = 0
        # relative-pose rows (frame_id, t, Tcr, ref_kf, lost, previous_poses):
        # mlRelativeFramePoses et al. (Tracking.cc:667-691), recomposed at save
        # time (io/trajectory.recompose_trajectory)
        self.trajectory: list = []
        self._gray = None
        self.relocalizations: list = []  # (frame id, keyframe, inliers) a success
        # the inputs of the last keyframe decision (`_need_new_keyframe`)
        self.kf_check: Optional[dict] = None

        n_lv = cfg.orb.n_levels
        sf = cfg.orb.scale_factor
        self.inv_sigma2 = (1.0 / (sf ** np.arange(n_lv)) ** 2).astype(np.float32)
        self.K = cfg.camera.K
        self.dist_coeffs = np.array(
            [cfg.camera.k1, cfg.camera.k2, cfg.camera.p1, cfg.camera.p2, cfg.camera.k3],
            np.float32,
        )
        # init poses (NMI.Init1/Init2 are Twc matrices in the yaml)
        self._init_T1: Optional[np.ndarray] = None
        self._init_T2: Optional[np.ndarray] = None
        if cfg.nmi.init1 is not None:
            self._init_T1 = np.linalg.inv(cfg.nmi.init1.astype(np.float32))
        if cfg.nmi.init2 is not None:
            self._init_T2 = np.linalg.inv(cfg.nmi.init2.astype(np.float32))

    def set_init_poses(self, Tcw1: np.ndarray, Tcw2: np.ndarray):
        """Supply init poses directly (tests / model-free runs)."""
        self._init_T1 = Tcw1.astype(np.float32)
        self._init_T2 = Tcw2.astype(np.float32)

    # ---------------------------------------------------------------- draws

    def _draw_samples(self, n_rows: int, n_valid: int, n_hypotheses: int,
                      size: int) -> np.ndarray:
        return _draw(self.generator, n_valid, n_hypotheses, size)

    def _draw_two_view(self, n_rows: int, n_valid: int, n_hypotheses: int):
        return (_draw(self.generator, n_valid, n_hypotheses, 4),
                _draw(self.generator, n_valid, n_hypotheses, 8))

    def _up(self, a, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
        if a.dtype == np.uint32:  # descriptor words: their bits as int32
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ per frame

    def process_frame(self, frame_id: int, timestamp: float, gray_u8) -> TrackResult:
        """Track one uint8 image [H, W] (numpy, or a tensor on any device)."""
        # NMI backpressure, outside the map lock: the worker's landing takes it
        worker = getattr(self.system, "nmi_worker", None) if self.system else None
        if worker is not None and self.nmi_due_skips >= 2 and worker.busy():
            worker.flush(timeout=600.0)
            self.nmi_due_skips = 0
        # feature extraction runs outside the map lock (Frame construction
        # precedes the Tracking.cc:377 mutex in the reference)
        self._gray = gray_u8
        frame = self._make_frame(frame_id, timestamp, gray_u8)
        with self.map.lock:
            return self._process_tracked_frame(frame_id, timestamp, frame)

    def _process_tracked_frame(self, frame_id, timestamp, frame) -> TrackResult:
        if self.state == TrackingState.NOT_INITIALIZED:
            res = self._initialize(frame)
        else:
            res = self._track(frame)
            # reset if lost soon after initialization (Tracking.cc:637-643)
            if res.state == TrackingState.LOST and self.map.n_keyframes <= 5:
                self.log("track lost soon after initialization, resetting")
                self.reset()
        self.record_frame(frame_id, timestamp, frame)
        return res

    def record_frame(self, frame_id: int, timestamp: float, frame: FrameData):
        """Per-frame bookkeeping shared by the classic and fused front-ends:
        drift accumulators (Tracking.cc:648-662) and the relative-pose
        trajectory row (Tracking.cc:667-691). Sets `last_frame`."""
        if (
            frame.Tcw is not None
            and self.last_frame is not None
            and self.last_frame.Tcw is not None
            # only OK-tracked poses feed the accumulators (Tracking.cc:648-662)
            and self.state == TrackingState.OK
            and np.isfinite(frame.Tcw).all()
            and np.isfinite(self.last_frame.Tcw).all()
        ):
            self.dist_since_nmi += np.abs(frame.Tcw[:3, 3] - self.last_frame.Tcw[:3, 3])
            self.rot_since_nmi += np.abs(euler_zyx_angles(frame.Tcw[:3, :3])
                                         - euler_zyx_angles(self.last_frame.Tcw[:3, :3]))
            self._last_good_Tcw = frame.Tcw.copy()

        # the pose RELATIVE to the reference keyframe (Tracking.cc:667-691),
        # snapped to identity when the frame IS the keyframe (:677-683)
        if frame.Tcw is not None and self.ref_kf >= 0:
            Tcr = frame.Tcw @ np.linalg.inv(self.map.kf_Tcw[self.ref_kf])
            if float(np.abs(Tcr - np.eye(4)).sum()) < 0.01:
                Tcr = np.eye(4, dtype=np.float32)
            frame.ref_kf = self.ref_kf
            frame.Tcr = Tcr.astype(np.float32)
            self.trajectory.append((frame_id, timestamp, frame.Tcr, frame.ref_kf, False,
                                    [p.copy() for p in frame.previous_poses]))
        elif self.trajectory:
            # tracking lost: replicate the last row flagged lost (Tracking.cc:688-691)
            last = self.trajectory[-1]
            self.trajectory.append((frame_id, timestamp, last[2], last[3], True, []))
        self.last_frame = frame

    def _image(self, gray_u8) -> torch.Tensor:
        if isinstance(gray_u8, torch.Tensor):
            return gray_u8.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(gray_u8)).to(self.device)

    def _make_frame(self, frame_id: int, timestamp: float, gray_u8) -> FrameData:
        feats = extract_orb(self._image(gray_u8), self.cfg.orb)
        xy_raw = to_host(feats.xy).copy()
        xy = xy_raw
        if self.cfg.camera.has_distortion:
            xy = to_host(cam_geo.undistort_points(self.K, self.dist_coeffs, feats.xy)).copy()
        return FrameData(
            frame_id=frame_id, timestamp=timestamp, Tcw=None, xy=xy, xy_raw=xy_raw,
            octave=to_host(feats.octave).copy(), angle=to_host(feats.angle).copy(),
            desc=to_host(feats.desc).view(np.uint32).copy(), valid=to_host(feats.valid).copy(),
        )

    # ---------------------------------------------------------- initialization

    def _initialize(self, frame: FrameData) -> TrackResult:
        """InitializeWithNMI (Tracking.cc:2181-2372): pose frame 0 and frame
        `offset` from NMI (or supplied poses), then `initialization.
        create_initial_map` (match, triangulate, global BA with both KFs
        NMI-fixed, so the map's scale is metric).

        Re-initialization after a reset (which the reference cannot do mid-
        sequence): the init hypotheses are seeded from the last well-tracked
        pose and the NMI latch must clear the accept threshold; a failed latch
        retries on later frames with a wider search."""
        cfg = self.cfg.nmi
        reinit = self.n_resets > 0 and self.nmi is not None
        if frame.frame_id == 0 or self.init_frame is None:
            if self._init_T1 is None or (self.n_resets > 0 and self.nmi is None):
                # classic monocular init path: just remember the first frame
                frame.Tcw = np.eye(4, dtype=np.float32)
                self.init_frame = frame
                return TrackResult(self.state, frame.Tcw, 0, False)
            if reinit:
                if self._last_good_Tcw is None:
                    return TrackResult(self.state, None, 0, False)
                frame.Tcw = self._last_good_Tcw.copy()
                ok = self._run_nmi(frame, initializing=True,
                                   search_scale=1.0 + 0.5 * min(self._reinit_fails, 8))
                if not ok:
                    self._reinit_fails += 1
                    self.log(f"frame {frame.frame_id}: re-init NMI latch failed "
                             f"({self._reinit_fails}), retrying wider")
                    return TrackResult(self.state, None, 0, False)
                self._reinit_fails = 0
            else:
                frame.Tcw = self._init_T1.copy()
                self._init_latch(frame, "nmi.init_latch.1")
            self.init_frame = frame
            return TrackResult(self.state, frame.Tcw, 0, False)

        if self._init_T1 is None or (self.n_resets > 0 and self.nmi is None):
            return self._initialize_classic(frame)

        if frame.frame_id < self.init_frame.frame_id + cfg.offset:
            return TrackResult(self.state, None, 0, False)

        if reinit:
            # second latch seeded from the first's NMI-refined pose
            frame.Tcw = self.init_frame.Tcw.copy()
            if not self._run_nmi(frame, initializing=True):
                self.log(f"frame {frame.frame_id}: re-init second NMI latch failed, retrying")
                self.init_frame = None
                return TrackResult(self.state, None, 0, False)
        else:
            frame.Tcw = (self._init_T2 if self._init_T2 is not None else self._init_T1).copy()
            self._init_latch(frame, "nmi.init_latch.2")

        res = initialization.create_initial_map(
            self.cfg, self.map, self.local_mapper, self.init_frame, frame,
            k2_anchored=frame.nmi_relocalized or self.nmi is None, log_fn=self.log,
            device=self.device)
        if not res.ok:
            self.init_frame = None
            return TrackResult(self.state, frame.Tcw, 0, False)
        self.ref_kf = res.k2
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        return TrackResult(self.state, frame.Tcw, res.n_points, True)

    def _initialize_classic(self, frame: FrameData) -> TrackResult:
        """Stock monocular initialization (MonocularInitialization,
        Tracking.cc:755 + CreateInitialMapMonocular :882): two-view H/F RANSAC
        reconstruction, map rescaled to unit median depth. It serves
        model-free operation."""
        f1 = self.init_frame
        idx, _ = matching.match_descriptors(
            self._up(f1.desc), self._up(f1.valid), self._up(frame.desc), self._up(frame.valid),
            spatial_mask=matching.window_mask(self._up(f1.xy), self._up(frame.xy), 100.0),
            max_dist=matching.TH_LOW, nn_ratio=0.9,
            angle_a=self._up(f1.angle), angle_b=self._up(frame.angle), check_rotation=True,
        )
        idx = to_host(idx)
        m1 = np.nonzero(idx >= 0)[0]
        if len(m1) < 100:
            if frame.frame_id - f1.frame_id > 20:
                self.init_frame = frame  # restart with a fresh reference
                frame.Tcw = np.eye(4, dtype=np.float32)
            return TrackResult(self.state, None, 0, False)
        m2 = idx[m1]
        nb = bucket(len(m1))
        h_rows, f_rows = self.draw_two_view(nb, len(m1), two_view_init.N_HYPOTHESES)
        res = two_view_init.initialize_two_view(
            h_rows, f_rows, self.K, self._up(pad_rows(f1.xy[m1], nb)),
            self._up(pad_rows(frame.xy[m2], nb)), self._up(row_mask(len(m1), nb)))
        if not bool(to_host(res.ok)):
            return TrackResult(self.state, None, 0, False)
        inl = to_host(res.inliers)[: len(m1)]
        pts = to_host(res.points_w)[: len(m1)]
        T2 = to_host(res.Tcw2).copy()
        # normalize to unit median depth (CreateInitialMapMonocular :896)
        med = float(np.median(pts[inl][:, 2]))
        if med <= 0:
            return TrackResult(self.state, None, 0, False)
        pts = pts / med
        T2[:3, 3] /= med

        f1.Tcw = np.eye(4, dtype=np.float32)
        frame.Tcw = T2.astype(np.float32)
        m = self.map
        k1 = m.add_keyframe(f1.Tcw, f1.frame_id, f1.timestamp, f1.xy, f1.octave, f1.angle,
                            f1.desc, f1.valid)
        k2 = m.add_keyframe(frame.Tcw, frame.frame_id, frame.timestamp, frame.xy, frame.octave,
                            frame.angle, frame.desc, frame.valid)
        for i in np.nonzero(inl)[0]:
            fa, fb = int(m1[i]), int(m2[i])
            p = m.add_map_point(pts[i], f1.desc[fa], k1, np.zeros(3, np.float32))
            m.add_observation(k1, fa, p)
            m.add_observation(k2, fb, p)
            m.update_point_stats(p, self.K, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
            frame.mp_idx[fb] = p
        if self.local_mapper is not None:
            self.local_mapper.global_ba(iters=20)
            frame.Tcw = m.kf_Tcw[k2].copy()
        self.ref_kf = k2
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        self.log(f"classic initialization: {int(inl.sum())} points, "
                 f"{'H' if bool(to_host(res.used_homography)) else 'F'} model")
        return TrackResult(self.state, frame.Tcw, int(inl.sum()), True)

    # ---------------------------------------------------------------- track

    def _track(self, frame: FrameData) -> TrackResult:
        if self.only_tracking:
            return self._track_localization_only(frame)
        ok = False
        if self.state == TrackingState.LOST:
            ok = self._relocalize(frame)
            if ok:
                self.state = TrackingState.OK
                self.velocity = None
        else:
            if self.velocity is not None and self.last_frame is not None:
                ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)

        if not ok:
            self.state = TrackingState.LOST
            self.log(f"frame {frame.frame_id}: tracking LOST")
            return TrackResult(self.state, None, 0, False)

        n_inliers = self._track_local_map(frame)
        if n_inliers < 10:
            self.state = TrackingState.LOST
            self.log(f"frame {frame.frame_id}: local map tracking failed ({n_inliers})")
            return TrackResult(self.state, None, n_inliers, False)

        if self.last_frame is not None and self.last_frame.Tcw is not None:
            self.velocity = frame.Tcw @ np.linalg.inv(self.last_frame.Tcw)

        is_kf = False
        nmi_reloc = False
        if self._need_new_keyframe(frame, n_inliers):
            is_kf = True
            nmi_reloc = self.keyframe_with_nmi(frame)

        # drop outlier bindings so the next frame doesn't use them (Tracking.cc:627)
        frame.mp_idx[frame.outlier] = -1
        frame.outlier[:] = False
        return TrackResult(self.state, frame.Tcw, n_inliers, is_kf, nmi_reloc)

    def keyframe_with_nmi(self, frame: FrameData) -> bool:
        """Create a keyframe of `frame` with the NMI relocalization due every
        `reloc_frequency`-th keyframe (Tracking.cc:598-623): synchronous
        before the keyframe without an NMI worker, else handed to the worker
        after it; a busy worker keeps the counter due, and the skip feeds the
        backpressure. Returns whether a synchronous NMI relocalized."""
        nmi_due = self.nmi is not None and self.kfs_since_last_nmi + 1 == self.cfg.nmi.reloc_frequency
        worker = getattr(self.system, "nmi_worker", None) if self.system else None
        nmi_reloc = False
        if nmi_due and worker is None:
            nmi_reloc = self._run_nmi(frame, initializing=False)
        self._create_keyframe(frame)
        attempted = True
        if nmi_due and worker is not None:
            attempted = self._submit_async_nmi(frame)
        if nmi_due and not attempted:
            self.nmi_due_skips += 1  # busy: counter stays due, next KF retries
        else:
            if nmi_due:
                self.nmi_due_skips = 0
            self.kfs_since_last_nmi += 1
            if self.kfs_since_last_nmi >= self.cfg.nmi.reloc_frequency:
                self.kfs_since_last_nmi = 0
        return nmi_reloc

    def _track_localization_only(self, frame: FrameData) -> TrackResult:
        """The mbOnlyTracking branch of Track (Tracking.cc:475-530, :546-552):
        map frozen, no keyframes. In vo_mode (mbVO: the last frame held < 10
        map inliers) the pose comes from motion-model tracking AND
        relocalization side by side, preferring a successful relocalization
        (which re-attaches the local map and clears vo_mode)."""
        ok = False
        if self.state == TrackingState.LOST:
            ok = self._relocalize(frame)
            if ok:
                self.state = TrackingState.OK
                self.velocity = None
        elif not self.vo_mode:
            if self.velocity is not None and self.last_frame is not None:
                ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)
        else:
            ok_mm = False
            mm_state = None
            if self.velocity is not None and self.last_frame is not None:
                ok_mm = self._track_with_motion_model(frame)
                if ok_mm:
                    mm_state = (frame.Tcw.copy(), frame.mp_idx.copy(), frame.outlier.copy())
            ok_reloc = self._relocalize(frame)
            if ok_mm and not ok_reloc:
                frame.Tcw, frame.mp_idx, frame.outlier = mm_state
            elif ok_reloc:
                self.vo_mode = False  # Tracking.cc:518
            ok = ok_mm or ok_reloc

        n_inliers = 0
        if ok and not self.vo_mode:
            # Tracking.cc:551: no TrackLocalMap while mbVO
            n_inliers = self._track_local_map(frame)
            ok = n_inliers >= 10

        if not ok:
            self.state = TrackingState.LOST
            self.log(f"frame {frame.frame_id}: tracking LOST (localization-only)")
            return TrackResult(self.state, None, 0, False)

        self.state = TrackingState.OK
        if self.last_frame is not None and self.last_frame.Tcw is not None:
            self.velocity = frame.Tcw @ np.linalg.inv(self.last_frame.Tcw)
        frame.mp_idx[frame.outlier] = -1
        frame.outlier[:] = False
        return TrackResult(self.state, frame.Tcw, n_inliers, False)

    def _pose_optimize(self, frame: FrameData) -> int:
        """The pose-only LM (Optimizer::PoseOptimization) on the frame's bound
        points, padded to a bucketed size; marks the outliers."""
        idxs = np.nonzero(frame.mp_idx >= 0)[0]
        if len(idxs) < 3:
            return 0
        pts = self.map.mp_pos[frame.mp_idx[idxs]]
        nb = bucket(len(idxs))
        t = self.cfg.tracking
        res = pose_gn.pose_optimization_k(
            self.K, self._up(frame.Tcw, np.float32), self._up(pad_rows(pts, nb)),
            self._up(pad_rows(frame.xy[idxs], nb)),
            self._up(pad_rows(self.inv_sigma2[frame.octave[idxs]], nb, 1.0)),
            self._up(row_mask(len(idxs), nb)), rounds=t.pose_opt_rounds,
            iters=t.pose_opt_iters)
        frame.Tcw = to_host(res.Tcw).copy()
        inl = to_host(res.inliers)
        frame.outlier[idxs] = ~inl[: len(idxs)]
        return int(inl.sum())  # padded rows are never inliers

    def _track_with_motion_model(self, frame: FrameData) -> bool:
        """Tracking.cc:1083: project the last frame's points at the predicted
        pose, windowed search th=15 (doubled on failure), then pose-only LM."""
        last = self.last_frame
        self._update_last_frame(last)
        frame.Tcw = self.velocity @ last.Tcw
        bound = last.mp_idx >= 0
        if bound.sum() < 10:
            return False
        mp_ids = last.mp_idx[bound]
        pts = self.map.mp_pos[mp_ids]
        n_src = int(bound.sum())
        nb = bucket(n_src)
        up = self._up
        for th in (15.0, 30.0):
            proj = self._project(frame.Tcw, pts)
            radius = th * self.cfg.orb.scale_factor ** last.octave[bound].astype(np.float32)
            sm = matching.window_mask(
                up(pad_rows(proj, nb), np.float32), up(frame.xy),
                up(pad_rows(radius, nb), np.float32), up(pad_rows(last.octave[bound], nb)),
                up(frame.octave), level_window=1)
            idx, _ = matching.match_descriptors(
                up(pad_rows(last.desc[bound], nb)), up(row_mask(n_src, nb)), up(frame.desc),
                up(frame.valid), spatial_mask=sm, max_dist=matching.TH_HIGH, apply_ratio=False,
                angle_a=up(pad_rows(last.angle[bound], nb)), angle_b=up(frame.angle),
                check_rotation=True)
            idx = to_host(idx)[:n_src]
            n_matches = int((idx >= 0).sum())
            if n_matches >= 20:
                break
        if n_matches < 20:
            return False

        frame.mp_idx[:] = -1
        src = np.nonzero(idx >= 0)[0]
        frame.mp_idx[idx[src]] = mp_ids[src]
        n_in = self._pose_optimize(frame)
        self.log(f"frame {frame.frame_id}: motion model {n_matches} matches, {n_in} inliers")
        if self.only_tracking:
            # Tracking.cc:1163-1165: < 10 map inliers switches to VO mode, but
            # the frame still counts as tracked on > 20 descriptor matches
            self.vo_mode = n_in < 10
            return n_matches > 20
        return n_in >= 10

    def _update_last_frame(self, last: FrameData):
        """UpdateLastFrame (Tracking.cc:1020): re-anchor the last frame's pose
        from its reference keyframe (`Tlr * Tcw_ref`), walking the spanning
        tree past culled keyframes, so BA / loop / NMI refinements of the
        keyframe reach the motion model."""
        if last.Tcr is None or last.ref_kf < 0:
            return
        Trw = np.eye(4, dtype=np.float32)
        k = int(last.ref_kf)
        while k >= 0 and not self.map.kf_valid[k]:
            Trw = Trw @ self.map.kf_Tcp[k]
            k = int(self.map.kf_parent[k])
        if k < 0:
            return
        last.Tcw = (last.Tcr @ Trw @ self.map.kf_Tcw[k]).astype(np.float32)

    def _track_reference_keyframe(self, frame: FrameData) -> bool:
        """Tracking.cc:950: descriptor match against the reference KF's
        map-point features (BoW-accelerated there, dense here) + pose LM."""
        if self.ref_kf < 0:
            return False
        k = self.ref_kf
        has_mp = self.map.kf_mp_idx[k] >= 0
        if has_mp.sum() < 10:
            return False
        up = self._up
        idx, _ = matching.match_descriptors(
            up(self.map.kf_feat_desc[k]), up(has_mp), up(frame.desc), up(frame.valid),
            max_dist=matching.TH_LOW, nn_ratio=0.7, angle_a=up(self.map.kf_feat_angle[k]),
            angle_b=up(frame.angle), check_rotation=True)
        idx = to_host(idx)
        src = np.nonzero(idx >= 0)[0]
        if len(src) < 15:
            return False
        frame.Tcw = (self.last_frame.Tcw.copy() if self.last_frame.Tcw is not None
                     else self.map.kf_Tcw[k].copy())
        frame.mp_idx[:] = -1
        frame.mp_idx[idx[src]] = self.map.kf_mp_idx[k][src]
        n_in = self._pose_optimize(frame)
        self.log(f"frame {frame.frame_id}: ref-KF {len(src)} matches, {n_in} inliers")
        return n_in >= 10

    def _track_local_map(self, frame: FrameData) -> int:
        """Tracking.cc:1172: widen matches to the covisible local map, then a
        final pose optimization."""
        local_kfs = self._local_keyframes(frame)
        if len(local_kfs) == 0:
            return self._pose_optimize(frame)
        m = self.map
        mp_set = np.unique(m.kf_mp_idx[local_kfs])
        mp_set = mp_set[(mp_set >= 0) & m.mp_valid[np.maximum(mp_set, 0)]]
        already = set(frame.mp_idx[frame.mp_idx >= 0].tolist())
        cand = np.array([p for p in mp_set if p not in already], np.int32)
        if len(cand) > 0:
            pts = m.mp_pos[cand]
            proj = self._project(frame.Tcw, pts)
            pc = (frame.Tcw[:3, :3] @ pts.T).T + frame.Tcw[:3, 3]
            dist = np.linalg.norm(pts - self._cam_center(frame.Tcw), axis=-1)
            in_range = (
                (pc[:, 2] > 0)
                & (proj[:, 0] >= 0) & (proj[:, 0] < self.cfg.camera.width)
                & (proj[:, 1] >= 0) & (proj[:, 1] < self.cfg.camera.height)
                & (dist >= 0.8 * m.mp_min_dist[cand])
                & (dist <= 1.2 * m.mp_max_dist[cand])
            )
            # viewing angle < 60 deg vs. point normal (Frame::isInFrustum)
            view = (pts - self._cam_center(frame.Tcw)) / np.maximum(dist[:, None], 1e-9)
            in_range &= (view * m.mp_normal[cand]).sum(-1) > 0.5
            m.mp_visible[cand[in_range]] += 1
            cand = cand[in_range]
            proj = proj[in_range]
            if len(cand) > 0:
                # predict the octave from the distance (MapPoint::PredictScale)
                ratio = np.maximum(m.mp_max_dist[cand] / np.maximum(dist[in_range], 1e-9), 1.0)
                pred_level = np.clip(
                    np.ceil(np.log(ratio) / np.log(self.cfg.orb.scale_factor)).astype(np.int32),
                    0, self.cfg.orb.n_levels - 1)
                radius = 4.0 * self.cfg.orb.scale_factor ** pred_level.astype(np.float32)
                nb = bucket(len(cand))
                up = self._up
                sm = matching.window_mask(
                    up(pad_rows(proj, nb), np.float32), up(frame.xy),
                    up(pad_rows(radius, nb), np.float32), up(pad_rows(pred_level, nb)),
                    up(frame.octave), level_window=1)
                # only unmatched frame features may bind
                idx, _ = matching.match_descriptors(
                    up(pad_rows(m.mp_desc[cand], nb)), up(row_mask(len(cand), nb)),
                    up(frame.desc), up((frame.mp_idx < 0) & frame.valid), spatial_mask=sm,
                    max_dist=matching.TH_HIGH, nn_ratio=0.8)
                idx = to_host(idx)
                src = np.nonzero(idx >= 0)[0]
                frame.mp_idx[idx[src]] = cand[src]
                m.mp_found[cand[src]] += 1

        n_in = self._pose_optimize(frame)
        self.log(f"frame {frame.frame_id}: local map -> {n_in} inliers")
        return n_in

    def _local_keyframes(self, frame: FrameData) -> np.ndarray:
        """KFs sharing points with the frame + their best covisibles
        (UpdateLocalKeyFrames, Tracking.cc:1486); sets the reference KF."""
        kfs, self.ref_kf = local_keyframes(self.map, frame.mp_idx, self.ref_kf)
        return kfs

    # ------------------------------------------------------------- keyframes

    def _need_new_keyframe(self, frame: FrameData, n_inliers: int) -> bool:
        """Tracking.cc:1217-1311 monocular conditions. In the synchronous
        interleave the mapper is idle by construction; in async mode c1b
        requires an idle mapper (:1259), and when the conditions hold but the
        mapper is busy, the in-flight local BA is interrupted and no keyframe
        is created (monocular, :1290-1302) — except a cadence-due (c1a)
        keyframe while nothing further is queued (see below)."""
        t = self.cfg.tracking
        if self.only_tracking:  # Tracking.cc:1221
            return False
        if self.map.n_keyframes == 0:
            return False
        pipeline = getattr(self.system, "pipeline", None) if self.system is not None else None
        idle = pipeline.idle() if pipeline is not None else True
        # nRefMatches = ReferenceKF->TrackedMapPoints(nMinObs): points seen
        # from >= 3 keyframes (2 while the map is tiny), Tracking.cc:1237-1244
        ref_tracked = 0
        if self.ref_kf >= 0:
            min_obs = 3 if self.map.n_keyframes > 2 else 2
            mp = self.map.kf_mp_idx[self.ref_kf]
            ids = mp[mp >= 0]
            if len(ids):
                ref_tracked = int((self.map.mp_valid[ids]
                                   & (self.map.mp_obs_n[ids] >= min_obs)).sum())
        th_ref = max(int(0.9 * ref_tracked), 15)
        c1a = frame.frame_id >= self.last_kf_frame_id + t.max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + t.min_frames and idle
        c2 = n_inliers < th_ref and n_inliers > 15
        # the trailing c1a clause keeps keyframe cadence on sequences where
        # tracking is too good for c2 (synthetic worlds track > 0.9 * ref)
        want = bool((c1a or c1b) and c2) or bool(c1a and n_inliers > 15)
        self.kf_check = dict(c1a=bool(c1a), c1b=bool(c1b), c2=bool(c2), idle=bool(idle),
                             inliers=int(n_inliers), ref_tracked=ref_tracked, ref_kf=self.ref_kf)
        if not want:
            return False
        self.log(f"frame {frame.frame_id}: KF due c1a={int(c1a)} c1b={int(c1b)} "
                 f"c2={int(c2)} inl={n_inliers} ref_tracked={ref_tracked} "
                 f"ref_kf={self.ref_kf}")
        if idle:
            return True
        pipeline.interrupt_ba()  # Tracking.cc:1293
        # Cadence-due (c1a) keyframes, which carry the NMI anchor schedule, are
        # accepted while nothing further is queued: where the mapper's latency
        # exceeds the cadence the strict gate would starve keyframes and
        # anchors. Pure-c2 inserts keep the strict gate (a queue-length gate
        # let c2 bursts make a keyframe every other frame).
        return c1a and pipeline.queue_empty()

    def _create_keyframe(self, frame: FrameData):
        m = self.map
        k = m.add_keyframe(
            frame.Tcw, frame.frame_id, frame.timestamp, frame.xy, frame.octave, frame.angle,
            frame.desc, frame.valid, mp_idx=np.where(frame.outlier, -1, frame.mp_idx),
            nmi_relocalized=frame.nmi_relocalized, nmi_failed=frame.nmi_failed,
        )
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        pipeline = getattr(self.system, "pipeline", None) if self.system is not None else None
        if pipeline is not None:
            # async: hand the KF to the mapping worker and return — tracking
            # never blocks on BA (LocalMapping::InsertKeyFrame, Tracking.cc:1387)
            self.system.ensure_vocabulary(frame.desc, frame.valid, frame_id=frame.frame_id)
            pipeline.insert_keyframe(k)
        else:
            if self.local_mapper is not None:
                self.local_mapper.process_keyframe(k)
                frame.Tcw = m.kf_Tcw[k].copy()
            # place recognition: train the vocabulary if needed, feed the loop
            # closer (LoopClosing::InsertKeyFrame, LocalMapping.cc:90)
            if self.system is not None:
                self.system.ensure_vocabulary(frame.desc, frame.valid, frame_id=frame.frame_id)
                if self.system.loop_closer is not None:
                    if self.system.loop_closer.process_keyframe(k):
                        frame.Tcw = m.kf_Tcw[k].copy()
            # adopt the keyframe's refreshed observation row: local mapping
            # binds new points to feature rows and fusion remaps replaced
            # landmarks (the reference's MapPoint::Replace forwarding)
            n = len(frame.mp_idx)
            fresh = m.kf_mp_idx[k, :n].copy()
            fresh[fresh >= 0] = np.where(m.mp_valid[fresh[fresh >= 0]], fresh[fresh >= 0], -1)
            frame.mp_idx = fresh
            frame.outlier = np.zeros(n, bool)
        self.log(f"frame {frame.frame_id}: new keyframe {k}")

    # -------------------------------------------------------- relocalization

    def pnp_try(self, frame: FrameData, cand: int, min_matches: int = 15,
                draw: Optional[Callable] = None) -> Optional[dict]:
        """The BoW + PnP half of relocalization against keyframe `cand`
        (Tracking.cc:1617-1690): its map points matched to the frame (TH_LOW,
        ratio 0.75, rotation check; at least `min_matches`), then
        `pnp_ransac` (EPnP, 128 hypotheses, at least 10 inliers) on rows
        drawn by `draw(n_rows, n_valid, n_hyp, size)` (`draw_samples` by
        default). None when the keyframe holds too few points;
        else a record of the candidate, its matches, the solver's inputs
        (host arrays, to repeat the solve elsewhere) and its result."""
        m = self.map
        has_mp = m.kf_mp_idx[cand] >= 0
        if has_mp.sum() < min_matches:
            return None
        up = self._up
        idx, _ = matching.match_descriptors(
            up(m.kf_feat_desc[cand]), up(has_mp), up(frame.desc), up(frame.valid),
            max_dist=matching.TH_LOW, nn_ratio=0.75, angle_a=up(m.kf_feat_angle[cand]),
            angle_b=up(frame.angle), check_rotation=True)
        idx = to_host(idx)
        src = np.nonzero(idx >= 0)[0]
        rec = dict(cand=int(cand), frame=int(m.kf_frame_id[cand]), matches=len(src))
        if len(src) < min_matches:  # Tracking.cc:1633 nmatches < 15
            return rec
        mp_ids = m.kf_mp_idx[cand][src]
        nb = bucket(len(src))
        draw = self.draw_samples if draw is None else draw
        inp = dict(samples=np.asarray(draw(nb, len(src), PNP_HYPOTHESES, 4)),
                   pts_w=pad_rows(m.mp_pos[mp_ids], nb), uv=pad_rows(frame.xy[idx[src]], nb),
                   inv_sigma2=pad_rows(self.inv_sigma2[frame.octave[idx[src]]], nb, 1.0),
                   valid=row_mask(len(src), nb))
        res = pnp.pnp_ransac(up(inp["samples"]), self.K, up(inp["pts_w"]), up(inp["uv"]),
                             up(inp["inv_sigma2"]), up(inp["valid"]),
                             min_inliers=10)  # SetRansacParameters(0.99,10,300,...) :1641
        inl = to_host(res.inliers)[: len(src)].copy()
        rec.update(inputs=inp, Tcw=to_host(res.Tcw).copy(), n_inliers=int(inl.sum()),
                   ok=int(inl.sum()) >= 10, inliers=inl, src=src, idx=idx, mp_ids=mp_ids)
        return rec

    def _relocalize(self, frame: FrameData) -> bool:
        """BoW + PnP relocalization after tracking loss with the reference's
        guided-projection expansion (Tracking::Relocalization,
        Tracking.cc:1596-1753): PnP -> pose LM -> if < 50 inliers, a coarse
        SearchByProjection (window 10, Hamming 100), re-optimize, then a
        narrow pass (window 3, Hamming 64); accept only at >= 50 inliers."""
        db = self.system.database if self.system is not None else None
        if db is None:
            return False
        cands = db.detect_relocalization_candidates(self.map, frame.desc, frame.valid)
        for cand in cands:
            rec = self.pnp_try(frame, cand)
            if rec is None or not rec.get("ok"):
                continue
            frame.Tcw = rec["Tcw"]
            frame.mp_idx[:] = -1
            inl, src, idx = rec["inliers"], rec["src"], rec["idx"]
            frame.mp_idx[idx[src[inl]]] = rec["mp_ids"][inl]
            n_good = self._pose_optimize(frame)
            if n_good < 10:
                continue
            frame.mp_idx[frame.outlier] = -1  # Tracking.cc:1699
            # expansion loop (Tracking.cc:1705-1737)
            if n_good < 50:
                n_add = self._search_by_projection_kf(frame, cand, th=10.0, max_dist=100)
                if n_add + n_good >= 50:
                    n_good = self._pose_optimize(frame)
                    if 30 < n_good < 50:
                        n_add = self._search_by_projection_kf(frame, cand, th=3.0, max_dist=64)
                        if n_good + n_add >= 50:
                            n_good = self._pose_optimize(frame)
                            frame.mp_idx[frame.outlier] = -1
            if n_good < 50:  # Tracking.cc:1741 accept only at >= 50
                continue
            self.ref_kf = int(cand)
            self.relocalizations.append((frame.frame_id, int(cand), n_good))
            self.log(f"frame {frame.frame_id}: relocalized against KF {cand} ({n_good} inliers)")
            return True
        return False

    def _search_by_projection_kf(self, frame: FrameData, kf: int, th: float,
                                 max_dist: int) -> int:
        """SearchByProjection(Frame, KeyFrame, sAlreadyFound, th, ORBdist)
        (ORBmatcher.cc relocalization variant): project the keyframe's map
        points not yet bound in the frame at the frame's current pose and bind
        window matches. Returns the number of new bindings."""
        m = self.map
        already = set(frame.mp_idx[frame.mp_idx >= 0].tolist())
        cand_mps = np.unique(m.kf_mp_idx[kf])
        cand_mps = cand_mps[(cand_mps >= 0) & m.mp_valid[np.maximum(cand_mps, 0)]]
        cand_mps = np.array([p for p in cand_mps if p not in already], np.int64)
        if len(cand_mps) == 0:
            return 0
        pts = m.mp_pos[cand_mps]
        z = (pts @ frame.Tcw[:3, :3].T + frame.Tcw[:3, 3])[:, 2]
        proj = self._project(frame.Tcw, pts)
        dist = np.linalg.norm(pts - self._cam_center(frame.Tcw), axis=-1)
        # 0.8/1.2 margins = MapPoint::Get{Min,Max}DistanceInvariance
        ok = ((z > 0)
              & (proj[:, 0] >= 0) & (proj[:, 0] < self.cfg.camera.width)
              & (proj[:, 1] >= 0) & (proj[:, 1] < self.cfg.camera.height)
              & (dist >= 0.8 * m.mp_min_dist[cand_mps])
              & (dist <= 1.2 * m.mp_max_dist[cand_mps]))
        cand_mps, proj, dist = cand_mps[ok], proj[ok], dist[ok]
        if len(cand_mps) == 0:
            return 0
        sf = self.cfg.orb.scale_factor
        n_lv = self.cfg.orb.n_levels
        ratio = np.clip(m.mp_max_dist[cand_mps] / np.maximum(dist, 1e-9), 1.0, float(sf) ** n_lv)
        pred = np.clip(np.ceil(np.log(ratio) / np.log(sf)).astype(np.int32), 0, n_lv - 1)
        radius = th * sf ** pred.astype(np.float32)
        nb = bucket(len(cand_mps))
        up = self._up
        sm = matching.window_mask(
            up(pad_rows(proj.astype(np.float32), nb)), up(frame.xy),
            up(pad_rows(radius, nb), np.float32), up(pad_rows(pred, nb)), up(frame.octave),
            level_window=1)
        idx, _ = matching.match_descriptors(
            up(pad_rows(m.mp_desc[cand_mps], nb)), up(row_mask(len(cand_mps), nb)),
            up(frame.desc), up((frame.mp_idx < 0) & frame.valid), spatial_mask=sm,
            max_dist=max_dist, apply_ratio=False)
        idx = to_host(idx)[: len(cand_mps)]
        got = np.nonzero(idx >= 0)[0]
        frame.mp_idx[idx[got]] = cand_mps[got]
        return len(got)

    # ------------------------------------------------------------------ NMI

    def _gray_f32(self) -> torch.Tensor:
        """The current frame's gray image as float32 on the localizer's
        device (a device image stays there)."""
        return torch.as_tensor(self._gray).to(self.nmi.device, torch.float32)

    def _submit_async_nmi(self, frame: FrameData) -> bool:
        """Hand the sweep for the just-created keyframe (self.ref_kf) to the
        async NMI worker. False when a sweep is already in flight: the caller
        then keeps the every-reloc_frequency counter due."""
        return self.system.nmi_worker.submit(self.ref_kf, self._gray_f32(), frame.Tcw,
                                             self.dist_since_nmi, self.rot_since_nmi,
                                             frame.frame_id)

    def _init_latch(self, frame: FrameData, name: str) -> None:
        """An initialization's NMI latch; its seconds are the set-up counter
        `name` (`utils/profiling.SETUP`). Without a localizer there is none."""
        if self.nmi is None:
            return
        t0 = time.perf_counter()
        self._run_nmi(frame, initializing=True)
        profiling.record_setup(name, time.perf_counter() - t0)

    def _run_nmi(self, frame: FrameData, initializing: bool, search_scale: float = 1.0) -> bool:
        if self.nmi is None:
            return False
        widen = 1.0
        if not initializing and self.nmi_fail_streak:
            widen = 1.0 + 0.75 * min(self.nmi_fail_streak, 6)
        out = self.nmi.relocalize_strategy(
            self._gray_f32(), frame.Tcw, dist_since=tuple(self.dist_since_nmi),
            rot_since=tuple(self.rot_since_nmi), initializing=initializing,
            search_scale=search_scale * widen)
        if not initializing:
            self.nmi_fail_streak = 0 if out.relocalized else self.nmi_fail_streak + 1
        frame.previous_poses.extend(out.previous_poses)
        frame.Tcw = out.Tcw
        frame.nmi_relocalized = out.relocalized
        frame.nmi_failed = out.failed
        if out.relocalized:
            # reset ONLY the drift axes the kernel searched (num > 1),
            # Tracking.cc:600-612; collapsed axes keep accumulating
            for ax in range(3):
                if out.num_synth[ax] > 1:
                    self.dist_since_nmi[ax] = 0.0
                if out.num_warp[ax] > 1:
                    self.rot_since_nmi[ax] = 0.0
        self.log(f"frame {frame.frame_id}: NMI {'ok' if out.relocalized else 'FAILED'} "
                 f"score={out.nmi:.4f} iters={out.iterations}")
        return out.relocalized

    # ----------------------------------------------------------------- utils

    def reset(self):
        """System::Reset semantics (Tracking.cc:1759-1808): wipe the map and
        reinitialize from scratch."""
        self.map.clear()
        self.n_resets += 1
        self.state = TrackingState.NOT_INITIALIZED
        self.velocity = None
        self.init_frame = None
        self.trajectory = []  # Tracking.cc:1801-1804 clears the relative lists
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.kfs_since_last_nmi = 0
        self.dist_since_nmi[:] = 0.0
        self.rot_since_nmi[:] = 0.0
        self.nmi_fail_streak = 0
        if self.local_mapper is not None:
            self.local_mapper.recent_points = []
        if self.system is not None and self.system.loop_closer is not None:
            self.system.loop_closer.consistent_groups = []
            self.system.loop_closer.loop_edges = []
            self.system.database.clear()

    def _project(self, Tcw: np.ndarray, pts: np.ndarray) -> np.ndarray:
        pc = (Tcw[:3, :3] @ pts.T).T + Tcw[:3, 3]
        z = np.where(np.abs(pc[:, 2]) > 1e-9, pc[:, 2], 1e-9)
        return np.stack([self.K[0, 0] * pc[:, 0] / z + self.K[0, 2],
                         self.K[1, 1] * pc[:, 1] / z + self.K[1, 2]], axis=-1)

    @staticmethod
    def _cam_center(Tcw: np.ndarray) -> np.ndarray:
        return -Tcw[:3, :3].T @ Tcw[:3, 3]
