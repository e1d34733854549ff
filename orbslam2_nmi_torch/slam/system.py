"""System facade: builds the subsystems and exposes the tracking and saving API.

Port of `orbslam2_nmi_tpu/slam/system.py`, the equivalent of
ORB_SLAM2::System (reference: src/System.cc:50-141 ctor, TrackMonocular
:246, Shutdown :329, SaveFullTrajectory :514, SaveKeyFrameTrajectoryTUM
:417). The default schedule is the deterministic step interleave (local
mapping runs synchronously at each keyframe); `async_mapping=True` moves
local mapping and loop closing to a background worker guarded by the map
lock (`slam/pipeline.py`), the reference's thread layout, and
`async_nmi=True` moves the per-keyframe NMI sweep to its own worker
(`slam/nmi/async_worker.py`).

Place recognition: with no vocabulary file, `ensure_vocabulary` buffers
keyframe descriptors and trains a k=8, depth=4 vocabulary (seed 0) once
4,096 descriptors or 4 keyframes' worth are buffered, on whichever thread
calls it then (the tracking thread at a new keyframe, or the mapping worker
after local mapping); `_build_place_recognition` then builds the keyframe
database (culled keyframes leave it through `map.on_keyframe_removed`) and
the loop closer, hands it the pipeline's global-BA launcher, and backfills
the keyframes mapped so far. `vocab_record` says when, where and how long.

Every subsystem runs on `device` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import SystemConfig, load_yaml_config
from orbslam2_nmi_torch.io import model_loader, trajectory
from orbslam2_nmi_torch.ops import render
from orbslam2_nmi_torch.slam import checkpoint
from orbslam2_nmi_torch.slam.keyframe_database import KeyFrameDatabase
from orbslam2_nmi_torch.slam.local_mapping import LocalMapper
from orbslam2_nmi_torch.slam.loop_closing import LoopCloser
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.slam.nmi.async_worker import AsyncNMI
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer
from orbslam2_nmi_torch.slam.pipeline import MappingPipeline
from orbslam2_nmi_torch.slam.tracking import Tracker, TrackingState, TrackResult
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary


class SLAMSystem:
    def __init__(
        self,
        cfg: SystemConfig,
        nmi_model: Optional[render.RenderModel] = None,
        use_nmi: bool = True,
        output_dir: Optional[str] = None,
        verbose: bool = False,
        async_mapping: bool = False,
        nmi_mesh=None,
        async_nmi: bool = False,
        device="cuda",
        place_recognition: bool = True,
    ):
        """`async_mapping=True` runs local mapping + loop closing in a
        background worker: tracking never blocks on BA. `async_nmi=True`
        runs the per-keyframe NMI sweep on its own worker: the anchor lands
        on the keyframe 1-2 keyframes late instead of stalling tracking for
        the whole grid search. NMI initialization latches stay synchronous:
        the map's scale depends on them. With `place_recognition` off there
        is no vocabulary and no loop closer."""
        self.device = kernels.resolve_device(device, "SLAMSystem")
        self.cfg = cfg
        self.output_dir = output_dir or cfg.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self._log_path = os.path.join(self.output_dir, "_log.txt")
        self._verbose = verbose
        self._t0 = time.time()
        self.place_recognition = place_recognition

        if nmi_model is None and nmi_mesh is None and use_nmi:
            nmi_model, nmi_mesh = self._load_model_from_config()
        self.map = MapStore(cfg)
        self.localizer = (
            NMILocalizer(cfg.nmi, cfg.camera, nmi_model, log_fn=self.log, mesh=nmi_mesh,
                         device=self.device)
            if use_nmi and (nmi_model is not None or nmi_mesh is not None) else None)
        self.local_mapper = LocalMapper(cfg, self.map, log_fn=self.log, device=self.device)
        # vocabulary: load if configured, else trained lazily from the first
        # keyframes' descriptors (System.cc:87 loads ORBvoc.txt up front)
        self.vocabulary = None
        self.database = None
        self.loop_closer = None
        self.vocab_record: dict | None = None
        self._vocab_buffer: list[np.ndarray] = []
        self.pipeline = None
        if place_recognition and cfg.vocabulary_path and os.path.exists(cfg.vocabulary_path):
            self.vocabulary = Vocabulary.load(cfg.vocabulary_path).to(self.device)
            self._build_place_recognition()
        self.tracker = Tracker(cfg, self.map, self.local_mapper, self.localizer, log_fn=self.log,
                               system=self, device=self.device)
        if async_mapping:
            self.pipeline = MappingPipeline(self)
        self.nmi_worker = None
        if async_nmi and self.localizer is not None:
            self.nmi_worker = AsyncNMI(self)
        self.frame_times: list[float] = []

    def _build_place_recognition(self):
        self.database = KeyFrameDatabase(self.vocabulary, self.cfg.tracking.max_keyframes,
                                         max_words=self.cfg.tracking.max_features)
        # culled KFs must leave the place-recognition DB (KeyFrame.cc:504
        # erases from KeyFrameDatabase inside SetBadFlag)
        self.map.on_keyframe_removed.append(self.database.erase)
        self.loop_closer = LoopCloser(self.cfg, self.map, self.database, self.local_mapper,
                                      log_fn=self.log, device=self.device)
        if self.pipeline is not None:  # global BA on its own abortable thread
            self.loop_closer.gba_launcher = self.pipeline.launch_global_ba
        # backfill keyframes created before the vocabulary existed
        with self.map.lock:
            for k in self.map.valid_keyframe_indices():
                if not self.database.active[k]:
                    self.database.add(int(k), self.map.kf_feat_desc[k], self.map.kf_feat_valid[k])

    def ensure_vocabulary(self, descriptors, valid, frame_id: int = -1) -> None:
        """Train the vocabulary from early keyframes if none was loaded
        (the reference ships a pre-trained ORBvoc.txt, System.cc:87; pass
        `vocabulary_path` for a trained one). `frame_id`, the keyframe's
        frame, only goes into `vocab_record`; the mapping worker calls
        without it, right after local mapping, so its frame is that of the
        keyframe the local mapper processed last."""
        if not self.place_recognition or self.vocabulary is not None:
            return
        d = np.asarray(descriptors)[np.asarray(valid)]
        if len(d):
            self._vocab_buffer.append(d)
        n_buf = sum(len(x) for x in self._vocab_buffer)
        if n_buf < 64:
            return
        # train once the buffer is rich enough (or early, for tiny runs)
        if n_buf < 4096 and len(self._vocab_buffer) < 4:
            return
        if frame_id < 0 and self.local_mapper.records:
            frame_id = int(self.map.kf_frame_id[self.local_mapper.records[-1]["kf"]])
        t = time.perf_counter()
        alld = np.concatenate(self._vocab_buffer)
        self._vocab_buffer = []
        self.vocabulary = Vocabulary.train(alld, k=8, depth=4, seed=0).to(self.device)
        t_train = time.perf_counter() - t
        self._build_place_recognition()
        self.vocab_record = dict(train_s=t_train, total_s=time.perf_counter() - t,
                                 thread=threading.current_thread().name, frame=int(frame_id),
                                 descriptors=len(alld), words=self.vocabulary.n_words,
                                 keyframes=int(self.map.n_keyframes))
        self.log(f"trained vocabulary: {self.vocabulary.n_words} words from {len(alld)} "
                 "descriptors")

    @classmethod
    def from_yaml(cls, settings_path: str, **kw) -> "SLAMSystem":
        """A system on a reference-format settings YAML
        (`config.load_yaml_config`); `kw` goes to the constructor, `device`
        included (default "cuda")."""
        return cls(load_yaml_config(settings_path), **kw)

    def _load_model_from_config(self):
        """-> (pointcloud RenderModel | None, MeshModel | None) per render_mode
        (rendering.hpp:54-55: 1 = textured mesh, 4 = pointcloud)."""
        nmi = self.cfg.nmi
        try:
            if nmi.render_mode == 4 and nmi.model_cloud_path:
                pc = model_loader.load_xyz_pointcloud(nmi.model_cloud_path,
                                                      nmi.model_offset_path or None)
                return render.model_from_pointcloud(pc, self.device), None
            if nmi.model_obj_path:
                return None, model_loader.load_obj(nmi.model_obj_path,
                                                   nmi.model_texture_path or None)
        except FileNotFoundError:
            self.log(f"NMI model not found ({nmi.model_obj_path or nmi.model_cloud_path}); "
                     "NMI disabled")
        return None, None

    # ----------------------------------------------------------------- api

    def track_monocular(self, gray_u8, timestamp: float,
                        frame_id: Optional[int] = None) -> TrackResult:
        """System::TrackMonocular (System.cc:246): one uint8 image [H, W]
        (numpy, or a tensor). The tracker takes the map lock after feature
        extraction, so the mapping worker can run during it."""
        if frame_id is None:
            frame_id = len(self.frame_times)
        t0 = time.time()
        res = self.tracker.process_frame(frame_id, timestamp, gray_u8)
        self.frame_times.append(time.time() - t0)
        return res

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:298-303): freeze the
        map and track against it only — no keyframes, no mapping, no loop
        closing. The workers are drained and the tracker switches to the
        mbOnlyTracking branch."""
        if self.pipeline is not None:
            self.pipeline.flush(timeout=600.0)
        if self.nmi_worker is not None:
            self.nmi_worker.flush(timeout=600.0)
        self.tracker.only_tracking = True
        self.tracker.vo_mode = False
        self.log("localization-only mode ACTIVATED (map frozen)")

    def deactivate_localization_mode(self):
        """System::DeactivateLocalizationMode (System.cc:305-310)."""
        self.tracker.only_tracking = False
        self.tracker.vo_mode = False
        self.log("localization-only mode DEACTIVATED")

    def set_init_poses(self, Tcw1: np.ndarray, Tcw2: np.ndarray):
        self.tracker.set_init_poses(Tcw1, Tcw2)

    def log(self, msg: str):
        line = f"[{time.time() - self._t0:9.3f}] {msg}"
        with open(self._log_path, "a") as f:
            f.write(line + "\n")
        if self._verbose:
            print(line)

    # -------------------------------------------------------------- outputs

    def save_full_trajectory(self, name: str = "FullTrajectory"):
        with self.map.lock:
            trajectory.save_full_trajectory(os.path.join(self.output_dir, name),
                                            self.tracker.trajectory, self.map)

    def full_trajectory(self) -> list:
        """Recomposed (frame_id, t, Tcw, flags, prev) rows: absolute poses
        with every loop, BA and NMI correction (System.cc:514 semantics)."""
        with self.map.lock:
            return trajectory.recompose_trajectory(self.tracker.trajectory, self.map)

    def save_keyframe_trajectory_tum(self, name: str = "KeyFrameTrajectory.txt"):
        with self.map.lock:
            kfs = self.map.valid_keyframe_indices()
            trajectory.save_keyframe_trajectory_tum(os.path.join(self.output_dir, name),
                                                    self.map.kf_timestamp[kfs],
                                                    self.map.kf_Tcw[kfs])

    def print_map_points(self, name: str = "MapPoints.xyz"):
        """Tracking::PrintMapPoints (Tracking.cc:2422-2449)."""
        with self.map.lock:
            ps = self.map.valid_point_indices()
            model_loader.save_xyz_pointcloud(os.path.join(self.output_dir, name),
                                             self.map.mp_pos[ps])

    def save_map(self, path: str):
        """Checkpoint the whole map and the tracker's state (the same npz as
        the JAX package's, so either package loads the other's)."""
        tr = self.tracker
        if self.pipeline is not None:
            self.pipeline.flush()
        with self.map.lock:
            checkpoint.save_map(path, self.map, {
                "ref_kf": tr.ref_kf,
                "last_kf_frame_id": tr.last_kf_frame_id,
                "kfs_since_last_nmi": tr.kfs_since_last_nmi,
                "dist_since_nmi": tr.dist_since_nmi,
                "rot_since_nmi": tr.rot_since_nmi,
            })

    def load_map(self, path: str):
        """Resume from a checkpoint: the map and the tracker's header, then
        LOST, so the next frame relocalizes into the map."""
        hdr = checkpoint.load_map(path, self.map)
        tr = self.tracker
        if hdr:
            tr.ref_kf = int(hdr.get("ref_kf", -1))
            tr.last_kf_frame_id = int(hdr.get("last_kf_frame_id", -1))
            tr.kfs_since_last_nmi = int(hdr.get("kfs_since_last_nmi", 0))
            tr.dist_since_nmi = np.asarray(hdr.get("dist_since_nmi", np.zeros(3))).copy()
            tr.rot_since_nmi = np.asarray(hdr.get("rot_since_nmi", np.zeros(3))).copy()
        tr.state = TrackingState.LOST  # resume by relocalizing into the map
        # rebuild the keyframe database from the restored descriptors
        if self.vocabulary is None and self.map.n_keyframes > 0:
            k0 = int(self.map.valid_keyframe_indices()[0])
            self.ensure_vocabulary(self.map.kf_feat_desc[k0], self.map.kf_feat_valid[k0])
        if self.database is not None:
            for k in self.map.valid_keyframe_indices():
                self.database.add(int(k), self.map.kf_feat_desc[k], self.map.kf_feat_valid[k])

    def shutdown(self):
        """System::Shutdown (System.cc:329): stop the workers, report timing."""
        if self.nmi_worker is not None:
            self.nmi_worker.shutdown()
            for err in self.nmi_worker.errors():
                self.log(f"NMI worker error:\n{err}")
        if self.pipeline is not None:
            self.pipeline.shutdown()
            for err in self.pipeline.errors():
                self.log(f"mapping worker error:\n{err}")
        if self.frame_times:
            ft = np.array(self.frame_times)
            self.log(f"median tracking time {np.median(ft) * 1e3:.1f} ms, "
                     f"mean {ft.mean() * 1e3:.1f} ms over {len(ft)} frames")

    def errors(self) -> list:
        """The workers' errors so far (tracebacks)."""
        out = []
        for w in (self.pipeline, self.nmi_worker):
            if w is not None:
                out.extend(w.errors())
        return out
