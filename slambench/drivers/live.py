"""Traffic kind "live": the whole system tracking a camera, closed loop, unpaced.

The entry is `PipelinedFrontend(SLAMSystem(cfg, async_mapping=True,
async_nmi=True), lag=1).run` over the camera frames of the circuit, continued
past a lap at the same motion a frame, fed in chunks as fast as the system
takes them. Set-up makes the frames (enough for twice the camera's rate over
the window; the world is the configuration's, the sensor noise the seed's),
builds a vocabulary of the configuration's shape for the system to load, as
a deployment loads the reference's ORBvoc.txt, and runs the first
`warmup_frames` (the NMI initialization latches and the tracking step's
CUDA-graph capture among them).

Around the timed path the driver records: each frame's completion time and
reported pose (the front-end's own `completion_walls` and results), the
extraction of a few frames drawn from the seed (the step's packed outputs,
through the front-end's `debug_hook`), and each NMI anchor the worker runs
(its inputs, outcome and sweeps, `nmi_check.SweepRecorder`). After the
window the plain reference judges the anchors and the extraction, and every
reported pose is held against the generator's.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from slambench import nmi_check, world
from slambench.drivers.reloc import camera_config, nmi_config

from orbslam2_nmi_torch.config import ORBConfig, SystemConfig, TrackingConfig
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.slam.tracking import TrackingState
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary


def system_config(cfg: dict, vocabulary_path: str) -> SystemConfig:
    o, t = cfg["orb"], cfg["tracking"]
    return SystemConfig(
        camera=camera_config(cfg),
        orb=ORBConfig(n_features=o["n_features"], scale_factor=o["scale_factor"],
                      n_levels=o["n_levels"], ini_th_fast=o["ini_th_fast"],
                      min_th_fast=o["min_th_fast"]),
        nmi=nmi_config(cfg),
        tracking=TrackingConfig(max_frames=t["max_frames"], max_keyframes=t["max_keyframes"],
                                max_map_points=t["max_keyframes"] * 256,
                                max_features=max(2048, o["n_features"] + 48)),
        vocabulary_path=vocabulary_path)


class Cell:
    """The live system on one device, its frames and vocabulary, built in set-up."""

    RANGES = ("slambench.frames",)  # the driver's own ranges in a traced window

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        prior, scene = cfg["prior"], cfg["scene"]
        self.circuit = scene["circuit"]
        self.mesh = world.terrain_mesh(int(prior["world_seed"]), prior)
        lit = torch.from_numpy(world.lit_texture(self.mesh, scene["sun"], scene["ambient"]))
        self.n_warm = int(traffic["warmup_frames"])
        n = self.n_warm + int(math.ceil(traffic["frames_per_second"] * seconds))
        self.poses = np.stack([world.pose_at(i, self.circuit) for i in range(n)])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.frames = world.raycast_frames(self.poses, cfg["camera"], prior, lit.to(self.device),
                                           np.arange(n, dtype=np.float64),
                                           self.circuit["frames"], scene["gap"], gen)
        self.stamps = np.arange(n) / float(cfg["camera"]["fps"])

        # the vocabulary the system loads: the configuration's branching and
        # depth, every word present (Vocabulary.synthetic)
        v = cfg["vocabulary"]
        self._tmp = tempfile.TemporaryDirectory(prefix="slambench_")
        voc_path = os.path.join(self._tmp.name, "vocabulary.npz")
        Vocabulary.synthetic(int(v["k"]), int(v["depth"]), seed=int(v["seed"])).save(voc_path)

        mesh = MeshModel(vertices=self.mesh.vertices, uvs=self.mesh.uvs, faces=self.mesh.faces,
                         texture_gray=self.mesh.texture_gray)
        self.system = SLAMSystem(system_config(cfg, voc_path), nmi_mesh=mesh,
                                 output_dir=os.path.join(self._tmp.name, "out"),
                                 async_mapping=True, async_nmi=True, device=self.device)
        off = cfg["nmi"]["offset"]
        self.system.set_init_poses(self.poses[0], self.poses[off])
        self.fe = PipelinedFrontend(self.system, n_cand=int(cfg["tracking"]["n_candidates"]),
                                    lag=1)
        self._wrap()

    # -- recording around the program ----------------------------------------

    def _wrap(self):
        loc = self.system.localizer
        self.recorder = nmi_check.SweepRecorder(loc)
        self.anchors: list = []
        self._recording = False
        self._n_keep = int(self.traffic["check"]["anchor_images"])
        lock = threading.Lock()
        strategy = loc.relocalize_strategy

        def relocalize_strategy(frame, Tcw, dist_since=(0.0, 0.0, 0.0),
                                rot_since=(0.0, 0.0, 0.0), initializing=False,
                                search_scale=None):
            if not self._recording or initializing:
                return strategy(frame, Tcw, dist_since, rot_since, initializing, search_scale)
            with lock:
                keep = len(self.anchors) < self._n_keep
            sweeps = self.recorder.start(keep)
            t0 = time.perf_counter()
            out = strategy(frame, Tcw, dist_since, rot_since, initializing, search_scale)
            t1 = time.perf_counter()
            self.recorder.stop()
            with lock:
                self.anchors.append(dict(
                    frame=frame, Tcw_prior=np.asarray(Tcw, np.float32).copy(),
                    dist=np.asarray(dist_since, np.float64), rot=np.asarray(rot_since, np.float64),
                    search_scale=1.0 if search_scale is None else float(search_scale),
                    Tcw=out.Tcw, relocalized=out.relocalized, sweeps=sweeps, t0=t0, t1=t1))
            return out

        loc.relocalize_strategy = relocalize_strategy
        self.extracted: dict = {}

        def hook(fid, frame, u):
            if fid in self._orb_ids:
                self.extracted[fid] = dict(xy=u.xy.copy(), angle=u.angle.copy(),
                                           octave=u.octave.copy(), valid=u.valid.copy(),
                                           desc=u.desc.copy())

        self._orb_ids: set = set()
        self.fe.debug_hook = hook

    # -- the run ---------------------------------------------------------------

    def warmup(self) -> None:
        w = self.n_warm
        self.results = dict(enumerate(self.fe.run(self.frames[:w], self.stamps[:w], start_id=0)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def keep_indices(self) -> set:
        """The frames whose extraction the check judges, drawn from the seed
        among the first the window will track."""
        c = self.traffic["check"]
        rng = np.random.default_rng([self.seed, 3])
        lo = self.n_warm
        hi = min(len(self.frames), lo + int(c["orb_within"]))
        self._orb_ids = set(int(i) for i in rng.choice(np.arange(lo, hi), int(c["orb_frames"]),
                                                       replace=False))
        return self._orb_ids

    def window(self, seconds: float, tracer=None, keep: set = frozenset()) -> dict:
        """Chunks of frames back to back until `seconds` have passed; the
        frames completed inside the window are its frames. With a `tracer`,
        the first traffic["trace_seconds"] of the window are traced (a whole
        window of the replayed step is tens of millions of device
        operations) and the rest runs untraced."""
        self._recording = True
        t_start = time.perf_counter()
        t_end = t_start + seconds
        self._fid = self.n_warm
        if tracer is not None:
            with tracer():
                # the traced stretch starts once the profiler has: its start-up
                # can take longer than the stretch
                self._frames_until(min(t_end, time.perf_counter()
                                       + float(self.traffic["trace_seconds"])),
                                   label=True, at_least=1)
        # the host counters are read after the traced stretch and the
        # profiler's teardown, which holds the interpreter for seconds
        t_host = time.perf_counter() if tracer is not None else t_start
        self._frames_until(t_end, label=False)
        self._recording = False
        walls = {f: t for f, t in self.fe.completion_walls.items()
                 if f >= self.n_warm and t_start < t <= t_end}
        return dict(t_start=t_start, t_end=t_end, walls=walls,
                    records={f: self.fe.records.get(f) for f, t in walls.items() if t > t_host},
                    mapping=[r for r in self.system.local_mapper.records
                             if r.get("t_end", 0.0) <= t_end
                             and r["t_end"] - r.get("total_ms", 0.0) / 1e3 > t_host])

    def _frames_until(self, deadline: float, label: bool, at_least: int = 0) -> None:
        chunk, n = int(self.traffic["chunk_frames"]), len(self.frames)
        first = self._fid
        while self._fid < n and (time.perf_counter() < deadline
                                 or self._fid - first < at_least * chunk):
            fid, k = self._fid, min(chunk, n - self._fid)
            with (torch.profiler.record_function("slambench.frames") if label
                  else contextlib.nullcontext()):
                out = self.fe.run(self.frames[fid:fid + k], self.stamps[fid:fid + k],
                                  start_id=fid)
            self.results.update({fid + i: r for i, r in enumerate(out)})
            self._fid = fid + k

    def end_to_end(self, res: dict, seconds: float) -> dict:
        from slambench import stats

        t = sorted(res["walls"].values())
        gaps = stats.gaps([res["t_start"]] + t)
        return {"frames_per_s": (stats.rate(len(t), seconds), "frames/s"),
                "frame_ms_p95": (stats.percentile([g * 1e3 for g in gaps], 95), "ms")}

    def attempted_failed(self, res: dict) -> tuple:
        """Frames completed in the window, and those that reported no pose."""
        lost = sum(1 for f in res["walls"] if not self._tracked(f))
        return len(res["walls"]), lost

    def _tracked(self, fid: int) -> bool:
        r = self.results.get(fid)
        return r is not None and r.state == TrackingState.OK and r.Tcw is not None

    def free_program(self) -> None:
        if self.system is not None:
            self.system.shutdown()
        self.system = self.fe = None

    # -- the check -------------------------------------------------------------

    def reference(self, precision: str = "float32"):
        from slambench.reference.strategy import Reference

        c = self.cfg["camera"]
        return Reference(dict(self.cfg["nmi"]), world.camera_K(c), c["height"], c["width"],
                         self.device, mesh=self.mesh, precision=precision)

    def orb_params(self):
        from slambench.reference.orb import ORBParams

        o = self.cfg["orb"]
        return ORBParams(n_features=o["n_features"], scale_factor=o["scale_factor"],
                         n_levels=o["n_levels"], ini_th_fast=o["ini_th_fast"],
                         min_th_fast=o["min_th_fast"])

    def _anchors_in(self, res: dict) -> list:
        return [a for a in self.anchors if res["t_start"] < a["t1"] <= res["t_end"]]

    def control(self, res: dict, precision: str = "bfloat16") -> dict:
        """The window's result with the anchors and the extraction made by the
        plain reference at `precision` in the program's place (the control);
        the reported poses are the program's."""
        from slambench.reference.orb import extract_orb

        ref = self.reference(precision)
        anchors = []
        for a in self._anchors_in(res)[: int(self.traffic["check"]["anchors"])]:
            pose, acc, sweeps = ref.relocalize(a["frame"], a["Tcw_prior"], a["dist"], a["rot"],
                                               a["search_scale"], keep_images=True)
            anchors.append(dict(a, Tcw=pose, relocalized=acc,
                                sweeps=[nmi_check.sweep_record(s) for s in sweeps]))
        extracted = {}
        for fid in self.extracted:
            f = extract_orb(self.frames[fid], self.orb_params(), precision)
            extracted[fid] = dict(xy=f.xy.cpu().numpy(), angle=f.angle.cpu().numpy(),
                                  octave=f.octave.cpu().numpy(), valid=f.valid.cpu().numpy(),
                                  desc=f.desc.cpu().numpy().view(np.uint32))
        return dict(res, anchors=anchors, extracted=extracted)

    def check(self, res: dict) -> dict:
        from slambench.reference.orb import extract_orb

        c = self.traffic["check"]
        # the anchors: a sample drawn from the seed, and those with images
        anchors = res.get("anchors")
        if anchors is None:
            anchors = self._anchors_in(res)
            rng = np.random.default_rng([self.seed, 4])
            pick = set(int(k) for k in rng.choice(len(anchors), min(len(anchors),
                                                                     int(c["anchors"])),
                                                  replace=False))
            pick |= {k for k, a in enumerate(anchors) if a["sweeps"] and "renders" in a["sweeps"][0]}
            anchors = [anchors[k] for k in sorted(pick)]
        out = {f"anchor_{k}": v for k, v in
               nmi_check.check(self.reference("float32"), anchors).items()}
        out["anchors_compared"] = len(anchors)
        # the first stage of the tracking step, on the sampled frames
        extracted = res.get("extracted", self.extracted)
        xy_gap, angle_gap, desc_miss, valid_miss = 0.0, 0.0, 0, 0
        for fid, got in extracted.items():
            f = extract_orb(self.frames[fid], self.orb_params())
            valid = f.valid.cpu().numpy()
            valid_miss += int(np.sum(valid != got["valid"]))
            both = valid & got["valid"]
            xy_gap = max(xy_gap, float(np.max(np.abs(f.xy.cpu().numpy()[both] - got["xy"][both]),
                                              initial=0.0)))
            angle_gap = max(angle_gap, float(np.max(
                np.abs(f.angle.cpu().numpy()[both] - got["angle"][both]), initial=0.0)))
            desc = f.desc.cpu().numpy().view(np.uint32)
            desc_miss += int(np.sum(np.any(desc[both] != got["desc"][both], axis=-1)))
        out.update(orb_xy_gap=xy_gap, orb_angle_gap=angle_gap, orb_desc_miss=desc_miss,
                   orb_valid_miss=valid_miss, orb_frames=len(extracted))
        # every reported pose against the generator's
        err = 0.0
        for fid in res["walls"]:
            if self._tracked(fid):
                gap_m, _ = nmi_check.pose_gap(self.results[fid].Tcw, self.poses[fid])
                err = max(err, gap_m)
        out["track_err_m"] = err
        out["uncompared"] = int(not anchors or not extracted or out["anchor_uncompared"] > 0)
        return out
