"""Traffic kind "reloc": a closed loop of NMI relocalizations, one caller.

Each request is one `NMILocalizer.relocalize_strategy(frame, Tcw_prior,
dist_since, rot_since)` on a localizer built from the configuration, as the
asynchronous NMI worker serves an anchor: the frame is the camera image of a
circuit pose, `dist_since` and `rot_since` the motion of a span of circuit
frames (the span between two anchors), the prior the true pose off by
`prior_error` of that motion along each axis. The pool of queries is fixed
by the traffic mix (`pool_seed`) and the world by the configuration
(`prior.world_seed`); the run's seed draws the order the requests cycle
through the pool in and each frame's sensor noise, so that every seed
offers the same work.

The timed path is the program's own call. Around it the driver records each
sweep's inputs and [S, R] scores (read back by the program anyway), and for
a few requests drawn from the seed the renders and warps the sweep made, so
that the plain reference can judge them after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from slambench import nmi_check, world

# the program, and only its public surface
from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops.render import RenderModel
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer

@dataclasses.dataclass
class Query:
    frame_index: int
    span: int
    Tcw_true: np.ndarray
    Tcw_prior: np.ndarray
    dist: np.ndarray
    rot: np.ndarray


def nmi_config(cfg: dict) -> NMIConfig:
    n = cfg["nmi"]
    return NMIConfig(
        threshold=n["threshold"], offset=n["offset"],
        grid=NMIGridConfig(synth_num=tuple(n["synth_num"]), warp_num=tuple(n["warp_num"]),
                           synth_step=tuple(n["synth_step"]), warp_step=tuple(n["warp_step"])),
        render_point_size=n["render_point_size"], render_near=n["render_near"],
        render_far=n["render_far"], render_mode=n["render_mode"],
        max_iteration_count=n["max_iteration_count"], reloc_frequency=n["reloc_frequency"],
        step_factor=n["step_factor"], use_background=n["use_background"],
        coarse_scale=n["coarse_scale"], metric=n["metric"], n_bins=n["n_bins"],
        drift_fraction=n["drift_fraction"], gain_epsilon=n["gain_epsilon"])


def camera_config(cfg: dict) -> CameraConfig:
    c = cfg["camera"]
    return CameraConfig(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                        height=c["height"], fps=c["fps"])


def make_queries(cfg: dict, traffic: dict, seed: int) -> list:
    """The pool, in the order `seed` draws: blocks of every span in
    traffic["motion_frames"], each query at a circuit frame and with prior
    errors drawn from traffic["pool_seed"], so every seed gets the same
    queries in another order."""
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    circuit = cfg["scene"]["circuit"]
    n_pool = int(traffic["pool"])
    lo, hi = traffic["motion_frames"]
    block = np.arange(int(lo), int(hi) + 1)
    spans = np.concatenate([rng.permutation(block)
                            for _ in range(-(-n_pool // len(block)))])[:n_pool]
    out = []
    for span in spans:
        i = int(rng.integers(int(span), int(circuit["frames"])))
        poses = [world.pose_at(j, circuit) for j in range(i - int(span), i + 1)]
        dist, rot = world.motion_since(poses)
        signs = rng.choice([-1.0, 1.0], size=6)
        err = traffic["prior_error"]
        prior = world.perturb(poses[-1], signs[:3] * err * dist, signs[3:] * err * rot)
        out.append(Query(frame_index=i, span=int(span), Tcw_true=poses[-1], Tcw_prior=prior,
                         dist=dist, rot=rot))
    return [out[k] for k in np.random.default_rng(seed).permutation(len(out))]


class Cell:
    """One reloc cell on one device: the world, the pool and the program's
    localizer, built in set-up."""

    RANGES = ("slambench.relocalization",)  # the driver's own ranges in a traced window

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, seconds: float):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        prior = cfg["prior"]
        scene = cfg["scene"]
        self.mesh = world.terrain_mesh(int(prior["world_seed"]), prior)
        lit = torch.from_numpy(world.lit_texture(self.mesh, scene["sun"], scene["ambient"]))
        self.queries = make_queries(cfg, traffic, seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        frames = world.raycast_frames(
            np.stack([q.Tcw_true for q in self.queries]), cfg["camera"], prior,
            lit.to(self.device), np.array([q.frame_index for q in self.queries], np.float64),
            scene["circuit"]["frames"], scene["gap"], gen)
        # the tracker hands the localizer its gray frame as float32 on the device
        self.frames = frames.to(torch.float32)
        self.points = self.gray = None
        mode = cfg["nmi"]["render_mode"]
        if mode == 4:
            self.points, self.gray = world.mesh_to_points(self.mesh, prior["cloud_density"])
            model = RenderModel(torch.from_numpy(self.points).to(self.device),
                                torch.from_numpy(self.gray).to(self.device))
            mesh = None
        elif mode == 1:
            model = None
            mesh = MeshModel(vertices=self.mesh.vertices, uvs=self.mesh.uvs,
                             faces=self.mesh.faces, texture_gray=self.mesh.texture_gray)
        else:
            raise ValueError(f"render mode {mode} is not served by this driver")
        self.loc = NMILocalizer(nmi_config(cfg), camera_config(cfg), model, mesh=mesh,
                                device=self.device)
        self.recorder = nmi_check.SweepRecorder(self.loc)

    def _request(self, k: int, keep: bool, label: bool) -> dict:
        q = self.queries[k % len(self.queries)]
        sweeps = self.recorder.start(keep)
        b1 = kernels.LAUNCHES["joint_entropy"]
        t0 = time.perf_counter()
        if label:
            with torch.profiler.record_function("slambench.relocalization"):
                out = self.loc.relocalize_strategy(self.frames[k % len(self.queries)], q.Tcw_prior,
                                                   tuple(q.dist), tuple(q.rot))
        else:
            out = self.loc.relocalize_strategy(self.frames[k % len(self.queries)], q.Tcw_prior,
                                               tuple(q.dist), tuple(q.rot))
        t1 = time.perf_counter()  # the pose is a host array: the result is on the host
        self.recorder.stop()
        return dict(query=k % len(self.queries), t0=t0, t1=t1, Tcw=out.Tcw,
                    relocalized=out.relocalized, iterations=out.iterations, sweeps=sweeps,
                    b1_launches=kernels.LAUNCHES["joint_entropy"] - b1)

    # -- the run ---------------------------------------------------------------

    def warmup(self) -> None:
        for k in range(int(self.traffic["warmup_requests"])):
            self._request(k, keep=k == 0, label=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def keep_indices(self) -> set:
        """The requests whose renders and warps are kept for the check, drawn
        from the seed before the window among the first ones it will run."""
        c = self.traffic["check"]
        rng = np.random.default_rng([self.seed, 1])
        return set(int(k) for k in rng.choice(int(c["image_within"]), int(c["image_requests"]),
                                              replace=False))

    def window(self, seconds: float, tracer=None, keep: set = frozenset()) -> dict:
        """Requests back to back until `seconds` have passed; those completed
        inside the window are its requests. The one it ends inside of runs
        to its end and is kept apart (`overrun`). With a `tracer`, the whole
        window is traced."""
        reqs = []
        with tracer() if tracer is not None else contextlib.nullcontext():
            t_start = time.perf_counter()
            t_end = t_start + seconds
            k = 0
            while True:
                r = self._request(k, keep=k in keep, label=tracer is not None)
                if r["t1"] > t_end:
                    break
                reqs.append(r)
                k += 1
        return dict(t_start=t_start, t_end=t_end, requests=reqs, overrun=r)

    def end_to_end(self, res: dict, seconds: float) -> dict:
        from slambench import stats

        lat = [(r["t1"] - r["t0"]) * 1e3 for r in res["requests"]]
        return {"reloc_per_s": (stats.rate(len(lat), seconds), "reloc/s"),
                "reloc_ms_p95": (stats.percentile(lat, 95), "ms")}

    def attempted_failed(self, res: dict) -> tuple:
        """Requests in the window, and those whose pose the accept gate
        refused (no anchor landed)."""
        reqs = res["requests"]
        return len(reqs), sum(1 for r in reqs if not r["relocalized"])

    def free_program(self) -> None:
        self.loc = None

    # -- the check -------------------------------------------------------------

    def reference(self, precision: str = "float32"):
        from slambench.reference.strategy import Reference

        c = self.cfg["camera"]
        return Reference(dict(self.cfg["nmi"]), world.camera_K(c), c["height"], c["width"],
                         self.device, mesh=self.mesh if self.points is None else None,
                         points=self.points, gray=self.gray, precision=precision)

    def control(self, res: dict, precision: str = "bfloat16") -> dict:
        """A window's result made by the reference at `precision` in the
        program's place (the control): as many requests as the check samples,
        from the start of the pool, each sweep's renders and warps kept."""
        ref = self.reference(precision)
        reqs = []
        for k in range(int(self.traffic["check"]["pose_requests"])):
            q = self.queries[k % len(self.queries)]
            pose, accepted, sweeps = ref.relocalize(self.frames[k % len(self.queries)],
                                                    q.Tcw_prior, q.dist, q.rot, keep_images=True)
            reqs.append(dict(query=k % len(self.queries), Tcw=pose, relocalized=accepted,
                             sweeps=[nmi_check.sweep_record(s) for s in sweeps]))
        return dict(res, requests=reqs)

    def check(self, res: dict) -> dict:
        """The numbers that decide `correct`, each the worst over what was
        compared: a sample of requests drawn from the seed, the one with the
        most sweeps, those whose images were kept and at least one whose
        anchor landed, each replayed by the
        plain reference (`nmi_check.check`)."""
        c = self.traffic["check"]
        requests = res["requests"]
        rng = np.random.default_rng([self.seed, 2])
        n = len(requests)
        chosen = set(int(k) for k in rng.choice(n, min(n, int(c["pose_requests"])), replace=False))
        chosen |= {k for k, r in enumerate(requests)
                   if r["sweeps"] and "renders" in r["sweeps"][0]}
        if n:
            chosen.add(int(np.argmax([len(r["sweeps"]) for r in requests])))
        accepted = [k for k, r in enumerate(requests) if r["relocalized"]]
        if accepted and not any(requests[k]["relocalized"] for k in chosen):
            # an anchor that landed, so that the pose returned is judged
            chosen.add(int(rng.choice(accepted)))
        items = []
        for k in sorted(chosen):
            r = requests[k]
            q = self.queries[r["query"]]
            items.append(dict(r, frame=self.frames[r["query"]], Tcw_prior=q.Tcw_prior,
                              dist=q.dist, rot=q.rot))
        return nmi_check.check(self.reference("float32"), items)
