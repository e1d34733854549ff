"""The port's entry points: the NMI pose-grid step, the localizer, the
tracking step, mapping with NMI initialization, loop closing, and the whole
system on the circuit.

`entry()` mirrors `__graft_entry__.entry()` of the JAX package: one full evaluation of
the pose grid around a prior pose. It renders every translation candidate of
the textured prior mesh (kernel B3 with the sampler fused, `render_gray`),
warps the live frame by every rotation hypothesis, scores every (render,
warp) pair by NMI (kernels B1 and B2), and takes the argmax on the device.

    from orbslam2_nmi_torch.entry import entry
    fn, (frame, Tcw) = entry()            # 960x540, 27 renders x 27 warps
    scores, best = fn(frame, Tcw)         # [27, 27] f32, flat argmax

`localizer_entry()` builds the NMI localizer (`slam/nmi/localizer.py`) on the
same scene, camera and steps, which turns grid steps into an anchored pose:

    loc, frame, T_true = localizer_entry()          # textured mesh, 960x540
    out = loc.relocalize_strategy(frame, T_pert, initializing=True)

`tracking_entry()` builds the per-frame tracking step
(`slam/fused_track.FusedTrackStep`) on the JAX package's full-circuit
configuration (`tools/replay_bench.py:47-137`): the 190x190 terrain mesh, fx
450 at 960x540, 2,000 ORB features on 8 levels, 2,048 local-map candidates.
The frames are rendered by the port's rasterizer (B3 and the sampler), and the
step is seeded from ground truth instead of a map:

    step, frames, carry, candidates, poses = tracking_entry()
    out = step(frames[0], carry, *candidates(carry.Tcw.cpu().numpy()))

`mapping_entry()` builds the mapping path on the JAX package's full-circuit
replay configuration (`tools/replay_bench.py:113-140`): NMI initialization
on frames 0 and 8 (`slam/initialization.nmi_initialize`, the latches through
the localizer on the terrain mesh), then the tracking step against the map
being built (`frontend_pipelined.local_candidates`), with a keyframe every 10 frames handed
to the mapping worker (`slam/pipeline.MappingPipeline`, local mapping and
local BA):

    session = mapping_entry()
    init = session.initialize()
    for i in session.track_ids:
        rec = session.track_frame(i)
    session.flush()

`loop_entry()` is `mapping_entry()` with place recognition and loop closing
wired in (`SLAMSystem`'s): the vocabulary trains from the first keyframes,
and `add_revisit_arc` then adds a drifted revisit of the circuit's start
for the loop closer to close (see its docstring); `relocalize_pnp`
relocalizes a frame against the map by BoW and PnP.

`circuit_entry()` builds the whole system (`slam/system.SLAMSystem`, async
mapping and async NMI) on the JAX package's full-circuit record, with the
520 frames of the seed-1 circuit rendered on the device:

    system, frames, poses = circuit_entry()
    fe = PipelinedFrontend(system)          # slam/frontend_pipelined.py
    for c0 in range(0, 520, 40):
        fe.run(frames[c0:c0 + 40], np.arange(c0, c0 + 40) / 30.0, start_id=c0)
    system.shutdown()

`dryrun_multichip(n)` runs the sharded paths (`parallel/`) once each on a
fresh world of n ranks at tiny shapes, the counterpart of
`__graft_entry__.dryrun_multichip`: the splat and the mesh NMI search
(64x80, 8 renders x 4 warps), the Schur BA (6 cameras, 64 points) and the
essential graph (V 9):

    dryrun_multichip(2)                     # NCCL, one card a rank
    dryrun_multichip(4, device="cpu")       # gloo on the CPU

All of them run on CUDA unless the caller passes `device="cpu"` (the CPU
runs the kernels' plain versions; the tests use it at small sizes).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import (CameraConfig, NMIConfig, NMIGridConfig, ORBConfig,
                                       SystemConfig, TrackingConfig)
from orbslam2_nmi_torch.io.model_loader import MeshModel, PointCloudModel
from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, raycast_terrain
from orbslam2_nmi_torch.ops import histogram_nmi, homography, matching, raster, render
from orbslam2_nmi_torch.slam import initialization
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_torch.slam.frontend_pipelined import (FRUSTUM_MARGIN, bind_step,
                                                        count_visible_found, local_candidates,
                                                        step_frame, upload_candidates)
from orbslam2_nmi_torch.slam.fused_track import (FusedTrackStep, TrackCarry, carry_from_frame,
                                                 unpack_step)
from orbslam2_nmi_torch.slam.loop_closing import draw_uniform
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.slam.tracking import local_keyframes
from orbslam2_nmi_torch.utils.readback import to_host

NEAR, FAR = 5.0, 40.0
SYNTH_STEP = (0.2, 0.2, 0.5)  # meters per translation-grid step (X, Y, Z)
WARP_STEP = (0.02, 0.02, 0.05)  # radians per rotation-grid step (X, Y, Z)


def _toy_mesh(n=80, seed=0):
    """The reference entry's height-field prior: an (n-1)^2 * 2 triangle mesh
    over 80 x 60 m at ~15 m depth with a random 256x256 texture."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-40, 40, n)
    ys = np.linspace(-30, 30, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = 15.0 + 3.0 * np.sin(X * 0.3) * np.cos(Y * 0.25)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack(
        [(X.ravel() - xs[0]) / 80.0, (Y.ravel() - ys[0]) / 60.0], -1
    ).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate(
        [np.stack([a, a + 1, a + n + 1], -1), np.stack([a, a + n + 1, a + n], -1)]
    ).astype(np.int32)
    tex = rng.uniform(10, 245, (256, 256)).astype(np.float32)
    return MeshModel(vertices=verts, uvs=uvs, faces=faces, texture_gray=tex)


def _toy_model(n_points=200_000, seed=0, device="cuda") -> render.RenderModel:
    """The reference entry's point world: a height field over 80 x 60 m at
    ~15 m depth, gray from a checker of the x and y coordinates."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-40, 40, n_points)
    y = rng.uniform(-30, 30, n_points)
    z = 15.0 + 3.0 * np.sin(x * 0.3) * np.cos(y * 0.25)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    gray = ((np.floor(x * 1.1) * 53 + np.floor(y * 1.1) * 101) % 256).astype(np.float32)
    return render.RenderModel(points=torch.from_numpy(pts).to(device),
                              gray=torch.from_numpy(gray).to(device))


def camera_K(height: int, width: int) -> np.ndarray:
    """The entry's intrinsics: 435 px focal length at 960 px width, scaled
    with the width, principal point at the image center."""
    f = 435.0 * width / 960.0
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)


class NMIGridStep:
    """One pose-grid evaluation against a binned prior mesh, on one device.

    `render`, `warp` and `score` are the step's three stages, callable on
    their own for timing; `__call__` runs all three and the argmax. The
    rotation grid's warp plan is built once, here.
    """

    def __init__(self, binned: raster.BinnedMesh, K: np.ndarray, offsets: torch.Tensor,
                 angles: np.ndarray, use_background: bool = True):
        self.binned = binned
        self.K = K
        self.offsets = offsets
        self.angles = angles
        self.use_background = use_background
        self.plan = homography.warp_plan(K, angles, binned.height, binned.width,
                                         binned.tri_data.device)

    def render(self, Tcw: torch.Tensor) -> torch.Tensor:
        return raster.render_mesh_grid(self.binned, Tcw, self.K, self.offsets, NEAR, FAR)

    def warp(self, frame_gray: torch.Tensor) -> torch.Tensor:
        return homography.warp_homographies(frame_gray, self.plan)

    def score(self, synth: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
        return histogram_nmi.nmi_scores(synth, warped, use_background=self.use_background)

    def __call__(self, frame_gray: torch.Tensor, Tcw: torch.Tensor):
        scores = self.score(self.render(Tcw), self.warp(frame_gray))
        return scores, torch.argmax(scores)


def entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
          synth_num=(3, 3, 3), warp_num=(3, 3, 3), use_background: bool = True):
    """(fn, (frame_gray, Tcw)): the NMI grid step at full camera resolution by
    default (960x540, 27 textured-mesh renders x 27 warps = 729 scored pose
    pairs), and an example frame and pose on `device`."""
    device = kernels.resolve_device(device, "entry()")
    K = camera_K(height, width)
    binned = raster.bin_mesh(
        _toy_mesh(), np.eye(4, dtype=np.float32), K, height, width, NEAR, FAR,
        max_offset=SYNTH_STEP, device=device,
    )
    offsets = render.translation_grid_offsets(synth_num, SYNTH_STEP, device=device)
    angles = homography.rotation_grid_angles(warp_num, WARP_STEP, device="cpu").numpy()
    fn = NMIGridStep(binned, K, offsets, angles, use_background=use_background)
    rng = np.random.default_rng(1)
    frame = torch.from_numpy(rng.uniform(0, 255, (height, width)).astype(np.float32)).to(device)
    Tcw = torch.eye(4, dtype=torch.float32, device=device)
    return fn, (frame, Tcw)


def localizer_entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
                    render_mode: int = 1):
    """(localizer, frame, T_true): the NMI localizer on the entry's scene and
    camera at full camera resolution by default, with a frame rendered at
    T_true = I by the same renderer, so an exact match exists.

    `render_mode` 1 renders the textured toy mesh (kernel B3 and the
    sampler); 4 renders the mesh's dense point sampling (`mesh_to_points`,
    2,211,835 points) by point splat. The NMI settings are the defaults
    (3^3 x 3^3 grids, the entry's steps, 4 iterations, SUC, background kept)
    with near/far 5/40 m and the accept threshold 0.1.
    """
    device = kernels.resolve_device(device, "localizer_entry()")
    K = camera_K(height, width)
    camera = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                          cy=float(K[1, 2]), width=width, height=height)
    cfg = NMIConfig(render_near=NEAR, render_far=FAR, threshold=0.1, render_mode=render_mode)
    mesh = _toy_mesh()
    T_true = np.eye(4, dtype=np.float32)
    if render_mode == 1:
        loc = NMILocalizer(cfg, camera, None, mesh=mesh, device=device)
        binned = raster.bin_mesh(mesh, T_true, K, height, width, NEAR, FAR, device=device)
        frame = raster.render_mesh_grid(binned, T_true, K, torch.zeros(1, 3), NEAR, FAR)[0]
    elif render_mode == 4:
        model = render.model_from_pointcloud(render.mesh_to_points(mesh), device)
        loc = NMILocalizer(cfg, camera, model, device=device)
        frame = render.render_pointcloud(model, T_true, K, height, width, NEAR, FAR,
                                         point_size=max(1, round(cfg.render_point_size)))
    else:
        raise ValueError(f"render_mode must be 1 (textured mesh) or 4 (pointcloud), "
                         f"got {render_mode}")
    return loc, frame, T_true


# ---------------------------------------------------------------------------
# The per-frame tracking step, seeded from ground truth
# ---------------------------------------------------------------------------

KEYFRAME_EVERY = 10  # frames between the ground-truth "keyframes" of the local map


def tracking_config(world: SyntheticMeshWorld, height: int, width: int,
                    n_features: int = 2000) -> SystemConfig:
    """The full-circuit configuration of `tools/replay_bench.py:96-140`
    for the step: the world's camera at `width` x `height`, 30 fps, ORB with
    `n_features` on 8 levels, and the default tracking settings (4 rounds x
    10 iterations of pose GN)."""
    K = world.camera_K(width, height)
    return SystemConfig(
        camera=CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                            cy=float(K[1, 2]), width=width, height=height, fps=30.0),
        orb=ORBConfig(n_features=n_features, n_levels=8),
        tracking=TrackingConfig(),
    )


def _center(T: np.ndarray) -> np.ndarray:
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)


def ground_truth_landmarks(K: np.ndarray, Tcw: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """World points [N, 3] f32 of pixels `xy` [N, 2] seen from the true pose
    `Tcw`: their rays cast onto the analytic terrain."""
    px = np.concatenate([xy.astype(np.float64), np.ones((len(xy), 1))], -1)
    dirs_c = px @ np.linalg.inv(K.astype(np.float64)).T
    dirs_w = dirs_c @ Tcw[:3, :3].astype(np.float64)  # rows of Rwc @ d
    return raycast_terrain(_center(Tcw), dirs_w).astype(np.float32)


def _features_host(step: FusedTrackStep, frame_u8: torch.Tensor) -> dict:
    f = step.extract(frame_u8)
    return {k: getattr(f, k).cpu().numpy() for k in ("xy", "octave", "angle", "desc", "valid")}


def seed_carry(step: FusedTrackStep, frame_u8: torch.Tensor, Tcw: np.ndarray,
               Tcw_prev: np.ndarray) -> TrackCarry:
    """The carry after a frame tracked exactly: the step's own features of
    `frame_u8`, every valid one bound to its ray-cast landmark, the true pose
    `Tcw`, and the true motion from `Tcw_prev` as the velocity."""
    f = _features_host(step, frame_u8)
    pts = ground_truth_landmarks(step.K, Tcw, f["xy"])
    pts[~f["valid"]] = 0.0
    velocity = (Tcw.astype(np.float64) @ np.linalg.inv(Tcw_prev.astype(np.float64))).astype(
        np.float32)
    dev = step.device
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return TrackCarry(Tcw=up(Tcw.astype(np.float32)), velocity=up(velocity), xy=up(f["xy"]),
                      octave=up(f["octave"]), angle=up(f["angle"]), desc=up(f["desc"]),
                      pts=up(pts), bound=up(f["valid"]))


class GroundTruthMap:
    """A stand-in for the local map: the features of ground-truth
    "keyframes", each bound to its ray-cast landmark, with the map point
    statistics of `map_store.py:385-398` for one observation (normal, and
    min/max distance from the keyframe's distance and octave).

    `candidate_arrays(Tcw_last)` builds the step's candidate set on the host
    as `PipelinedFrontend._local_candidates` does (`frontend_pipelined.py:
    193-233`): keyframes nearest to the last pose first, a frustum pre-filter
    at `Tcw_last` with a 64 px margin when the set exceeds `n_cand`, then
    truncated and padded to `n_cand`. Calling the map with `Tcw_last` builds
    them and uploads them to the step's device (`upload`).
    """

    def __init__(self, step: FusedTrackStep, frames_u8, poses):
        cfg = step.cfg
        sf, n_levels = cfg.orb.scale_factor, cfg.orb.n_levels
        self.step = step
        self.centers, self.points = [], []
        for frame, T in zip(frames_u8, poses):
            f = _features_host(step, frame)
            v = f["valid"]
            pts = ground_truth_landmarks(step.K, T, f["xy"][v])
            c = _center(T)
            vec = pts.astype(np.float64) - c
            dist = np.linalg.norm(vec, axis=-1)
            max_d = dist * sf ** f["octave"][v].astype(np.float64)
            self.centers.append(c)
            self.points.append(dict(
                pts=pts, desc=f["desc"][v], normal=(vec / np.maximum(dist, 1e-9)[:, None]),
                max_d=max_d, min_d=max_d / sf ** (n_levels - 1)))

    def candidate_arrays(self, Tcw_last: np.ndarray):
        """(pts [C, 3], desc [C, 8] int32, min_d [C], max_d [C], normal [C, 3],
        valid [C]) numpy arrays, C = n_cand."""
        C = self.step.n_cand
        order = np.argsort([np.linalg.norm(c - _center(Tcw_last)) for c in self.centers],
                           kind="stable")
        cat = {k: np.concatenate([self.points[i][k] for i in order])
               for k in ("pts", "desc", "normal", "max_d", "min_d")}
        if len(cat["pts"]) > C:
            cam = self.step.cfg.camera
            pc = cat["pts"] @ Tcw_last[:3, :3].T + Tcw_last[:3, 3]
            z = np.maximum(pc[:, 2], 1e-9)
            u = cam.K[0, 0] * pc[:, 0] / z + cam.K[0, 2]
            v = cam.K[1, 1] * pc[:, 1] / z + cam.K[1, 2]
            m = FRUSTUM_MARGIN
            vis = ((pc[:, 2] > 0) & (u >= -m) & (u < cam.width + m) & (v >= -m)
                   & (v < cam.height + m))
            cat = {k: a[vis] for k, a in cat.items()}
        k = min(len(cat["pts"]), C)
        pts = np.zeros((C, 3), np.float32)
        desc = np.zeros((C, 8), np.int32)
        min_d = np.ones(C, np.float32)
        max_d = np.ones(C, np.float32)
        normal = np.zeros((C, 3), np.float32)
        valid = np.zeros(C, bool)
        pts[:k], desc[:k], normal[:k] = cat["pts"][:k], cat["desc"][:k], cat["normal"][:k]
        min_d[:k], max_d[:k], valid[:k] = cat["min_d"][:k], cat["max_d"][:k], True
        return pts, desc, min_d, max_d, normal, valid

    def upload(self, arrays):
        return upload_candidates(arrays, self.step.device)

    def __call__(self, Tcw_last: np.ndarray):
        return self.upload(self.candidate_arrays(Tcw_last))


def tracking_entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
                   n_frames: int = 520, first: int = 8, count: int = 48,
                   world: SyntheticMeshWorld | None = None, n_features: int = 2000,
                   n_cand: int = 2048):
    """(step, frames, carry0, candidates, poses_gt): the tracking step seeded
    from ground truth on the standard circuit of `n_frames` frames.

    - `frames`: [count, H, W] uint8 on `device`, frames first .. first+count-1
      of the circuit, rendered (with frame first-2 and first-1, which only
      seed) by `SyntheticMeshWorld.render_frames`;
    - `carry0`: `seed_carry` of frame first-1 at its true pose, the velocity
      the true motion from frame first-2;
    - `candidates`: the local-map stand-in (`GroundTruthMap`) built from
      keyframes every 10 frames from first-1 to the window's end; called with
      the last pose, it returns the step's six candidate tensors;
    - `poses_gt`: [count, 4, 4] f32 true poses of `frames`.
    `world` defaults to `SyntheticMeshWorld.generate(seed=0)` (190x190 grid);
    the tests pass a coarser terrain with fewer features and candidates.
    """
    device = kernels.resolve_device(device, "tracking_entry()")
    if first < 2 or count < 1:
        raise ValueError(f"need first >= 2 and count >= 1, got first={first}, count={count}")
    world = SyntheticMeshWorld.generate(seed=0) if world is None else world
    step = FusedTrackStep(tracking_config(world, height, width, n_features), n_cand, device)
    ids = list(range(first - 2, first + count))
    rendered = world.render_frames(ids, n_frames, width, height, device=device)
    poses = np.stack([world.pose_at(i, n_frames) for i in ids])
    carry0 = seed_carry(step, rendered[1], poses[1], poses[0])
    kf = list(range(1, len(ids), KEYFRAME_EVERY))
    gt_map = GroundTruthMap(step, [rendered[j] for j in kf], poses[kf])
    return step, rendered[2:], carry0, gt_map, poses[2:]


# ---------------------------------------------------------------------------
# Mapping: NMI initialization, then tracking against the map being built
# ---------------------------------------------------------------------------

INIT_FRAMES = (0, 8)  # the replay's init pair: frame 0 and frame NMI.Offset


def mapping_config(world: SyntheticMeshWorld, height: int, width: int, n_features: int = 2000,
                   max_keyframes: int = 512, n_levels: int = 8, threshold: float = 0.45,
                   max_frames: int = 30, vocabulary_path: str = "") -> SystemConfig:
    """The JAX package's full-circuit replay configuration
    (`tools/replay_bench.py:113-140`, `:182-184`): the world's camera at
    `width` x `height`, 30 fps; ORB with `n_features` on `n_levels` levels
    (8); NMI offset 8, accept threshold `threshold` (0.45; 0.1 on the
    domain-gap imagery), near/far from the world, 4 iterations, a
    relocalization every 2nd keyframe, half-resolution coarse sweeps;
    `max_keyframes` keyframes (512 in the replay) and 256 map points each,
    a keyframe at least every `max_frames` frames; a vocabulary file, if
    given, loaded at the start."""
    K = world.camera_K(width, height)
    near, far = world.near_far()
    return SystemConfig(
        camera=CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                            cy=float(K[1, 2]), width=width, height=height, fps=30.0),
        orb=ORBConfig(n_features=n_features, n_levels=n_levels),
        nmi=NMIConfig(offset=INIT_FRAMES[1] - INIT_FRAMES[0], threshold=threshold,
                      render_near=near, render_far=far, grid=NMIGridConfig(),
                      max_iteration_count=4, reloc_frequency=2, coarse_scale=2),
        tracking=TrackingConfig(max_frames=max_frames, max_keyframes=max_keyframes,
                                max_map_points=max_keyframes * 256,
                                max_features=max(2048, n_features + 48)),
        vocabulary_path=vocabulary_path,
    )


class MappingSession:
    """The mapping path on one device, driven a step at a time.

    - `initialize()`: NMI initialization on `INIT_FRAMES` (each latch seeded
      one translation grid step off the true pose on x), then `start`;
    - `start(result, f1, f2)`: tracking begins after an initialization on
      f1 and f2: the tracking carry seeded from the second frame with no
      velocity, as after the JAX tracker's `_initialize`;
    - `track_frame(i)`: one frame through the step against the map, with
      the pipelined front-end's host code (`slam/frontend_pipelined.py`:
      `local_candidates`, `bind_step`, `count_visible_found`), a keyframe
      every `keyframe_every` frames after initialization, and the carry
      reseeded from this frame when the map changed. The fixed cadence and
      the carry reseeded without a `Tcr` rebase make it a harness of the
      step and the mapper: `PipelinedFrontend` with `Tracker.
      _need_new_keyframe` is the system's front-end.
    - `flush()`: waits for the mapping worker and raises its errors.

    `system` is a `slam/system.SLAMSystem` with async mapping on the
    session's device (`map`, `local_mapper`, `localizer` and `pipeline` are
    its own); its tracker stays unused. The mapping worker starts with the
    session (`shutdown()` stops it); keyframes go to `keyframe_sink`, the
    pipeline's `insert_keyframe`. With `place_recognition` the system trains
    the vocabulary at a keyframe and closes loops.
    """

    def __init__(self, world: SyntheticMeshWorld, cfg: SystemConfig, frames: torch.Tensor,
                 poses: np.ndarray, frame_ids: list, n_cand: int, device: torch.device,
                 keyframe_every: int, n_frames: int = 520, place_recognition: bool = False):
        self.world, self.cfg, self.device, self.n_frames = world, cfg, device, n_frames
        self.frames, self.poses, self.frame_ids = frames, poses, list(frame_ids)
        self.keyframe_every = keyframe_every
        self.step = FusedTrackStep(cfg, n_cand, device)
        self.system = SLAMSystem(cfg, nmi_mesh=world.mesh, async_mapping=True, device=device,
                                 output_dir=tempfile.mkdtemp(prefix="mapping_session_"),
                                 place_recognition=place_recognition)
        self.map, self.local_mapper = self.system.map, self.system.local_mapper
        self.localizer, self.pipeline = self.system.localizer, self.system.pipeline
        self.keyframe_sink = self.pipeline.insert_keyframe
        self.track_ids = [i for i in self.frame_ids if i > INIT_FRAMES[1]]
        self.init_frames: list = []
        self.carry = None
        self.last: FrameData | None = None
        self.ref_kf = -1
        self.velocity = None
        self.seen_version = -1
        self.keyframes: list = []  # (frame id, keyframe id)

    def frame(self, i: int) -> torch.Tensor:
        return self.frames[self.frame_ids.index(i)]

    def true_pose(self, i: int) -> np.ndarray:
        return self.poses[self.frame_ids.index(i)]

    def features(self, i: int, frame: torch.Tensor | None = None) -> FrameData:
        """FrameData of frame i (or of the uint8 image `frame`, frame i's): the
        step's ORB features, no pose yet."""
        f = self.step.extract(self.frame(i) if frame is None else frame)
        h = {k: to_host(getattr(f, k)) for k in ("xy", "octave", "angle", "desc", "valid")}
        return FrameData(frame_id=i, timestamp=i / self.cfg.camera.fps, Tcw=None, xy=h["xy"],
                         xy_raw=h["xy"], octave=h["octave"], angle=h["angle"],
                         desc=h["desc"].view(np.uint32), valid=h["valid"])

    def seed_pose(self, i: int) -> np.ndarray:
        """The pose a latch starts from: the true pose, moved one translation
        grid step along the camera's x axis."""
        T = self.true_pose(i).copy()
        T[0, 3] -= self.cfg.nmi.grid.synth_step[0]
        return T

    def initialize(self) -> initialization.InitResult:
        f1, f2 = (self.features(i) for i in INIT_FRAMES)
        f1.Tcw, f2.Tcw = self.seed_pose(INIT_FRAMES[0]), self.seed_pose(INIT_FRAMES[1])
        res = initialization.nmi_initialize(
            self.cfg, self.map, self.local_mapper, f1, f2, localizer=self.localizer,
            gray1=self.frame(INIT_FRAMES[0]), gray2=self.frame(INIT_FRAMES[1]))
        self.start(res, f1, f2)
        return res

    def start(self, res: initialization.InitResult, f1: FrameData, f2: FrameData) -> None:
        """Begin tracking after `nmi_initialize` on f1 and f2 gave `res`."""
        self.init_frames = [f1, f2]
        if res.ok:
            self.ref_kf = res.k2
            self.last = f2
            self.velocity = None
            with self.map.lock:
                self.carry = carry_from_frame(f2, self.map, None, self.device)
                self.seen_version = self.map.version

    def track_frame(self, i: int) -> dict:
        """Track frame i (after the last one tracked); returns its record."""
        m, step = self.map, self.step
        t0 = time.perf_counter()
        with m.lock:
            kfs, self.ref_kf = local_keyframes(m, self.last.mp_idx, self.ref_kf)
            cand_ids, arrays = local_candidates(m, self.cfg, kfs, self.ref_kf, self.last.Tcw,
                                                step.n_cand)
        t1 = time.perf_counter()
        busy = not self.pipeline.idle()
        out = step(self.frame(i), self.carry, *upload_candidates(arrays, self.device))
        u = unpack_step(to_host(out.packed), step.n_feat, step.n_cand)
        t2 = time.perf_counter()

        mp_idx, has_cand, outlier = bind_step(u, self.last.mp_idx, cand_ids)
        bound = mp_idx >= 0
        frame = step_frame(u, i, i / self.cfg.camera.fps, mp_idx, outlier)
        k_new = -1
        with m.lock:
            reseed = m.version != self.seen_version  # a map correction landed
            count_visible_found(m, cand_ids, u, mp_idx, has_cand)
            still = m.mp_valid[np.maximum(mp_idx, 0)] & bound
            frame.mp_idx = np.where(still, mp_idx, -1)
            self.velocity = u.velocity
            _, self.ref_kf = local_keyframes(m, frame.mp_idx, self.ref_kf)
            if (i - INIT_FRAMES[1]) % self.keyframe_every == 0:
                k_new = m.add_keyframe(frame.Tcw, i, frame.timestamp, frame.xy, frame.octave,
                                       frame.angle, frame.desc, frame.valid,
                                       mp_idx=np.where(frame.outlier, -1, frame.mp_idx))
                self.ref_kf = k_new
                self.keyframes.append((i, k_new))
                self.system.ensure_vocabulary(frame.desc, frame.valid, frame_id=i)
                self.keyframe_sink(k_new)
                reseed = True  # the map changed: re-anchor the device chain
            frame.mp_idx[frame.outlier] = -1
            frame.outlier[:] = False
            if reseed:
                self.carry = carry_from_frame(frame, m, self.velocity, self.device)
                self.seen_version = m.version
            else:
                self.carry = out.carry
        self.last = frame
        t3 = time.perf_counter()
        err = float(np.linalg.norm(_center(u.Tcw) - _center(self.true_pose(i))))
        return dict(frame=i, n_matches1=u.n_matches1, n_inliers=u.n_inliers,
                    n_cand=len(cand_ids), err_m=err, keyframe=k_new, reseed=bool(reseed),
                    worker_busy=busy, cand_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3,
                    process_ms=(t3 - t2) * 1e3, t_end=t3,
                    passed=u.n_matches1 >= 20 and u.n_inliers >= 10)

    def point_errors(self, k: int) -> np.ndarray:
        """Distances (m) of keyframe k's valid map points to the ray-cast
        oracle: the terrain point under each observing pixel, seen from the
        keyframe frame's true pose."""
        m = self.map
        with m.lock:
            fs = np.nonzero(m.kf_mp_idx[k] >= 0)[0]
            ps = m.kf_mp_idx[k, fs]
            keep = m.mp_valid[ps]
            fs, ps = fs[keep], ps[keep]
            pos = m.mp_pos[ps].astype(np.float64)
            xy = m.kf_feat_xy[k, fs]
            T = self.true_pose(int(m.kf_frame_id[k]))
        return np.linalg.norm(pos - ground_truth_landmarks(self.cfg.camera.K, T, xy), axis=-1)

    def flush(self, timeout: float = 600.0) -> None:
        if not self.pipeline.flush(timeout):
            raise RuntimeError(f"the mapping worker did not drain within {timeout} s")
        errors = self.pipeline.errors()
        if errors:
            raise RuntimeError("the mapping worker failed:\n" + errors[0])

    def shutdown(self) -> None:
        self.pipeline.shutdown()


def mapping_entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
                  n_frames: int = 520, last: int = 68, keyframe_every: int = KEYFRAME_EVERY,
                  world: SyntheticMeshWorld | None = None, n_features: int = 2000,
                  n_cand: int = 2048, max_keyframes: int = 512,
                  place_recognition: bool = False) -> MappingSession:
    """The mapping path on the full-circuit replay configuration
    (`mapping_config`): frames 0, 8 and 9 .. `last` of the `n_frames`
    circuit rendered on `device` by `SyntheticMeshWorld.render_frames` (B3
    and the sampler), the localizer on the world's own mesh (render mode 1,
    so B3, the sampler, B2 and B1 run inside both latches), the tracking
    step with `n_cand` candidates, a keyframe every `keyframe_every` frames,
    and the mapping worker started (`shutdown()` stops it). With
    `place_recognition` the session's system trains a vocabulary and closes
    loops (`SLAMSystem`'s place recognition; `loop_entry` turns it on).
    """
    device = kernels.resolve_device(device, "mapping_entry()")
    world = SyntheticMeshWorld.generate(seed=0) if world is None else world
    cfg = mapping_config(world, height, width, n_features, max_keyframes)
    ids = [INIT_FRAMES[0]] + list(range(INIT_FRAMES[1], last + 1))
    frames = world.render_frames(ids, n_frames, width, height, device=device)
    poses = np.stack([world.pose_at(i, n_frames) for i in ids])
    return MappingSession(world, cfg, frames, poses, ids, n_cand, device, keyframe_every,
                          n_frames=n_frames, place_recognition=place_recognition)


# ---------------------------------------------------------------------------
# Place recognition and loop closing: a revisit arc with drift
# ---------------------------------------------------------------------------

# The circuit re-traverses its start arc in its last 10 % (`SyntheticMeshWorld.
# overlap`): frame i has the pose of frame i - 471.8 (519 / 1.1). These eight
# frames revisit frames 4.2 .. 46.2.
REVISIT_ARC = tuple(range(476, 519, 6))
ARC_DRIFT = dict(scale=1.04, yaw=0.03, t=(0.5, -0.3, 0.1))  # the arc's Sim(3) drift


def drift_sim3(scale: float, yaw: float, t) -> np.ndarray:
    """The world-frame similarity D = [s Rz(yaw) | t] (float64 [4, 4])."""
    c, s_ = np.cos(yaw), np.sin(yaw)
    D = np.eye(4)
    D[:3, :3] = scale * np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    D[:3, 3] = t
    return D


def add_revisit_arc(session: MappingSession, frame_ids=REVISIT_ARC, drift=None) -> list:
    """Add a revisit of the circuit's start as keyframes with a Sim(3) drift,
    the state a loop closure meets (the map-building harness of
    `tests/test_loop_closing.py:38-97` on the rendered circuit).

    Each frame of `frame_ids` is rendered on the session's device (B3 and the
    sampler) and its features taken by the step's `extract`. With the drift
    D (`drift`, a 4x4 similarity; `ARC_DRIFT` by default):
      * the keyframe's pose keeps its projections exact in the drifted world:
        centre D(c), rotation R_cw R_D^T;
      * its landmarks are the ray-cast terrain points under its features
        (`ground_truth_landmarks`), carried through D;
      * consecutive arc keyframes share the landmarks of the features that
        `match_descriptors` pairs between them (TH_LOW, ratio 0.75, rotation
        check); every other valid feature gets a new point. Points get the
        map store's statistics (`update_point_stats`).
    No arc keyframe observes a point of the map before it, so the arc is not
    covisible with it. The caller runs the loop closer on the keyframes.
    Returns [(frame id, keyframe id)]."""
    m, cfg = session.map, session.cfg
    D = drift_sim3(**ARC_DRIFT) if drift is None else np.asarray(drift, np.float64)
    sD = float(np.linalg.norm(D[:3, 0]))
    RD = D[:3, :3] / sD
    frames = session.world.render_frames(list(frame_ids), session.n_frames, cfg.camera.width,
                                         cfg.camera.height, device=session.device)
    K = cfg.camera.K
    dev = session.device
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out, prev = [], None
    for i, img in zip(frame_ids, frames):
        f = session.features(i, img)
        T = session.world.pose_at(i, session.n_frames)
        c = D[:3, :3] @ _center(T) + D[:3, 3]
        Tc = np.eye(4)
        Tc[:3, :3] = T[:3, :3].astype(np.float64) @ RD.T
        Tc[:3, 3] = -Tc[:3, :3] @ c
        pts = np.zeros((len(f.xy), 3), np.float32)
        v = f.valid
        pts[v] = (ground_truth_landmarks(K, T, f.xy[v]).astype(np.float64) @ D[:3, :3].T
                  + D[:3, 3]).astype(np.float32)
        shared = np.full(len(f.xy), -1, np.int32)
        with m.lock:
            if prev is not None:
                k0, f0 = prev
                has = m.kf_mp_idx[k0, : len(f0.xy)] >= 0
                idx, _ = matching.match_descriptors(
                    up(f.desc.view(np.int32)), up(v), up(f0.desc.view(np.int32)), up(has),
                    max_dist=matching.TH_LOW, nn_ratio=0.75, angle_a=up(f.angle),
                    angle_b=up(f0.angle), check_rotation=True)
                idx = to_host(idx)
                hit = idx >= 0
                shared[hit] = m.kf_mp_idx[k0, idx[hit]]
            k = m.add_keyframe(Tc.astype(np.float32), i, i / cfg.camera.fps, f.xy, f.octave,
                               f.angle, f.desc, f.valid, mp_idx=shared)
            for r in np.nonzero(v & (shared < 0))[0]:
                p = m.add_map_point(pts[r], f.desc[r], k, np.zeros(3, np.float32))
                m.add_observation(k, int(r), p)
            for p in np.unique(m.kf_mp_idx[k][m.kf_mp_idx[k] >= 0]):
                m.update_point_stats(int(p), K, cfg.orb.scale_factor, cfg.orb.n_levels)
        out.append((i, k))
        prev = (k, f)
    return out


def relocalize_pnp(session: MappingSession, i: int, frame: torch.Tensor | None = None,
                   generator: torch.Generator | None = None, min_matches: int = 15) -> list:
    """The BoW + PnP half of relocalization (`Tracker.pnp_try`, the first
    half of `Tracker._relocalize`) of frame i (or the uint8 image `frame`)
    against the session's map, at its features: each of the database's
    relocalization candidates in turn, up to the first whose PnP succeeds,
    the samples drawn uniformly on a CPU `generator` (seed 11 by default).
    Returns the records of the candidates tried (`Tracker.pnp_try`): the
    candidate, its matches, the solver's inputs (host arrays, so the solve
    can be repeated on another device) and its result."""
    m = session.map
    db = session.system.database
    if db is None:
        raise RuntimeError("no keyframe database yet: the vocabulary has not been trained")
    generator = torch.Generator().manual_seed(11) if generator is None else generator
    f = session.features(i, frame)

    def draw(n_rows, n_valid, n_hyp, size):
        return draw_uniform(generator, n_valid, n_hyp, size)

    tries = []
    with m.lock:
        for cand in db.detect_relocalization_candidates(m, f.desc, f.valid):
            rec = session.system.tracker.pnp_try(f, cand, min_matches, draw)
            if rec is None:
                continue
            tries.append(rec)
            if rec.get("ok"):
                break
    return tries


def loop_entry(device: str | torch.device = "cuda", height: int = 540, width: int = 960,
               **kw) -> MappingSession:
    """`mapping_entry`'s session (the full-circuit replay configuration at
    960x540 by default; the same keyword arguments) with the place-
    recognition hooks wired: the vocabulary trains from the first keyframes
    (`SLAMSystem.ensure_vocabulary`), and the keyframe database and the
    loop closer, with the pipeline's global-BA launcher, come with it. Then
    `add_revisit_arc(session)` adds the drifted revisit of the circuit's
    start, and `session.system.loop_closer.process_keyframe(k)` closes the
    loop:

        session = loop_entry()
        session.initialize()
        for i in session.track_ids:
            session.track_frame(i)
        session.flush()
        arc = add_revisit_arc(session)
        for _, k in arc:
            with session.map.lock:
                session.system.loop_closer.process_keyframe(k)
        session.flush()  # the global BA
    """
    kernels.resolve_device(device, "loop_entry()")
    return mapping_entry(device=device, height=height, width=width, place_recognition=True,
                         **kw)


# ---------------------------------------------------------------------------
# The whole system on the circuit
# ---------------------------------------------------------------------------

CIRCUIT_FRAMES = 520
CIRCUIT_SEED = 1  # the JAX package's records come from the seed-1 world


def circuit_system(device: str | torch.device = "cuda", asynchronous: bool = True):
    """(system, world): `circuit_entry`'s system, without the imagery: a
    fresh `SLAMSystem` on the seed-1 world's circuit configuration
    (`tools/replay_bench.build_system` at its defaults), its workers started
    and its init poses set. With `asynchronous` off, local
    mapping and the keyframes' NMI sweeps run synchronously, at the keyframe
    that asks for them."""
    from orbslam2_nmi_torch.tools.replay_bench import build_system

    device = kernels.resolve_device(device, "circuit_system()")
    n = CIRCUIT_FRAMES
    world = SyntheticMeshWorld.generate(seed=CIRCUIT_SEED)
    system = build_system(world, 960, 540, async_mapping=asynchronous, async_nmi=asynchronous,
                          output_dir=tempfile.mkdtemp(prefix="circuit_"), device=device)
    system.set_init_poses(world.pose_at(0, n), world.pose_at(system.cfg.nmi.offset, n))
    return system, world


def circuit_entry(device: str | torch.device = "cuda"):
    """(system, frames, poses): the whole system on the JAX package's full-
    circuit record (`tools/replay_bench.build_system` and `generate_sequence`,
    FULL_CIRCUIT_r05.json): the seed-1 standard world, the `mapping_config`
    configuration at its defaults (960x540, 2,000 features on 8 levels, NMI
    offset 8, threshold 0.45, 4 iterations, coarse_scale 2, reloc_frequency
    2, max_frames 30, 512 keyframes), async mapping and async NMI, the
    localizer on the world's own mesh, and the init poses frames 0 and 8's
    true poses (`circuit_system`).

    - `system`: a `SLAMSystem` on `device` (its workers started; call
      `shutdown()`), to drive through `PipelinedFrontend(system).run`;
    - `frames`: all 520 frames, uint8 [520, 540, 960] on `device`, rendered
      by `SyntheticMeshWorld.render_frames` (B3 and the sampler);
    - `poses`: [520, 4, 4] float32 true poses.
    """
    system, world = circuit_system(device)
    n = CIRCUIT_FRAMES
    frames = world.render_frames(list(range(n)), n, 960, 540, device=system.device)
    poses = np.stack([world.pose_at(i, n) for i in range(n)])
    return system, frames, poses


# ---------------------------------------------------------------------------
# The settings-file entry: a scene on disk in the reference's formats
# ---------------------------------------------------------------------------

SETTINGS_LAYOUTS = ("eth", "newer_college")
SETTINGS_T0 = 1_600_000_000  # the first frame's stamp, seconds since the epoch
CLOUD_OFFSET = (1000.0, -2000.0, 100.0)  # NMI.Render.Offset: the model file's origin
CLOUD_DENSITY = 100.0  # the pointcloud's samples a square metre (render.mesh_to_points)


class SettingsScene(NamedTuple):
    settings: str  # the settings YAML
    sequence: str  # the image sequence's directory
    cfg: SystemConfig  # what `load_yaml_config(settings)` gives
    world: SyntheticMeshWorld
    frames: torch.Tensor  # uint8 [N, H, W], as written
    poses: np.ndarray  # [N, 4, 4] float32 true Tcw of the frames
    cloud: PointCloudModel  # what the XYZ and offset files hold, the offset removed


def _yaml_matrix(name: str, m: np.ndarray) -> str:
    rows, cols = m.shape
    data = ", ".join(repr(float(x)) for x in np.asarray(m, np.float32).ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: f\n"
            f"   data: [ {data} ]\n")


def write_settings_yaml(path: str, cfg: SystemConfig) -> None:
    """Write every field of `cfg` that a settings file carries, in the
    reference's OpenCV layout (Examples/Monocular/ETH_small.yaml's keys;
    `load_yaml_config` reads it back into `cfg`'s values). Floats are
    written as Python's shortest exact repr, matrices as float32."""
    c, o, n, g, v = cfg.camera, cfg.orb, cfg.nmi, cfg.nmi.grid, cfg.viewer

    def num(x) -> str:
        return repr(float(x))

    lines = ["%YAML:1.0", ""]
    lines += [f"Camera.{k}: {num(getattr(c, k))}"
              for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "fps")]
    lines += [f"Camera.RGB: {int(c.rgb)}", f"Camera.Width: {int(c.width)}",
              f"Camera.Height: {int(c.height)}", "",
              f"ORBextractor.nFeatures: {int(o.n_features)}",
              f"ORBextractor.scaleFactor: {num(o.scale_factor)}",
              f"ORBextractor.nLevels: {int(o.n_levels)}",
              f"ORBextractor.iniThFAST: {int(o.ini_th_fast)}",
              f"ORBextractor.minThFAST: {int(o.min_th_fast)}", ""]
    lines += [f"Viewer.{k}: {num(x)}" for k, x in (
        ("KeyFrameSize", v.keyframe_size), ("KeyFrameLineWidth", v.keyframe_line_width),
        ("GraphLineWidth", v.graph_line_width), ("PointSize", v.point_size),
        ("CameraSize", v.camera_size), ("CameraLineWidth", v.camera_line_width),
        ("ViewpointX", v.viewpoint[0]), ("ViewpointY", v.viewpoint[1]),
        ("ViewpointZ", v.viewpoint[2]), ("ViewpointF", v.viewpoint_f))]
    lines += ["", f"NMI.Offset: {int(n.offset)}", f"NMI.Treshold: {num(n.threshold)}"]
    for key, vals, fmt in (("SynthNum", g.synth_num, int), ("SynthStep", g.synth_step, num),
                           ("WarpNum", g.warp_num, int), ("WarpStep", g.warp_step, num)):
        lines += [f"NMI.{key}{ax}: {fmt(x)}" for ax, x in zip("XYZ", vals)]
    lines += [f"NMI.Render.PointSize: {num(n.render_point_size)}",
              f"NMI.Render.NearPlane: {num(n.render_near)}",
              f"NMI.Render.FarPlane: {num(n.render_far)}"]
    lines += [f'NMI.Render.{k}: "{p}"' for k, p in (
        ("Object", n.model_obj_path), ("Texture", n.model_texture_path),
        ("Cloud", n.model_cloud_path), ("Offset", n.model_offset_path)) if p]
    text = "\n".join(lines) + "\n"
    for name, m in (("NMI.Init1", n.init1), ("NMI.Init2", n.init2)):
        if m is not None:
            text += _yaml_matrix(name, m)
    with open(path, "w") as f:
        f.write(text)


def rgb_of_gray(gray: np.ndarray) -> np.ndarray:
    """[P, 3] float32 colours whose luma, as the XYZ readers compute it
    (`model_loader.load_xyz_pointcloud`: 0.299 r + 0.587 g + 0.114 b in
    float32), is `gray` exactly: r = g and b within a few float32 steps of
    `gray`. Raises where no such pair is near."""
    gray = np.ascontiguousarray(gray, np.float32)
    bits = gray.view(np.int32)
    rgb = np.empty((len(gray), 3), np.float32)
    todo = np.arange(len(gray))
    for k in (0, 1, -1, 2, -2, 3, -3, 4, -4, 5, -5):
        for j in range(-12, 13):
            if not len(todo):
                return rgb
            w = (bits[todo] + k).view(np.float32)
            b = (bits[todo] + j).view(np.float32)
            ok = (0.299 * w + 0.587 * w + 0.114 * b) == gray[todo]
            rgb[todo[ok]] = np.stack([w[ok], w[ok], b[ok]], -1)
            todo = todo[~ok]
    if len(todo):
        raise ValueError(f"no exact colour for {len(todo)} gray values, e.g. {gray[todo[0]]}")
    return rgb


def write_settings_scene(out_dir: str, n_frames: int, n_total: int = CIRCUIT_FRAMES,
                         domain_gap: bool = False, layout: str = "eth",
                         world: SyntheticMeshWorld | None = None, width: int = 960,
                         height: int = 540, fps: float = 30.0, n_features: int = 2000,
                         n_levels: int = 8, cloud_density: float = CLOUD_DENSITY,
                         frames: torch.Tensor | None = None,
                         device: str | torch.device = "cuda") -> SettingsScene:
    """Write a world and the first `n_frames` of its `n_total`-frame circuit
    to `out_dir` as a user brings a dataset, for `run_replay --settings
    OUT/settings.yaml --sequence OUT/sequence`:

    - `settings.yaml` (`write_settings_yaml`): the camera from the world's K
      at `width` x `height` and `fps`; ORB with `n_features` on `n_levels`
      levels; NMI offset 8 (`INIT_FRAMES`), accept threshold 0.1 with
      `domain_gap`, else 0.45, the reference's search grid, near/far from
      the world; the model files by absolute path; `NMI.Init1`/`NMI.Init2`
      the true Twc of frames 0 and 8;
    - the prior model: `model.obj` (v, vt and f records, per-vertex UVs,
      floats as "%.9g", so float32 values read back exactly) with
      `model_texture.npy`, and `model.xyz` (`render.mesh_to_points` at
      `cloud_density` samples a square metre, shifted by `CLOUD_OFFSET`,
      "%.17g", colours from `rgb_of_gray`) with `model_offset.txt`;
    - the frames (`frames` if given, else `replay_bench.render_sequence`;
      the seed-1 circuit's world unless `world` is given) as uint8 `.npy`
      images in
      `OUT/sequence`: with `layout` "eth", `<i:06d>.npy` named in
      `OUT/sequence_files.txt` and stamped in `OUT/sequence/_times.txt`
      (mono_ETH.cc:164-199); with "newer_college", named `<sec>_<nsec>.npy`
      (mono_newer_college.cc). Frame i is stamped SETTINGS_T0 + i / fps.

    Nothing on the system's path calls this: it makes a local stand-in for
    a dataset. Returns the paths, the config the YAML holds, the world, the
    frames, their true poses and the pointcloud."""
    from orbslam2_nmi_torch.io import model_loader
    from orbslam2_nmi_torch.tools import replay_bench

    if layout not in SETTINGS_LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {SETTINGS_LAYOUTS}")
    device = kernels.resolve_device(device, "write_settings_scene()")
    world = world or SyntheticMeshWorld.generate(seed=CIRCUIT_SEED)
    if frames is None:
        frames = replay_bench.render_sequence(world, n_frames, width, height, n_total,
                                              domain_gap, CIRCUIT_SEED, device)
    if tuple(frames.shape) != (n_frames, height, width):
        raise ValueError(f"frames {tuple(frames.shape)} are not {n_frames} of {height}x{width}")
    out_dir = os.path.abspath(out_dir)
    seq = os.path.join(out_dir, "sequence")
    shutil.rmtree(seq, ignore_errors=True)
    os.makedirs(seq)
    files_list = seq + "_files.txt"
    if os.path.exists(files_list):
        os.remove(files_list)

    mesh = world.mesh
    path = {k: os.path.join(out_dir, f) for k, f in (
        ("obj", "model.obj"), ("texture", "model_texture.npy"), ("cloud", "model.xyz"),
        ("offset", "model_offset.txt"), ("settings", "settings.yaml"))}
    with open(path["obj"], "w") as f:
        np.savetxt(f, mesh.vertices, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, mesh.uvs, fmt="vt %.9g %.9g")
        np.savetxt(f, np.repeat(mesh.faces.astype(np.int64) + 1, 2, axis=1),
                   fmt="f %d/%d %d/%d %d/%d")
    np.save(path["texture"], mesh.texture_gray.astype(np.float32))
    cloud = render.mesh_to_points(mesh, samples_per_unit_area=cloud_density)
    off = np.asarray(CLOUD_OFFSET, np.float64)
    model_loader.save_xyz_pointcloud(path["cloud"], cloud.points.astype(np.float64) + off,
                                     rgb_of_gray(cloud.gray), fmt="%.17g")
    np.savetxt(path["offset"], off[None], fmt="%.17g")

    poses = np.stack([world.pose_at(i, n_total) for i in range(n_frames)])
    near, far = world.near_far()
    K = world.camera_K(width, height)

    def twc(i: int) -> np.ndarray:
        return np.linalg.inv(world.pose_at(i, n_total).astype(np.float64)).astype(np.float32)

    offset = INIT_FRAMES[1] - INIT_FRAMES[0]
    cfg = SystemConfig(
        camera=CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                            cy=float(K[1, 2]), width=width, height=height, fps=float(fps)),
        orb=ORBConfig(n_features=n_features, n_levels=n_levels),
        nmi=NMIConfig(init1=twc(0), init2=twc(offset), offset=offset,
                      threshold=0.1 if domain_gap else 0.45, render_near=near, render_far=far,
                      model_obj_path=path["obj"], model_texture_path=path["texture"],
                      model_cloud_path=path["cloud"], model_offset_path=path["offset"]),
        tracking=TrackingConfig(max_frames=int(round(fps))))
    write_settings_yaml(path["settings"], cfg)

    host = frames.cpu().numpy()
    stamps = [SETTINGS_T0 * 10**9 + round(i * 1e9 / fps) for i in range(n_frames)]  # ns
    if layout == "eth":
        names = [f"{i:06d}.npy" for i in range(n_frames)]
        with open(os.path.join(seq, "_times.txt"), "w") as f:
            f.writelines(f"{ns // 10**9}.{ns % 10**9:09d}\n" for ns in stamps)
        with open(files_list, "w") as f:
            f.writelines(n + "\n" for n in names)
    else:
        names = [f"{ns // 10**9}_{ns % 10**9:09d}.npy" for ns in stamps]
    for name, img in zip(names, host):
        np.save(os.path.join(seq, name), img)
    return SettingsScene(settings=path["settings"], sequence=seq, cfg=cfg, world=world,
                         frames=frames, poses=poses, cloud=cloud)


# ---------------------------------------------------------------------------
# The sharded paths on a world of ranks
# ---------------------------------------------------------------------------


def _dryrun_rank() -> dict:
    """One rank of `dryrun_multichip`: each sharded path once, at the JAX
    package's dry-run shapes (`__graft_entry__.py:90-218`)."""
    from orbslam2_nmi_torch.parallel import distributed, mesh as mesh_lib
    from orbslam2_nmi_torch.parallel import sharded_ba, sharded_nmi, sharded_pose_graph
    from orbslam2_nmi_torch.solvers import local_ba, pose_graph

    dev = distributed.local_device()
    mesh = mesh_lib.make_mesh()
    eye = np.eye(4, dtype=np.float32)
    I4 = torch.eye(4, dtype=torch.float32, device=dev)

    # pose-grid-sharded NMI search (64x80 frames, 8 renders x 4 warps)
    Hh, Ww = 64, 80
    K = np.array([[60.0, 0, 40.0], [0, 60.0, 32.0], [0, 0, 1]], np.float32)
    model = _toy_model(n_points=5000, seed=2, device=dev)
    offsets = render.translation_grid_offsets((2, 2, 2), (0.3, 0.3, 0.3), device=dev)
    angles = homography.rotation_grid_angles((2, 2, 1), (0.03, 0.03, 0.03), device="cpu").numpy()
    frame = render.render_pointcloud(model, I4, K, Hh, Ww, 5.0, 30.0, 3)
    scores = sharded_nmi.sharded_nmi_search(mesh, model, frame, I4, offsets, angles, K, Hh, Ww,
                                            5.0, 30.0)
    assert scores.shape == (8, 4), scores.shape

    # the mesh-raster sharded NMI search (the reference's default render mode 1)
    binned = raster.bin_mesh(_toy_mesh(n=24, seed=4), eye, K, Hh, 128, 5.0, 40.0,
                             max_offset=(0.3, 0.3, 0.3), device=dev)
    frame_m = raster.render_mesh_grid(binned, I4, K, torch.zeros(1, 3, device=dev), 5.0,
                                      40.0)[0]
    scores_m = sharded_nmi.sharded_nmi_search_mesh(mesh, binned, frame_m, I4, offsets, angles,
                                                   K, 5.0, 40.0)
    assert scores_m.shape == (8, 4), scores_m.shape

    # the point-sharded Schur BA (6 cameras, 64 points, every point in every camera)
    rng = np.random.default_rng(3)
    n_cams, n_pts = 6, 64
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 12, n_pts)], -1).astype(np.float32)
    Kb = np.array([[100.0, 0, 40], [0, 100.0, 32], [0, 0, 1]], np.float32)
    cams = np.tile(eye, (n_cams, 1, 1))
    cams[:, 0, 3] = np.linspace(0, 1, n_cams)
    pc = np.einsum("cij,pj->cpi", cams[:, :3, :3], pts) + cams[:, None, :3, 3]
    uv = (pc[..., :2] / pc[..., 2:3] * [100.0, 100.0] + [40.0, 32.0]).reshape(-1, 2)
    O = n_cams * n_pts
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    prob = local_ba.BAProblem(
        K=t(Kb), cam_Tcw=t(cams), cam_fixed=t(np.arange(n_cams) < 2),
        cam_valid=t(np.ones(n_cams, bool)),
        pts_w=t(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        pts_valid=t(np.ones(n_pts, bool)),
        obs_cam=t(np.repeat(np.arange(n_cams), n_pts).astype(np.int32)),
        obs_pt=t(np.tile(np.arange(n_pts), n_cams).astype(np.int32)),
        obs_uv=t(uv.astype(np.float32)), obs_inv_sigma2=t(np.ones(O, np.float32)),
        obs_valid=t(np.ones(O, bool)))
    res = sharded_ba.sharded_bundle_adjust(mesh, prob, iters1=2, iters2=2)
    assert bool(torch.isfinite(res.cam_Tcw).all())

    # the edge-sharded essential graph (the post-loop path)
    V = 9
    est = np.tile(eye, (V, 1, 1))
    est[:, 0, 3] = np.linspace(0, 2, V) + rng.normal(0, 0.02, V)
    ei = list(range(V - 1)) + [0]
    ej = list(range(1, V)) + [V - 1]
    meas = np.stack([est[j] @ np.linalg.inv(est[i]) for i, j in zip(ei, ej)]).astype(np.float32)
    pprob = pose_graph.PoseGraphProblem(
        Scw=t(est), fixed=t(np.arange(V) == 0), valid=t(np.ones(V, bool)),
        edge_i=t(np.asarray(ei, np.int32)), edge_j=t(np.asarray(ej, np.int32)),
        edge_Sji=t(meas), edge_valid=t(np.ones(len(ei), bool)))
    out = sharded_pose_graph.sharded_optimize_pose_graph(mesh, pprob, iters=3)
    assert bool(torch.isfinite(out).all())
    return {"nmi": scores, "nmi_mesh": scores_m, "ba_cam_Tcw": res.cam_Tcw, "pose_graph": out}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     backend: str | None = None) -> list:
    """Run each sharded path once on a fresh world of `n_devices` ranks, at
    tiny shapes (`_dryrun_rank`), print the JAX function's line and return
    every rank's outputs. On CUDA the kernels are built here, before any rank
    starts; NCCL takes one card a rank (gloo, `backend="gloo"`, lets ranks
    share one)."""
    if kernels.resolve_device(device, "dryrun_multichip").type == "cuda":
        kernels.build()
    from orbslam2_nmi_torch.parallel import distributed

    outs = distributed.spawn_world(_dryrun_rank, n_devices, backend=backend, device=device)
    print(f"dryrun_multichip({n_devices}): sharded NMI {tuple(outs[0]['nmi'].shape)} + "
          "sharded BA + sharded pose graph ok")
    return outs
