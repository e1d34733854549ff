"""The port's entry points: the NMI pose-grid step, the localizer, the
tracking step.

`entry()` mirrors `__graft_entry__.entry()` of the JAX package: one full evaluation of
the pose grid around a prior pose. It renders every translation candidate of
the textured prior mesh (kernel B3 and the sampler), warps the live frame by
every rotation hypothesis, scores every (render, warp) pair by NMI (kernels
B1 and B2), and takes the argmax on the device.

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

All three run on CUDA unless the caller passes `device="cpu"` (the CPU runs
the kernels' plain versions; the tests use it at small sizes).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import (CameraConfig, NMIConfig, ORBConfig, SystemConfig,
                                       TrackingConfig)
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, raycast_terrain
from orbslam2_nmi_torch.ops import histogram_nmi, homography, raster, render
from orbslam2_nmi_torch.slam.fused_track import FusedTrackStep, TrackCarry
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer

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


def camera_K(height: int, width: int) -> np.ndarray:
    """The entry's intrinsics: 435 px focal length at 960 px width, scaled
    with the width, principal point at the image center."""
    f = 435.0 * width / 960.0
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)


class NMIGridStep:
    """One pose-grid evaluation against a binned prior mesh, on one device.

    `render`, `warp` and `score` are the step's three stages, callable on
    their own for timing; `__call__` runs all three and the argmax. The
    rotation grid's homographies and shift bound are built once, here.
    """

    def __init__(self, binned: raster.BinnedMesh, K: np.ndarray, offsets: torch.Tensor,
                 angles: np.ndarray, use_background: bool = True):
        self.binned = binned
        self.K = K
        self.offsets = offsets
        self.angles = angles
        self.use_background = use_background
        f32 = dict(dtype=torch.float32, device=binned.tri_data.device)
        self.homographies = homography.homographies_from_angles(
            torch.as_tensor(K, **f32), torch.as_tensor(angles, **f32))
        self.shift_bound = homography.shift_bounds_for_angles(K, angles, binned.height,
                                                              binned.width)

    def render(self, Tcw: torch.Tensor) -> torch.Tensor:
        return raster.render_mesh_grid(self.binned, Tcw, self.K, self.offsets, NEAR, FAR)

    def warp(self, frame_gray: torch.Tensor) -> torch.Tensor:
        return homography.warp_homographies(frame_gray, self.homographies, self.shift_bound)

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
FRUSTUM_MARGIN = 64.0  # px, the candidate pre-filter's (frontend_pipelined.py:193-215)


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
        """Candidate arrays as tensors on the step's device. On CUDA they go
        through pinned memory with non-blocking copies, so the upload does
        not wait for the device."""
        dev = self.step.device
        out = []
        for a in arrays:
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(dev, non_blocking=True))
        return tuple(out)

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
