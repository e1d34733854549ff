"""Fixtures and scenes shared by the port's tests (tests/test_torch_*.py).

Whether a card is present is decided inside the fixture, never while a test
module is imported, so every pytest-xdist worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import raster

# The suite runs in several worker processes at once (pytest-xdist). Torch's
# CPU ops would each start a thread per core in every worker, and the
# oversubscribed threads then wait on each other: one thread a worker.
THREADS = 1
torch.set_num_threads(THREADS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def make_world(n=20000, seed=0):
    """tests/test_nmi.py:make_world's textured point world (strong depth
    structure), as numpy (points [n, 3], gray [n]) float32 arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-18, 18, n)
    y = rng.uniform(-12, 12, n)
    z = rng.uniform(8, 24, n) + 4.0 * np.sin(x * 0.7) * np.cos(y * 0.5)
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    gray = (np.sin(pts[:, 0] * 2.1) * np.cos(pts[:, 1] * 1.7) * 100 + 128).clip(0, 255)
    return pts, gray.astype(np.float32)


def height_field_mesh(n=40, seed=3):
    """tests/test_raster.py:144-169's textured height field, as numpy arrays
    (vertices, uvs, faces, texture)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-12, 12, n)
    ys = np.linspace(-6, 6, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = 10.0 + 0.8 * np.sin(X * 0.9) * np.cos(Y * 1.1)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() - xs[0]) / (xs[-1] - xs[0]),
                    (Y.ravel() - ys[0]) / (ys[-1] - ys[0])], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n + 1], -1),
                            np.stack([a, a + n + 1, a + n], -1)]).astype(np.int32)
    return verts, uvs, faces, rng.uniform(10, 245, (64, 64)).astype(np.float32)


# the camera of tests/test_raster.py:170, for height_field_mesh (near/far 1/50 m)
MESH_CAMERA = dict(fx=100.0, fy=100.0, cx=128.0, cy=24.0, width=256, height=48)


def mesh_frame(mesh, device="cpu"):
    """The port's render of `mesh` (height_field_mesh's arrays) at Tcw = I
    through MESH_CAMERA: [48, 256] f32 on `device`."""
    c = MESH_CAMERA
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]], np.float32)
    b = raster.bin_mesh(MeshModel(*mesh), np.eye(4, dtype=np.float32), K, c["height"],
                        c["width"], 1.0, 50.0, device=device)
    return raster.render_mesh_grid(b, torch.eye(4), K, torch.zeros(1, 3), 1.0, 50.0)[0]


# The reduced tracking scene of the fused-step tests: the circuit on a 60x60
# terrain grid at half the full camera's width and focal length (480x270, fx
# 225, so the field of view is the full camera's), 500 features on 8 levels,
# 256 local-map candidates, seeded from ground truth like tracking_entry().
TRACK_SCENE = dict(height=270, width=480, n_grid=60, fx=225.0, n_features=500, n_cand=256)


def tracking_scene(count=5, device="cpu"):
    """`entry.tracking_entry` on the reduced scene: (step, frames, carry0,
    candidates, poses_gt), frames 8 .. 8+count-1 of the 520-frame circuit."""
    from orbslam2_nmi_torch.entry import tracking_entry
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh

    s = TRACK_SCENE
    world = SyntheticMeshWorld(mesh=terrain_mesh(seed=0, n=s["n_grid"]), fx=s["fx"])
    return tracking_entry(device=device, height=s["height"], width=s["width"], count=count,
                          world=world, n_features=s["n_features"], n_cand=s["n_cand"])


# The reduced mapping scene of the mapping, initialization and pipeline tests:
# the replay configuration on the 60x60 terrain at 480x270 (fx 225), 500
# features, 256 candidates, 16 keyframes of capacity; the map initialized on
# frames 0 and 8 at their true poses (`initialize_at_true_poses`: no NMI latch,
# the CPU's rasterizer is too slow for 125-candidate sweeps), then frames 9 and
# 10 tracked, frame 10 a keyframe.
MAP_SCENE = dict(height=270, width=480, n_grid=60, fx=225.0, n_features=500, n_cand=256,
                 max_keyframes=16, last=10, keyframe_every=2)


def mapping_scene(device="cpu"):
    """`entry.mapping_entry` on the reduced scene, not yet initialized (its
    mapping worker started: call `shutdown()`)."""
    from orbslam2_nmi_torch.entry import mapping_entry
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh

    s = MAP_SCENE
    world = SyntheticMeshWorld(mesh=terrain_mesh(seed=0, n=s["n_grid"]), fx=s["fx"])
    return mapping_entry(device=device, height=s["height"], width=s["width"], last=s["last"],
                         keyframe_every=s["keyframe_every"], world=world,
                         n_features=s["n_features"], n_cand=s["n_cand"],
                         max_keyframes=s["max_keyframes"])


def initialize_at_true_poses(session):
    """`nmi_initialize` on the session's frames 0 and 8 at their true poses
    without a localizer (the JAX tracker's path without one), then tracking
    starts as after `session.initialize()`. Returns the InitResult."""
    from orbslam2_nmi_torch.entry import INIT_FRAMES
    from orbslam2_nmi_torch.slam.initialization import nmi_initialize

    f1, f2 = (session.features(i) for i in INIT_FRAMES)
    f1.Tcw, f2.Tcw = (session.true_pose(i) for i in INIT_FRAMES)
    res = nmi_initialize(session.cfg, session.map, session.local_mapper, f1, f2)
    session.start(res, f1, f2)
    return res


def jax_system_config(cfg):
    """The JAX package's SystemConfig equal to the port's `cfg`."""
    import dataclasses

    from orbslam2_nmi_tpu import config as jconfig

    d = dataclasses.asdict(cfg)
    grid = jconfig.NMIGridConfig(**{k: tuple(v) for k, v in d["nmi"]["grid"].items()})
    return jconfig.SystemConfig(
        camera=jconfig.CameraConfig(**d["camera"]), orb=jconfig.ORBConfig(**d["orb"]),
        nmi=jconfig.NMIConfig(**{**d["nmi"], "grid": grid}),
        tracking=jconfig.TrackingConfig(**d["tracking"]))


# tests/test_loop_closing.py's looped map: a chain of 14 keyframes (320x240,
# 120 features, fx 300) whose last keyframe revisits the first with a drifted
# pose and its own drifted duplicate landmarks.
LOOP_N_FEAT = 120
LOOP_N_CHAIN = 14


def looped_map_state():
    """The JAX package's MapStore of tests/test_loop_closing.py:32-97, built
    from the same draws, with its config, the ground-truth and drifted
    poses: (jax cfg, jax map, gt, est). `convert.map_store_from_fields` gives
    the port's copy."""
    import jax.numpy as jnp

    from orbslam2_nmi_tpu.config import CameraConfig, ORBConfig, SystemConfig, TrackingConfig
    from orbslam2_nmi_tpu.geometry import se3
    from orbslam2_nmi_tpu.slam.map_store import MapStore

    N_FEAT, N_CHAIN = LOOP_N_FEAT, LOOP_N_CHAIN

    def project_cam(pc):
        return (pc[:, :2] / pc[:, 2:3] * [300.0, 300.0] + [160.0, 120.0]).astype(np.float32)

    rng = np.random.default_rng(0)
    cfg = SystemConfig(
        camera=CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240),
        orb=ORBConfig(n_features=N_FEAT, n_levels=4),
        tracking=TrackingConfig(max_keyframes=32, max_map_points=8192, max_features=N_FEAT),
    )
    m = MapStore(cfg)
    pc_scene = np.stack([rng.uniform(-3, 3, N_FEAT), rng.uniform(-2, 2, N_FEAT),
                         rng.uniform(6, 12, N_FEAT)], -1).astype(np.float32)
    uv_scene = project_cam(pc_scene)
    descs0 = rng.integers(0, 2**32, (N_FEAT, 8), dtype=np.uint32)
    gt = []
    for i in range(N_CHAIN):
        if i == 0 or i == N_CHAIN - 1:
            gt.append(np.eye(4, dtype=np.float32))
        else:
            s = i / (N_CHAIN - 1) * 2 * np.pi
            gt.append(np.asarray(se3.se3_exp(jnp.asarray(
                [1.5 * np.sin(s), 0.0, 1.5 * (1 - np.cos(s)), 0, 0, 0], jnp.float32))))
    est = [gt[0]]
    bias = np.asarray(se3.se3_exp(jnp.asarray([0.03, 0.015, 0.0, 0.0, 0.004, 0.0], jnp.float32)))
    for i in range(1, N_CHAIN):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        est.append((bias @ rel @ est[i - 1]).astype(np.float32))
    prev_point_ids = None
    for i in range(N_CHAIN):
        descs = descs0 if (i == 0 or i == N_CHAIN - 1) else rng.integers(
            0, 2**32, (N_FEAT, 8), dtype=np.uint32)
        k = m.add_keyframe(est[i], i, float(i), uv_scene, np.zeros(N_FEAT, np.int32),
                           np.zeros(N_FEAT, np.float32), descs, np.ones(N_FEAT, bool))
        Ti = np.linalg.inv(est[i])
        pw = (pc_scene @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        ids = []
        for f in range(90):
            p = m.add_map_point(pw[f], descs[f], k, np.zeros(3, np.float32))
            m.add_observation(k, f, p)
            ids.append(p)
        if prev_point_ids is not None and k > 0:
            for j in range(30):
                m.add_observation(k - 1, 90 + j, ids[j])
        prev_point_ids = ids
    return cfg, m, gt, est


def map_fields(m):
    """The fields `convert.map_store_from_fields` takes, copied from any map
    store (either package's)."""
    from orbslam2_nmi_torch.slam.checkpoint import _MAP_FIELDS

    out = {f: getattr(m, f).copy() for f in _MAP_FIELDS}
    out.update(n_keyframes=m.n_keyframes, n_points=m.n_points)
    return out


class JaxDraws:
    """The JAX package's RANSAC draws, for a port solver's `samples` argument:
    each call splits the key as the JAX package's caller does, then draws
    each hypothesis's rows with `jax.random.choice(..., replace=False,
    p=valid/sum)` under a vmap, as inside `sim3_ransac` / `_ransac_core`.
    Called as the loop closer's `draw_samples(n_rows, n_valid, n_hyp, size)`."""

    def __init__(self, seed):
        import jax

        self.key = jax.random.PRNGKey(seed)

    @staticmethod
    def draws(key, n_rows, n_valid, n_hypotheses, size):
        import jax
        import jax.numpy as jnp

        probs = (jnp.arange(n_rows) < n_valid).astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        keys = jax.random.split(key, n_hypotheses)
        return np.asarray(jax.vmap(lambda k: jax.random.choice(
            k, n_rows, shape=(size,), replace=False, p=probs))(keys)).astype(np.int64)

    def __call__(self, n_rows, n_valid, n_hypotheses, size):
        import jax

        self.key, sub = jax.random.split(self.key)
        return self.draws(sub, n_rows, n_valid, n_hypotheses, size)

    def two_view(self, n_rows, n_valid, n_hypotheses):
        """The two-view init's H and F rows (`Tracker.draw_two_view`): one
        split, then each hypothesis's 4 and 8 rows from the same key, as
        `two_view_init.initialize_two_view` draws them."""
        import jax

        self.key, sub = jax.random.split(self.key)
        return (self.draws(sub, n_rows, n_valid, n_hypotheses, 4),
                self.draws(sub, n_rows, n_valid, n_hypotheses, 8))


# The reduced loop scene: the reduced mapping scene tracked to frame 14 (key-
# frames at 10, 12 and 14, so the vocabulary trains), with place recognition
# wired (`entry.loop_entry`), and a revisit arc whose last frames revisit it.
LOOP_SCENE = dict(MAP_SCENE, last=14)
LOOP_ARC = (458, 464, 470, 476, 482, 488)  # the poses of frames -13.8 .. 16.2


def loop_scene(device="cpu"):
    """`entry.loop_entry` on the reduced loop scene, initialized at the true
    poses and tracked to frame 14 with the worker drained (call
    `shutdown()`)."""
    from orbslam2_nmi_torch.entry import loop_entry
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh

    s = LOOP_SCENE
    world = SyntheticMeshWorld(mesh=terrain_mesh(seed=0, n=s["n_grid"]), fx=s["fx"])
    session = loop_entry(device=device, height=s["height"], width=s["width"], last=s["last"],
                         keyframe_every=s["keyframe_every"], world=world,
                         n_features=s["n_features"], n_cand=s["n_cand"],
                         max_keyframes=s["max_keyframes"])
    initialize_at_true_poses(session)
    for i in session.track_ids:
        session.track_frame(i)
    session.flush()
    return session


# tests/test_slam_e2e.py's scene: the seed-3 point world at 320x240, 25 frames,
# 400 features on 4 levels, NMI offset 4, keyframes every 10 frames at most.
E2E = dict(width=320, height=240, n_frames=25, seed=3)


def e2e_config():
    """The port's SystemConfig of tests/test_slam_e2e.py:make_system (no NMI)."""
    from orbslam2_nmi_torch.config import (CameraConfig, NMIConfig, ORBConfig, SystemConfig,
                                           TrackingConfig)
    from orbslam2_nmi_torch.io.synthetic import SyntheticWorld

    K = SyntheticWorld(points=None, gray=None).camera_K(E2E["width"], E2E["height"])
    return SystemConfig(
        camera=CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                            cy=float(K[1, 2]), width=E2E["width"], height=E2E["height"],
                            fps=10.0),
        orb=ORBConfig(n_features=400, n_levels=4),
        nmi=NMIConfig(offset=4, threshold=0.3),
        tracking=TrackingConfig(max_frames=10, max_keyframes=64, max_map_points=8192,
                                max_features=512))


def e2e_frames():
    """(port world, the 25 frames as uint8 numpy, the true poses)."""
    from orbslam2_nmi_torch.io.synthetic import SyntheticWorld

    world = SyntheticWorld.generate(seed=E2E["seed"])
    n, w, h = E2E["n_frames"], E2E["width"], E2E["height"]
    return (world, [world.render_frame(i, n, w, h, device="cpu") for i in range(n)],
            [world.pose_at(i, n) for i in range(n)])


def jax_e2e_run(frames, snapshot_after=None, output_dir=None):
    """The JAX package's synchronous SLAMSystem (no NMI) over `frames` from
    the true init poses of frames 0 and 4 (tests/test_slam_e2e.py). With
    `snapshot_after` i, also returns the map's fields and a copy of the
    tracker's state right after frame i. Returns (system, results,
    snapshot)."""
    import copy
    import tempfile

    from orbslam2_nmi_tpu.io.synthetic import SyntheticWorld as JWorld
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem

    world = JWorld.generate(seed=E2E["seed"])
    sysm = JSystem(jax_system_config(e2e_config()), use_nmi=False,
                   output_dir=output_dir or tempfile.mkdtemp())
    n = E2E["n_frames"]
    sysm.set_init_poses(world.pose_at(0, n), world.pose_at(4, n))
    results, snap = [], None
    for i, img in enumerate(frames):
        results.append(sysm.track_monocular(img, i / 10.0))
        if i == snapshot_after:
            tr = sysm.tracker
            snap = dict(fields=map_fields(sysm.map), tracker={
                k: copy.deepcopy(getattr(tr, k)) for k in TRACKER_STATE})
    return sysm, results, snap


TRACKER_STATE = ("state", "velocity", "last_frame", "init_frame", "ref_kf", "last_kf_frame_id",
                 "kfs_since_last_nmi", "dist_since_nmi", "rot_since_nmi", "trajectory",
                 "nmi_fail_streak", "nmi_due_skips", "n_resets", "only_tracking", "vo_mode",
                 "_last_good_Tcw")


def port_frame(f):
    """The port's FrameData with a copy of any FrameData's fields."""
    import copy
    import dataclasses

    from orbslam2_nmi_torch.slam.frame import FrameData

    if f is None:
        return None
    return FrameData(**{x.name: copy.deepcopy(getattr(f, x.name))
                        for x in dataclasses.fields(FrameData)})


def set_tracker_state(tr, state: dict):
    """Give a tracker of either package the snapshot `state` (copies; the
    state enum by name, frames as the tracker's own package's FrameData)."""
    import copy

    for k, v in state.items():
        if k == "state":
            v = type(tr.state)[v.name]
        elif k in ("last_frame", "init_frame"):
            v = port_frame(v) if type(tr).__module__.startswith("orbslam2_nmi_torch") \
                else copy.deepcopy(v)
        else:
            v = copy.deepcopy(v)
        setattr(tr, k, v)


def jax_map_from_fields(fields, jcfg):
    """The JAX package's MapStore holding `fields` (`map_fields`' dict)."""
    from orbslam2_nmi_tpu.slam.checkpoint import _MAP_FIELDS
    from orbslam2_nmi_tpu.slam.map_store import MapStore

    m = MapStore(jcfg)
    for f in _MAP_FIELDS:
        getattr(m, f)[...] = fields[f]
    m.n_keyframes, m.n_points = fields["n_keyframes"], fields["n_points"]
    return m


# ------------------------------------------------------------ worlds of ranks


def run_ranks(fn, n_ranks, *args, device="cpu", backend=None):
    """`fn(*args)` on every rank of a fresh world of `n_ranks` spawned
    processes (gloo on the CPU by default), every rank's result returned
    (tensors as numpy). `fn` must live in an importable module, such as this
    one: the ranks start from a fresh interpreter."""
    from orbslam2_nmi_torch.parallel import distributed

    return distributed.spawn_world(fn, n_ranks, *args, backend=backend, device=device)


def sharding_height_field():
    """tests/test_sharding.py's 30 x 30 height field (vertices, uvs, faces,
    texture)."""
    rng = np.random.default_rng(5)
    n = 30
    xs, ys = np.linspace(-15, 15, n), np.linspace(-10, 10, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = 12.0 + 1.0 * np.sin(X * 0.7) * np.cos(Y * 0.9)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() - xs[0]) / 30.0, (Y.ravel() - ys[0]) / 20.0], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n + 1], -1),
                            np.stack([a, a + n + 1, a + n], -1)]).astype(np.int32)
    return verts, uvs, faces, rng.uniform(10, 245, (64, 64)).astype(np.float32)


def sharding_mesh_problem():
    """test_sharding.py's mesh NMI problem as numpy inputs of `sharding_rank`:
    48x128, 8 renders x 4 warps, the frame rendered at I by the port."""
    from orbslam2_nmi_torch.ops import homography, render

    mesh = sharding_height_field()
    K = np.array([[60.0, 0, 64], [0, 60.0, 24], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    b = raster.bin_mesh(MeshModel(*mesh), eye, K, 48, 128, 1.0, 30.0,
                        max_offset=(0.3, 0.3, 0.3), device="cpu")
    frame = raster.render_mesh_grid(b, torch.eye(4), K, torch.zeros(1, 3), 1.0, 30.0)[0]
    return dict(mesh=mesh, frame=frame.numpy(), Tcw=eye, K=K, hw=(48, 128),
                near_far=(1.0, 30.0), max_offset=(0.3, 0.3, 0.3),
                offsets=render.translation_grid_offsets((2, 2, 2), (0.3,) * 3, "cpu").numpy(),
                angles=homography.rotation_grid_angles((2, 2, 1), (0.03,) * 3, "cpu").numpy())


def sharding_rank(problems: dict) -> dict:
    """One rank of the sharding tests: each of `problems` (numpy inputs, see
    tests/test_torch_sharding.py) through its sharded function on this
    rank's device; the outputs, and this rank's kernel launches."""
    from orbslam2_nmi_torch import convert, kernels
    from orbslam2_nmi_torch.parallel import distributed, mesh as mesh_lib
    from orbslam2_nmi_torch.parallel import sharded_ba, sharded_nmi, sharded_pose_graph
    from orbslam2_nmi_torch.solvers import pose_graph

    dev = distributed.local_device()
    mesh = mesh_lib.make_mesh()
    kernels.reset_launches()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}
    for name, p in problems.items():
        if name.startswith("pose_graph"):
            prob = pose_graph.PoseGraphProblem(*(t(p[k]) for k in pose_graph.PoseGraphProblem._fields))
            out[name] = sharded_pose_graph.sharded_optimize_pose_graph(mesh, prob, iters=p["iters"])
        elif name.startswith("ba"):
            prob = convert.ba_problem_from_numpy(p["fields"], dev)
            out[name] = tuple(sharded_ba.sharded_bundle_adjust(mesh, prob))
        elif name.startswith("nmi_splat"):
            model = convert.render_model_from_numpy(p["points"], p["gray"], dev)
            out[name] = sharded_nmi.sharded_nmi_search(
                mesh, model, t(p["frame"]), t(p["Tcw"]), t(p["offsets"]), p["angles"], p["K"],
                *p["hw"], *p["near_far"])
        elif name.startswith("nmi_mesh"):
            binned = raster.bin_mesh(MeshModel(*p["mesh"]), p["Tcw"], p["K"], *p["hw"],
                                     *p["near_far"], max_offset=p["max_offset"], device=dev)
            out[name] = sharded_nmi.sharded_nmi_search_mesh(
                mesh, binned, t(p["frame"]), t(p["Tcw"]), t(p["offsets"]), p["angles"], p["K"],
                *p["near_far"])
        else:
            raise ValueError(f"unknown problem {name}")
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def warp_plan_calls_rank(p: dict, n_searches: int) -> int:
    """One rank: `n_searches` mesh NMI searches of `p`
    (`sharding_mesh_problem`), and how often they called
    `homography.warp_plan`."""
    from orbslam2_nmi_torch.ops import homography
    from orbslam2_nmi_torch.parallel import distributed, mesh as mesh_lib, sharded_nmi

    dev = distributed.local_device()
    mesh = mesh_lib.make_mesh()
    binned = raster.bin_mesh(MeshModel(*p["mesh"]), p["Tcw"], p["K"], *p["hw"], *p["near_far"],
                             max_offset=p["max_offset"], device=dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    calls, build = [], homography.warp_plan
    homography.warp_plan = lambda *a: calls.append(a) or build(*a)
    try:
        for _ in range(n_searches):
            sharded_nmi.sharded_nmi_search_mesh(mesh, binned, t(p["frame"]), t(p["Tcw"]),
                                                t(p["offsets"]), p["angles"], p["K"],
                                                *p["near_far"])
    finally:
        homography.warp_plan = build
    return len(calls)


def rank_that_fails(bad_rank: int) -> int:
    """Raises on rank `bad_rank`; every other rank waits in a barrier that
    the failed rank never reaches."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def mesh_2d_rank() -> dict:
    """A (pose, obs) mesh over a world of 4: this rank's coordinates and the
    sum of the world ranks along each axis."""
    import torch.distributed as dist

    from orbslam2_nmi_torch.parallel import mesh as mesh_lib

    m = mesh_lib.make_mesh_2d(2, 2)
    out = {"coords": (m.get_local_rank(mesh_lib.POSE_AXIS), m.get_local_rank(mesh_lib.OBS_AXIS))}
    for axis in m.axis_names:
        x = torch.tensor([float(dist.get_rank())], device=m.device)
        dist.all_reduce(x, group=m.get_group(axis))
        out[axis] = float(x[0])
        out[axis + "_gathered"] = mesh_lib.all_gather_cat(
            torch.tensor([dist.get_rank()], device=m.device), m, axis).tolist()
    return out
