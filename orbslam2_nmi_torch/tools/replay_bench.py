"""Long-sequence full-pipeline replay: the end-to-end fps and ATE harness.

Port of `orbslam2_nmi_tpu/tools/replay_bench.py`, the analogue of the
reference's dataset replay evaluation (Examples/Monocular/mono_ETH.cc:92-151):
a 520-frame 960x540 sequence is rendered from a textured terrain mesh along
a closed circuit (a revisit loop) by the port's own rasterizer (kernel B3 and
the sampler, `SyntheticMeshWorld.render_frames`), then replayed through the
whole system: ORB tracking, local mapping, place recognition, loop closing
and NMI relocalization against the mesh that made the imagery. It reports

  * frames/s over the frames after the warm-up (wall clock, from the
    completion time of each frame in `PipelinedFrontend`, or around each
    `track_monocular` call on the classic path: host orchestration, mapping,
    loop closing and NMI included);
  * ATE-RMSE of the recomposed trajectory (SaveFullTrajectory semantics)
    against exact ground truth, unaligned when NMI anchors the map to the
    world frame.

    python3 -m orbslam2_nmi_torch.tools.replay_bench --pipelined [--domain-gap]
        [--frames N --total M] [--device cuda|cpu]

Sequences are cached as .npy files under $ORBSLAM2_NMI_TORCH_SEQ_CACHE
(default: `orbslam2_nmi_torch_seq` in the temporary directory), keyed by
everything that makes them. The cache is the port's own: the JAX package's
frames come from its rasterizer, whose UV decode differs from this one's by
one quantum on a few pixels, so they are never read here.

Where it differs from the JAX tool: `generate_sequence` returns the frames
as a uint8 tensor on the device; every function takes a `device` (default
"cuda") and raises when CUDA is asked for and absent; `run_replay` raises on
a worker's error after draining both workers; there is no persistent compile
cache to enable (the kernels are built once into `build/kernels/`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from orbslam2_nmi_torch import kernels

# bump when world generation or the renderer's numerics change: the NMI
# localizer scores live renders against this imagery, so both must come from
# the same rasterizer
SEQ_VERSION = 1
WARMUP = 24  # frames left out of the fps numbers: the first kernel builds, the graph capture


def cache_dir() -> str:
    d = os.environ.get("ORBSLAM2_NMI_TORCH_SEQ_CACHE",
                       os.path.join(tempfile.gettempdir(), "orbslam2_nmi_torch_seq"))
    os.makedirs(d, exist_ok=True)
    return d


def sequence_cache_path(n_frames: int, width: int, height: int, seed: int,
                        n_total: int | None = None, domain_gap: bool = False) -> str:
    tot = f"of{n_total}_" if n_total and n_total != n_frames else ""
    dg = "dg_" if domain_gap else ""
    return os.path.join(cache_dir(),
                        f"seq_v{SEQ_VERSION}_{seed}_{dg}{tot}{n_frames}x{width}x{height}.npy")


def generate_sequence(n_frames: int = 520, width: int = 960, height: int = 540, seed: int = 1,
                      cache: bool = True, n_total: int | None = None, domain_gap: bool = False,
                      circuit: str = "standard", device="cuda"):
    """(world, frames): the world and its frames, uint8 [N, H, W] on `device`.

    `n_total` renders a prefix of an n_total-frame circuit (the same motion a
    frame as the whole sequence): pass it on to `run_replay(n_total=...)`.
    `domain_gap=True` renders the camera imagery from a sun-shaded copy of
    the terrain (`lit_mesh`) and degrades it in screen space (exposure
    drift, vignette, gamma, sensor noise: `apply_photometric_gap`), while
    the returned `world` keeps the flat texture the NMI prior localizes
    against. `circuit="wide"` is the loop-closure circuit (`generate_wide`).
    """
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld

    device = kernels.resolve_device(device, "generate_sequence()")
    n_total = n_total or n_frames
    world = (SyntheticMeshWorld.generate_wide(seed=seed) if circuit == "wide"
             else SyntheticMeshWorld.generate(seed=seed))
    path = sequence_cache_path(n_frames, width, height, seed + (1000 if circuit == "wide" else 0),
                               n_total, domain_gap)
    if cache and os.path.exists(path):
        frames = np.load(path)
        if frames.shape == (n_frames, height, width):
            return world, torch.from_numpy(frames).to(device)
    frames = render_sequence(world, n_frames, width, height, n_total, domain_gap, seed, device)
    if cache:
        tmp = path[: -len(".npy")] + f".tmp{os.getpid()}.npy"
        np.save(tmp, frames.cpu().numpy())
        os.replace(tmp, path)
    return world, frames


def render_sequence(world, n_frames: int, width: int, height: int, n_total: int,
                    domain_gap: bool = False, seed: int = 1, device="cuda") -> torch.Tensor:
    """`generate_sequence`'s frames of `world`, uint8 [N, H, W] on `device`,
    never cached: the first `n_frames` of its `n_total`-frame circuit, with
    the domain gap (the lit mesh, then `apply_photometric_gap` seeded with
    `seed`) if asked."""
    from orbslam2_nmi_torch.io.synthetic import apply_photometric_gap

    render_world = dataclasses.replace(world, mesh=world.lit_mesh()) if domain_gap else world
    frames = render_world.render_frames(list(range(n_frames)), n_total, width, height,
                                        device=device)
    if domain_gap:
        frames = torch.from_numpy(apply_photometric_gap(frames.cpu().numpy(), seed=seed)).to(
            device)
    return frames


def build_system(world, width: int, height: int, n_features: int = 2000, n_levels: int = 8,
                 use_nmi: bool = True, async_mapping: bool = True, max_keyframes: int = 512,
                 output_dir=None, async_nmi: bool | None = None, threshold: float = 0.45,
                 vocabulary_path: str = "", max_frames: int = 30, device="cuda"):
    """The replay's `SLAMSystem`: `entry.mapping_config` (the JAX package's
    full-circuit configuration) with these parameters, the localizer on the
    world's own mesh, and async NMI following async mapping unless set.

    The accept threshold is per dataset in the reference (0.1 on ZU-MAV,
    0.09 on Newer College, real imagery where a good latch scores 0.1-0.2).
    The synthetic world is rendered by the localizer's own rasterizer: a
    correct pose scores ~0.9 and a few-pixel misalignment still ~0.33, so the
    same-renderer gate is 0.45; the domain-gap imagery takes the reference's
    0.1."""
    from orbslam2_nmi_torch.entry import mapping_config
    from orbslam2_nmi_torch.slam.system import SLAMSystem

    cfg = mapping_config(world, height, width, n_features=n_features,
                         max_keyframes=max_keyframes, n_levels=n_levels, threshold=threshold,
                         max_frames=max_frames, vocabulary_path=vocabulary_path)
    return SLAMSystem(cfg, use_nmi=use_nmi, nmi_mesh=world.mesh if use_nmi else None,
                      output_dir=output_dir or tempfile.mkdtemp(prefix="replay_bench_"),
                      async_mapping=async_mapping,
                      async_nmi=async_mapping if async_nmi is None else async_nmi,
                      device=device)


def drain(system, timeout: float = 600.0) -> None:
    """Wait for both workers; raise the first error either reported."""
    for w in (system.nmi_worker, system.pipeline):
        if w is not None:
            w.flush(timeout=timeout)
    errs = system.errors()
    if errs:
        raise RuntimeError(f"a worker failed:\n{errs[0]}")


def count_anchors(m) -> int:
    return int(np.sum(m.kf_nmi_reloc[m.valid_keyframe_indices()]))


def run_replay(world, frames, use_nmi: bool = True, async_mapping: bool = True,
               n_features: int = 2000, n_levels: int = 8, warmup: int = WARMUP,
               output_dir=None, n_total: int | None = None, pipelined: bool = False,
               pipeline_lag: int = 1, threshold: float = 0.45, async_nmi: bool | None = None,
               vocabulary_path: str = "", max_frames: int = 30, device="cuda",
               after=None) -> dict:
    """Track every frame through the whole system; return fps and ATE.

    `warmup` frames are left out of the fps numbers: they pay the kernels'
    first build and the tracking step's CUDA-graph capture. The ATE is taken
    over every tracked frame of the recomposed trajectory (SaveFullTrajectory
    semantics, System.cc:514-599), so loop, BA and NMI corrections count,
    with no alignment when NMI anchors the map to the world frame. `n_total`
    is the trajectory's cadence (the N the sequence was generated with): pass
    it when replaying a prefix of a longer sequence. `after`, if given, is
    called with the system once its workers have drained, before its
    shutdown (to draw its map, say).
    """
    from orbslam2_nmi_torch.io.trajectory import ate_rmse, recompose_trajectory
    from orbslam2_nmi_torch.slam.tracking import TrackingState

    n_frames, height, width = frames.shape
    n_total = n_total or n_frames
    sys_ = build_system(
        world, width, height, n_features=n_features, n_levels=n_levels, use_nmi=use_nmi,
        async_mapping=async_mapping, output_dir=output_dir, threshold=threshold,
        async_nmi=async_nmi, vocabulary_path=vocabulary_path, max_frames=max_frames,
        device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_total),
                            world.pose_at(sys_.cfg.nmi.offset, n_total))
        ts = np.arange(n_frames) / 30.0
        if pipelined:
            # the replayed step and the lag-1 front-end: the completion time of
            # each frame (a re-tracked frame keeps its last), as the reference
            # times every TrackMonocular call (mono_ETH.cc:107-116)
            from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend

            fe = PipelinedFrontend(sys_, lag=pipeline_lag)
            t0 = time.perf_counter()
            results = (fe.run(frames[:warmup], ts[:warmup], start_id=0)
                       + fe.run(frames[warmup:], ts[warmup:], start_id=warmup))
            walls = [fe.completion_walls[fid] for fid in sorted(fe.completion_walls)]
            t_frames = list(np.diff(np.asarray([t0] + walls)))
            n_ok = sum(1 for r in results
                       if r is not None and r.state == TrackingState.OK and r.Tcw is not None)
        else:
            n_ok, t_frames = 0, []
            for i in range(n_frames):
                t0 = time.perf_counter()
                res = sys_.track_monocular(frames[i], float(ts[i]))
                t_frames.append(time.perf_counter() - t0)
                if res.state == TrackingState.OK and res.Tcw is not None:
                    n_ok += 1
        drain(sys_)
        if after is not None:
            after(sys_)

        with sys_.map.lock:
            rows = recompose_trajectory(sys_.tracker.trajectory, sys_.map)
            n_keyframes = int(sys_.map.n_keyframes)
            n_points = int(len(sys_.map.valid_point_indices()))
            n_anchors = count_anchors(sys_.map)
        est = [r[2] for r in rows]
        gt = [world.pose_at(r[0], n_total) for r in rows]
        ate = ate_rmse(est, gt, align=not use_nmi) if est else float("inf")
        t_arr = np.asarray(t_frames[warmup:])
        wall = float(t_arr.sum())
        return {
            "n_frames": n_frames,
            "n_tracked": n_ok,
            "n_keyframes": n_keyframes,
            "n_map_points": n_points,
            "fps_steady": len(t_arr) / wall if wall > 0 else 0.0,
            "fps_median": 1.0 / float(np.median(t_arr)),
            "frame_ms_p50": float(np.median(t_arr)) * 1e3,
            "frame_ms_p95": float(np.quantile(t_arr, 0.95)) * 1e3,
            "frame_ms_max": float(t_arr.max()) * 1e3,
            "ate_rmse": ate,
            "n_loop_closures": (len(sys_.loop_closer.loop_edges)
                                if sys_.loop_closer is not None else 0),
            "n_nmi_anchors": n_anchors,
        }
    finally:
        sys_.shutdown()


def run_kidnap(world, frames, n_total: int, vocabulary_path: str = "", build_n: int = 160,
               jump_to: int = 48, use_nmi: bool = True, device="cuda") -> dict:
    """Kidnap recovery: build a map over frames [0, build_n), then teleport the
    camera back to `jump_to` (fresh frame ids, a broken motion model).
    Tracking must go LOST and recover by BoW and EPnP relocalization against
    the keyframe database's inverted file (Tracking::Relocalization,
    Tracking.cc:1596; KeyFrameDatabase::DetectRelocalizationCandidates,
    KeyFrameDatabase.cc:202). With `vocabulary_path` the candidates come from
    a pre-trained vocabulary loaded at the start (the System.cc:87 flow)
    instead of the small tree trained from the first keyframes."""
    from orbslam2_nmi_torch.slam.tracking import TrackingState

    n_frames, height, width = frames.shape
    sys_ = build_system(world, width, height, use_nmi=use_nmi, async_mapping=False,
                        vocabulary_path=vocabulary_path, device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_total),
                            world.pose_at(sys_.cfg.nmi.offset, n_total))
        for i in range(build_n):
            sys_.track_monocular(frames[i], i / 30.0)
        n_kf = int(sys_.map.n_keyframes)

        # the kidnap: resume from a much earlier place on the circuit
        lost_seen, recovered_at, err_m = False, -1, float("inf")
        for j in range(24):
            fid = build_n + j
            res = sys_.track_monocular(frames[jump_to + j], fid / 30.0, frame_id=fid)
            if sys_.tracker.state == TrackingState.LOST:
                lost_seen = True
            if lost_seen and res.state == TrackingState.OK and res.Tcw is not None:
                recovered_at = j
                gt = world.pose_at(jump_to + j, n_total)
                c_est = -res.Tcw[:3, :3].T @ res.Tcw[:3, 3]
                c_gt = -gt[:3, :3].T @ gt[:3, 3]
                err_m = float(np.linalg.norm(c_est - c_gt))
                break
        return {
            "vocabulary_words": sys_.vocabulary.n_words if sys_.vocabulary is not None else 0,
            "n_keyframes": n_kf,
            "lost_seen": lost_seen,
            "recovered_after_frames": recovered_at,
            "recovery_err_m": err_m if np.isfinite(err_m) else None,
        }
    finally:
        sys_.shutdown()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=520)
    p.add_argument("--total", type=int, default=None,
                   help="circuit length; --frames renders a prefix of it")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--features", type=int, default=2000)
    p.add_argument("--levels", type=int, default=8)
    p.add_argument("--no-nmi", action="store_true")
    p.add_argument("--sync", action="store_true", help="synchronous mapping")
    p.add_argument("--pipelined", action="store_true",
                   help="the replayed tracking step behind the lag-1 front-end")
    p.add_argument("--domain-gap", action="store_true",
                   help="camera imagery photometrically apart from the NMI prior (lit mesh, "
                        "exposure, vignette, noise); the reference's accept threshold 0.1")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    world, frames = generate_sequence(args.frames, args.width, args.height, n_total=args.total,
                                      domain_gap=args.domain_gap, device=args.device)
    out = run_replay(
        world, frames, use_nmi=not args.no_nmi, async_mapping=not args.sync,
        n_features=args.features, n_levels=args.levels, n_total=args.total or args.frames,
        pipelined=args.pipelined,
        # ETH_small.yaml:75 NMI.Treshold=0.1, once the imagery no longer
        # matches the prior photometrically
        threshold=0.1 if args.domain_gap else 0.45, device=args.device,
    )
    out["domain_gap"] = args.domain_gap
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
