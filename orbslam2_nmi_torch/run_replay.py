"""Sequence replay CLI — the mono_ETH / mono_newer_college equivalent.

Port of `orbslam2_nmi_tpu/run_replay.py`. Reference:
Examples/Monocular/mono_ETH.cc:44-162 — loads a settings YAML and an image
sequence, tracks every frame, optionally paced to the camera's fps, saves
the trajectories every 100 frames and at exit, and prints the median and
mean tracking time (mono_ETH.cc:142-151).

Usage:
  python -m orbslam2_nmi_torch.run_replay --settings ETH_small.yaml --sequence DIR
  python -m orbslam2_nmi_torch.run_replay --synthetic 30 --output OUT
  python -m orbslam2_nmi_torch.run_replay --synthetic 25 --device cpu

It runs on CUDA unless `--device cpu`. `--profile DIR` records a
`torch.profiler` trace (Chrome JSON) of the replay into DIR.
`--debug-images` saves the NMI localizer's best and middle overlays of every
grid evaluation into OUTPUT/nmi_debug/ (the reference's orb_prop_log
imagery, Tracking.cc:1911-1948); `--viz N` draws the tracked keypoints of
every Nth frame (OUTPUT/frame_<id>.png) and a top-down map with the
trajectory at exit (OUTPUT/map_topdown.png), the headless stand-in for the
reference's Viewer (System.cc:126). Images are PNG files where PIL is
installed, else `.npy` arrays (`viz/replay.py`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="orbslam2_nmi_torch monocular replay")
    ap.add_argument("--settings", help="reference-format settings YAML")
    ap.add_argument("--sequence", help="image sequence dir (ZU-MAV/NewerCollege layout)")
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames instead")
    ap.add_argument("--output", default="results", help="output directory")
    ap.add_argument("--no-nmi", action="store_true", help="disable NMI localization")
    ap.add_argument("--start-frame", type=int, default=0)
    ap.add_argument("--start-index", type=int, default=1,
                    help="first image number of a ZU-MAV part: 1=pt1, 20513=pt2, "
                         "52500=pt3, 68700=pt4 (mono_ETH.cc:196-199)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--realtime", action="store_true", help="pace to camera fps")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the system runs (default: cuda)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local mapping + loop closing in a background worker (the "
                         "reference's thread layout); default is the deterministic "
                         "synchronous interleave")
    ap.add_argument("--debug-images", action="store_true",
                    help="save NMI best/middle overlay images per grid evaluation (the "
                         "reference's orb_prop_log imagery, Tracking.cc:1911-1948)")
    ap.add_argument("--viz", type=int, default=0, metavar="N",
                    help="save a FrameDrawer overlay every N frames and a MapDrawer top-down "
                         "map at exit (headless Viewer equivalent, System.cc:126)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="record a torch.profiler trace of the replay into DIR")
    args = ap.parse_args(argv)

    import torch

    from orbslam2_nmi_torch.config import load_yaml_config
    from orbslam2_nmi_torch.io.trajectory import ate_rmse
    from orbslam2_nmi_torch.slam.system import SLAMSystem
    from orbslam2_nmi_torch.slam.tracking import TrackingState
    from orbslam2_nmi_torch.viz import replay as viz

    device = args.device
    if args.synthetic:
        from orbslam2_nmi_torch.config import (CameraConfig, NMIConfig, ORBConfig, SystemConfig,
                                               TrackingConfig)
        from orbslam2_nmi_torch.io.synthetic import SyntheticWorld

        n = args.synthetic
        world = SyntheticWorld.generate(seed=3)
        W, H = 320, 240
        K = world.camera_K(W, H)
        cfg = SystemConfig(
            camera=CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                cy=float(K[1, 2]), width=W, height=H, fps=10.0),
            orb=ORBConfig(n_features=400, n_levels=4),
            nmi=NMIConfig(offset=4, threshold=0.3, render_near=2.0, render_far=40.0,
                          max_iteration_count=2),
            tracking=TrackingConfig(max_frames=10, max_keyframes=128, max_map_points=16384,
                                    max_features=512),
        )
        use_nmi = not args.no_nmi
        model = world.render_model(device) if use_nmi else None
        system = SLAMSystem(cfg, nmi_model=model, use_nmi=use_nmi, output_dir=args.output,
                            verbose=args.verbose, async_mapping=args.async_mapping,
                            device=device)
        system.set_init_poses(world.pose_at(0, n), world.pose_at(cfg.nmi.offset, n))
        frames = ((i, i / cfg.camera.fps, world.render_frame(i, n, W, H, device=device))
                  for i in range(n))
        gt = [world.pose_at(i, n) for i in range(n)]
    else:
        if not args.settings or not args.sequence:
            ap.error("--settings and --sequence required (or use --synthetic N)")
        from orbslam2_nmi_torch.io.datasets import load_eth_sequence, load_newer_college_sequence

        cfg = load_yaml_config(args.settings)
        base = args.sequence.rstrip("/")
        if os.path.exists(os.path.join(base, "_times.txt")) or os.path.exists(base + "_times.txt"):
            seq = load_eth_sequence(args.sequence, start_frame=args.start_frame,
                                    start_index=args.start_index)
        else:
            seq = load_newer_college_sequence(args.sequence, start_frame=args.start_frame)
        system = SLAMSystem(cfg, use_nmi=not args.no_nmi, output_dir=args.output,
                            verbose=args.verbose, async_mapping=args.async_mapping,
                            device=device)
        frames = ((i, t, img) for i, t, img in seq.frames())
        gt = None

    if args.debug_images and system.localizer is not None:
        dbg = os.path.join(args.output, "nmi_debug")
        os.makedirs(dbg, exist_ok=True)
        system.localizer.debug_dir = dbg

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    n_ok = n_total = 0
    est, gt_used = [], []
    t_last = None
    for i, t, img in frames:
        if args.max_frames and n_total >= args.max_frames:
            break
        if args.realtime and t_last is not None:
            elapsed = system.frame_times[-1] if system.frame_times else 0.0
            if elapsed < t - t_last:
                time.sleep(t - t_last - elapsed)
        t_last = t
        res = system.track_monocular(img, t, frame_id=i)
        n_total += 1
        if args.viz and n_total % args.viz == 0:
            fr = system.tracker.last_frame
            if fr is not None:
                viz.draw_frame(np.asarray(img), fr.xy, fr.mp_idx >= 0,
                               os.path.join(args.output, f"frame_{i:06d}.png"))
        if res.state == TrackingState.OK and res.Tcw is not None:
            n_ok += 1
            if gt is not None:
                est.append(res.Tcw)
                gt_used.append(gt[i])
        if n_total % 100 == 0:
            system.save_full_trajectory("FullTrajectory")

    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "replay_trace.json"))

    system.save_full_trajectory("FullTrajectory")
    system.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    system.print_map_points("MapPoints.xyz")
    if args.viz:
        viz.plot_map_topdown(system.map, os.path.join(args.output, "map_topdown.png"),
                             trajectory=system.full_trajectory())
    system.shutdown()
    errors = system.errors()
    if errors:
        print(f"worker error:\n{errors[0]}", file=sys.stderr)
        return 1

    ft = np.array(system.frame_times) if system.frame_times else np.zeros(1)
    print(f"tracked {n_ok}/{n_total} frames, {system.map.n_keyframes} keyframes, "
          f"{len(system.map.valid_point_indices())} map points")
    print(f"median tracking time {np.median(ft) * 1e3:.1f} ms, mean {ft.mean() * 1e3:.1f} ms")
    if gt is not None and len(est) >= 3:
        print(f"ATE-RMSE vs ground truth: {ate_rmse(est, gt_used, align=False):.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
