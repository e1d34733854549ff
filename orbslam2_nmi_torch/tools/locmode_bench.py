"""Localization-only mode at scale: a frozen-map second pass over the circuit.

    python3 -m orbslam2_nmi_torch.tools.locmode_bench [--frames 520] [--pipelined-build]
        [--no-nmi] [--out PATH] [--device cuda|cpu]

Port of `orbslam2_nmi_tpu/tools/locmode_bench.py`. It builds a full map
over the 520-frame circuit (pass 1, full SLAM), then activates localization-
only mode (System::ActivateLocalizationMode, System.cc:298-303) and tracks
the whole sequence again against the frozen map (pass 2): no keyframes, no
mapping, no loop closing: the mbOnlyTracking branch of Track() with its mbVO
fallback (Tracking.cc:402-530, :1163-1165). Pass 2 starts with a teleport
back to frame 0 (a broken motion model), so it must first recover through
BoW and EPnP relocalization.

It reports pass 2's tracked fraction, its unaligned error against exact
ground truth (map-anchored frames and mbVO frames apart), the relocalization
and mbVO episodes, and whether the map stayed frozen, as one JSON object
(also written to --out, default `LOCMODE.json` in the working directory).
Beyond the JAX tool's keys: pass 1's loop closures and its keyframes'
camera-centre error against ground truth, and pass 2's relocalizations
(frame, keyframe, inliers, the frame's error, the keyframe's frame) and the
frames more than 1 m off, to tell a map built wrong from a pass that
localized wrong.
"""

from __future__ import annotations

import json

import numpy as np


def _center(T) -> np.ndarray:
    return -T[:3, :3].T @ T[:3, 3]


def run(n_frames: int = 520, use_nmi: bool = True, pipelined_build: bool = False,
        device="cuda") -> dict:
    from orbslam2_nmi_torch.slam.tracking import TrackingState
    from orbslam2_nmi_torch.tools.replay_bench import build_system, drain, generate_sequence

    world, frames = generate_sequence(n_frames, device=device)
    n_frames, height, width = frames.shape
    sys_ = build_system(world, width, height, use_nmi=use_nmi, device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_frames),
                            world.pose_at(sys_.cfg.nmi.offset, n_frames))
        ts = np.arange(n_frames) / 30.0

        # ---- pass 1: build the map
        if pipelined_build:
            from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend

            r1 = PipelinedFrontend(sys_).run(frames, ts, start_id=0)
        else:
            r1 = [sys_.track_monocular(frames[i], float(ts[i])) for i in range(n_frames)]
        drain(sys_)
        n_ok1 = sum(1 for r in r1 if r is not None and r.Tcw is not None
                    and r.state == TrackingState.OK)
        m = sys_.map
        vk = m.valid_keyframe_indices()
        kf_err = [float(np.linalg.norm(_center(m.kf_Tcw[k])
                                       - _center(world.pose_at(int(m.kf_frame_id[k]), n_frames))))
                  for k in vk if int(m.kf_frame_id[k]) < n_frames]
        n_loops = len(sys_.loop_closer.loop_edges) if sys_.loop_closer is not None else 0

        # ---- pass 2: the frozen map, the classic tracker (the reference's mode switch)
        sys_.activate_localization_mode()
        n_kf_before = int(sys_.map.n_keyframes)
        tr = sys_.tracker
        n_rel0 = len(tr.relocalizations)
        n_ok2 = vo_frames = vo_episodes = lost_frames = 0
        prev_vo = False
        errs, errs_vo, far, err_at = [], [], [], {}
        center = _center

        for i in range(n_frames):
            fid = n_frames + i
            res = sys_.track_monocular(frames[i], fid / 30.0, frame_id=fid)
            if res.state == TrackingState.OK and res.Tcw is not None:
                n_ok2 += 1
                err = float(np.linalg.norm(center(res.Tcw) - center(world.pose_at(i, n_frames))))
                # mbVO frames track on the motion model without map matches
                # (Tracking.cc:420-441): their error is unbounded by design
                # until relocalization re-anchors them, so they are apart
                (errs_vo if tr.vo_mode else errs).append(err)
                err_at[i] = err
                if err > 1.0:
                    far.append(i)
            else:
                lost_frames += 1
            if tr.vo_mode and not prev_vo:
                vo_episodes += 1
            if tr.vo_mode:
                vo_frames += 1
            prev_vo = tr.vo_mode

        def rmse(x):
            return float(np.sqrt(np.mean(np.square(x)))) if x else None

        return {
            "pass1_tracked": n_ok1,
            "pass1_keyframes": n_kf_before,
            "pass2_tracked": n_ok2,
            "pass2_tracked_frac": n_ok2 / n_frames,
            "pass2_lost_frames": lost_frames,
            "pass2_map_anchored_frames": len(errs),
            "pass2_err_rmse_m_map_anchored": rmse(errs),
            "pass2_err_max_m_map_anchored": max(errs) if errs else None,
            "pass2_err_rmse_m_vo_frames": rmse(errs_vo),
            "pass2_err_max_m_vo_frames": max(errs_vo) if errs_vo else None,
            "vo_mode_episodes": vo_episodes,
            "vo_mode_frames": vo_frames,
            "map_frozen": int(sys_.map.n_keyframes) == n_kf_before,
            "use_nmi": use_nmi,
            "pass1_loop_closures": n_loops,
            "pass1_kf_err_m": dict(p50=float(np.median(kf_err)), max=float(np.max(kf_err)))
            if kf_err else None,
            # (frame, keyframe, inliers, the frame's error, the keyframe's frame)
            "pass2_relocalizations": [
                (int(f) - n_frames, int(k), int(n), err_at.get(int(f) - n_frames),
                 int(m.kf_frame_id[k])) for f, k, n in tr.relocalizations[n_rel0:]],
            "pass2_frames_over_1m": len(far),
            "pass2_first_frame_over_1m": far[0] if far else None,
        }
    finally:
        sys_.shutdown()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=520)
    p.add_argument("--no-nmi", action="store_true")
    p.add_argument("--pipelined-build", action="store_true",
                   help="build pass 1 with the pipelined front-end")
    p.add_argument("--out", default="LOCMODE.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    out = run(args.frames, use_nmi=not args.no_nmi, pipelined_build=args.pipelined_build,
              device=args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
