"""Loop closure on a replay's map: the CorrectLoop chain on real state.

    python3 -m orbslam2_nmi_torch.tools.loop_bench [--frames 520] [--device cuda|cpu]

Port of `orbslam2_nmi_tpu/tools/loop_bench.py`. It drives the wide
loop-closure circuit (`SyntheticMeshWorld.generate_wide`: disjoint opposite
arcs, a 15 % revisit) through the whole system without NMI, so drift
accumulates, then runs the complete LoopClosing chain (Sim3 RANSAC
verification, guided matching, OptimizeSim3, CorrectLoop's Sim3
propagation, SearchAndFuse, the essential graph and a global BA;
LoopClosing.cc:239-756) between the last keyframe and its geometrically true
revisit partner, and reports the ATE before and after the correction.

Why the explicit pairing: in live replays of this circuit the revisit is
usually taken by relocalization first (tracking hiccups on the approach,
Relocalization() re-attaches the camera to the start arc's keyframes), and
from then on every new keyframe is covisible with the loop region, which
rightly disqualifies it as a DetectLoop candidate (LoopClosing.cc:147). This
harness holds the correction machinery itself to a replay's state. Output:
one JSON object.
"""

from __future__ import annotations

import json

import numpy as np


def run(n_frames: int = 520, width: int = 960, height: int = 540, device="cuda") -> dict:
    from orbslam2_nmi_torch.io.trajectory import ate_rmse, recompose_trajectory
    from orbslam2_nmi_torch.slam.tracking import TrackingState
    from orbslam2_nmi_torch.tools import replay_bench

    world, frames = replay_bench.generate_sequence(n_frames, width, height, circuit="wide",
                                                   device=device)
    sys_ = replay_bench.build_system(world, width, height, use_nmi=False, async_mapping=False,
                                     max_frames=15, device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_frames),
                            world.pose_at(sys_.cfg.nmi.offset, n_frames))
        n_ok = 0
        for i in range(n_frames):
            res = sys_.track_monocular(frames[i], i / 30.0)
            if res.state == TrackingState.OK and res.Tcw is not None:
                n_ok += 1
        m, lc = sys_.map, sys_.loop_closer

        def ate_now():
            with m.lock:
                rows = recompose_trajectory(sys_.tracker.trajectory, m)
            return float(ate_rmse([r[2] for r in rows],
                                  [world.pose_at(r[0], n_frames) for r in rows], align=True))

        def gt_center(k):
            T = world.pose_at(int(m.kf_frame_id[k]), n_frames)
            return -T[:3, :3].T @ T[:3, 3]

        out = {
            "n_frames": n_frames,
            "n_tracked": n_ok,
            "n_keyframes": int(m.n_keyframes),
            "ate_before_m": ate_now(),
            "loops_closed_by_detection": len(lc.loop_edges) if lc is not None else 0,
        }
        with m.lock:
            valid = [int(k) for k in m.valid_keyframe_indices()]
        if lc is None or len(valid) < 10:
            out["error"] = "no loop closer / too few keyframes"
            return out
        # the last keyframe's geometrically true partner: the early-arc
        # keyframe whose ground-truth camera centre is nearest (the revisit
        # arc re-traverses the first 15 % of the circuit)
        k_last = max(valid, key=lambda k: int(m.kf_frame_id[k]))
        c_last = gt_center(k_last)
        early = [k for k in valid if m.kf_frame_id[k] < 0.3 * int(m.kf_frame_id[k_last])]
        if not early:
            out["error"] = "no early-arc keyframes survive"
            return out
        cand = min(early, key=lambda k: float(np.linalg.norm(gt_center(k) - c_last)))
        out["pair"] = [int(k_last), int(cand)]
        out["pair_gt_gap_m"] = float(np.linalg.norm(gt_center(cand) - c_last))
        with m.lock:
            ok, Scw_corr, matched_cur, loop_mps = lc._compute_sim3(k_last, cand)
            out["sim3_verified"] = bool(ok)
            if ok:
                lc._correct_loop(k_last, cand, Scw_corr, matched_cur, loop_mps)
        if ok:  # synchronous mode: the global BA after the essential graph
            sys_.local_mapper.global_ba(iters=10)
            out["ate_after_m"] = ate_now()
            out["n_loop_edges"] = len(lc.loop_edges)
        return out
    finally:
        sys_.shutdown()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=520)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.frames, device=args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
