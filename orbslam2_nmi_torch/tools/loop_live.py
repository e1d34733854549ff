"""Live in-replay loop closure on the wide circuit: the whole chain, observed.

    python3 -m orbslam2_nmi_torch.tools.loop_live [--frames 520] [--use-nmi]
        [--max-frames 15] [--features 2000] [--domain-gap] [--out PATH]
        [--device cuda|cpu]

Port of `orbslam2_nmi_tpu/tools/loop_live.py`. It replays the wide
loop-closure circuit (disjoint opposite arcs, a 15 % revisit,
`SyntheticMeshWorld.generate_wide`) through the whole asynchronous pipeline
(the pipelined front-end, the mapping worker) without NMI, so monocular
drift accumulates and the revisit at the circuit's end must be closed by
the LoopClosing chain itself: DetectLoop, Sim3 RANSAC, CorrectLoop,
SearchAndFuse, the essential graph, and the global BA on its own abortable
thread (LoopClosing.cc:111-756). Every stage fires from the replay. The
tool records each firing: the recomposed trajectory's ATE just before the
correction and after the essential graph, the ATE at the end (after the
global BA landed), the time the global BA took to drain at the end, and the
largest frame-to-frame wall stall while the correction ran (within 30 s of
its firing). Output: one JSON object.
"""

from __future__ import annotations

import json
import time

import numpy as np


def run(n_frames: int = 520, width: int = 960, height: int = 540, use_nmi: bool = False,
        max_frames: int = 15, n_features: int = 2000, domain_gap: bool = False,
        device="cuda") -> dict:
    from orbslam2_nmi_torch.io.trajectory import ate_rmse, recompose_trajectory
    from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend
    from orbslam2_nmi_torch.slam.tracking import TrackingState
    from orbslam2_nmi_torch.tools import replay_bench

    # the domain gap degrades matching smoothly (the whole feature budget
    # survives and drift accumulates): the regime where the correction is
    # measurable; a lean feature budget instead loses tracking outright
    world, frames = replay_bench.generate_sequence(n_frames, width, height, circuit="wide",
                                                   domain_gap=domain_gap, device=device)
    sys_ = replay_bench.build_system(world, width, height, use_nmi=use_nmi, async_mapping=True,
                                     max_frames=max_frames, n_features=n_features,
                                     device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_frames),
                            world.pose_at(sys_.cfg.nmi.offset, n_frames))
        m = sys_.map

        def ate_now():  # the caller holds the map lock
            rows = recompose_trajectory(sys_.tracker.trajectory, m)
            if not rows:
                return None
            return float(ate_rmse([r[2] for r in rows],
                                  [world.pose_at(r[0], n_frames) for r in rows],
                                  align=not use_nmi))

        # record each organic firing (CorrectLoop runs with the map lock
        # held); the loop closer is built when the vocabulary trains from the
        # first keyframes (SLAMSystem.ensure_vocabulary), so hook that
        events: list = []

        def install(lc):
            correct = lc._correct_loop

            def recorded(k, cand, Scw_corr, matched_cur=None, loop_mps=None):
                ev = {"kf": int(k), "cand": int(cand), "frame_id": int(m.kf_frame_id[k]),
                      "ate_before_m": ate_now(), "t_fire": time.perf_counter()}
                t0 = time.perf_counter()
                correct(k, cand, Scw_corr, matched_cur, loop_mps)
                ev["correct_loop_s"] = time.perf_counter() - t0
                ev["ate_after_essential_graph_m"] = ate_now()
                events.append(ev)

            lc._correct_loop = recorded

        if sys_.loop_closer is not None:
            install(sys_.loop_closer)
        else:
            build = sys_._build_place_recognition

            def build_recorded():
                build()
                install(sys_.loop_closer)

            sys_._build_place_recognition = build_recorded

        fe = PipelinedFrontend(sys_)
        results = fe.run(frames, np.arange(n_frames) / 30.0, start_id=0)
        n_ok = sum(1 for r in results
                   if r is not None and r.Tcw is not None and r.state == TrackingState.OK)
        # wait for the global BA's thread (LoopClosing.cc:652) and time it
        t0 = time.perf_counter()
        replay_bench.drain(sys_)
        gba_drain_s = time.perf_counter() - t0
        with m.lock:
            ate_final = ate_now()
            n_anchors = replay_bench.count_anchors(m)

        # the frame walls' stalls while each correction and its global BA ran
        walls = [fe.completion_walls[f] for f in sorted(fe.completion_walls)]
        d = np.diff(np.asarray(walls))
        stalls = {}
        for ev in events:
            tf = ev.pop("t_fire")
            after = [walls[i + 1] - walls[i] for i in range(len(d))
                     if walls[i] >= tf and walls[i + 1] <= tf + 30.0]
            if after:
                stalls[f"kf{ev['kf']}"] = {"frame_stall_max_s_within_30s": max(after),
                                           "frame_stall_p50_s": float(np.median(after))}
        return {
            "n_frames": n_frames,
            "n_tracked": n_ok,
            "n_keyframes": int(m.n_keyframes),
            "n_kf_valid": int(m.kf_valid.sum()),
            "use_nmi": use_nmi,
            "n_loop_closures": len(sys_.loop_closer.loop_edges) if sys_.loop_closer else 0,
            "loop_events": events,
            "ate_final_m": ate_final,
            "gba_drain_at_end_s": gba_drain_s,
            "frame_stalls_during_correction": stalls,
            "frame_ms_p50": float(np.median(d)) * 1e3,
            "frame_ms_p95": float(np.quantile(d, 0.95)) * 1e3,
            "frame_ms_max": float(d.max()) * 1e3,
            "n_nmi_anchors": n_anchors,
        }
    finally:
        sys_.shutdown()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=520)
    p.add_argument("--use-nmi", action="store_true")
    p.add_argument("--max-frames", type=int, default=15,
                   help="keyframe cadence cap (denser keyframes on the wide circuit)")
    p.add_argument("--features", type=int, default=2000,
                   help="ORB budget; a lean one (e.g. 600) gives the mid-drift regime")
    p.add_argument("--domain-gap", action="store_true",
                   help="photometric-gap camera imagery: matching degrades smoothly at the "
                        "full feature budget, the regime where the correction is measurable")
    p.add_argument("--out", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    out = run(args.frames, use_nmi=args.use_nmi, max_frames=args.max_frames,
              n_features=args.features, domain_gap=args.domain_gap, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
