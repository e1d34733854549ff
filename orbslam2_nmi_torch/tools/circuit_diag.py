"""Per-frame diagnostic drive of the 520-frame circuit: keyframe decisions.

    python3 -m orbslam2_nmi_torch.tools.circuit_diag [--mapper async|idle|drained|sync ...]
        [--prefix N] [--repeat R] [--out DIR]

From the root of a checkout, one GPU. It builds `entry.circuit_entry()` (the
seed-1 circuit at 960x540, async mapping and async NMI) and drives it through
`PipelinedFrontend.run` in chunks of 40 frames, as `chip_smoke.py`'s system
phase does (the JAX package's `tools/circuit_diag.py`). With `--mapper idle`
the mapping worker is drained after every fused frame, so each keyframe
decision meets an idle mapper, as it would behind a tracker much slower than
the mapper; with `--mapper drained` the NMI worker is drained too, so each
anchor lands before the next frame is dispatched. With `--mapper sync` the
system has no workers: local mapping and the keyframes' NMI sweeps run at
the keyframe that asks for them. Several modes run one after another on the
same rendered frames, each on a fresh system.

It writes one JSON row a frame to DIR/rows_<run>_<mapper>.jsonl (path,
inliers, online error, keyframe, and the inputs of the keyframe decision: c1a, c1b,
c2, the mapper idle, the reference keyframe and its points seen from at least
`min_obs` keyframes) and prints a summary: frames tracked, keyframes created
and surviving, NMI anchors, ATE of the recomposed trajectory, and the
decisions counted by cause: frames where c2 held, those of them refused
because the mapper was busy, keyframes made by c2 and by the 30-frame
cadence alone; the map points' observation counts; and each keyframe's NMI
sweep with the camera-centre error of the keyframe's pose before the sweep
and of the pose the sweep found, and the frame the tracker had reached when
it landed; and the anchors that landed while a local BA which held their
keyframe free was solving (`landed_in_solve`: the BA's write-back finds the
keyframe anchored). Every time is printed with the card's
`nvidia-smi` line.

    python3 -m orbslam2_nmi_torch.tools.circuit_diag --frames N [--total M]
        [--classic] [--pipelined] [--no-nmi] [--domain-gap] [--wide]
        [--mapper async|sync ...] [--out DIR]

is the JAX tool's drive (`run_diag`): the first N frames of the M-frame
circuit (`replay_bench.generate_sequence`; the domain-gap imagery at
threshold 0.1, else 0.45; `--wide` the loop-closure circuit) through the
classic front-end (`SLAMSystem.track_monocular`, frame by frame) or the
pipelined one, each front-end asked for (classic if neither) in each mapper
mode (async: the JAX tool's async mapping and NMI; sync: no workers), on a
fresh `replay_bench.build_system` each. It writes the JAX tool's rows (frame,
state, online error, inliers, keyframe, the recomposed trajectory's error)
and the captured log to DIR/diag_<run>_<front-end>_<mapper>[_dg].jsonl and
prints the JAX summary's keys with the online error's p50, p95 and max, the
keys of PIPELINED_VS_CLASSIC_r05.json.

It refuses to run without CUDA unless `--device cpu` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_nmi_torch.entry import CIRCUIT_FRAMES, circuit_entry, circuit_system
from orbslam2_nmi_torch.io.trajectory import ate_rmse, recompose_trajectory
from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend
from orbslam2_nmi_torch.slam.tracking import TrackingState
from orbslam2_nmi_torch.tools import replay_bench

CHUNK = 40  # frames a PipelinedFrontend.run call


def _center(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def decision_counts(records: dict) -> dict:
    """The keyframe decisions of the fused frames (`PipelinedFrontend.records`
    with `Tracker.kf_check`) counted by cause."""
    checks = [(r, r["kf_check"]) for r in records.values()
              if r["path"] == "fused" and r.get("kf_check")]
    c2 = [(r, c) for r, c in checks if c["c2"]]
    return dict(
        decisions=len(checks),
        c2_held=len(c2),
        c2_held_mapper_busy=sum(1 for _, c in c2 if not c["idle"]),
        c2_refused_mapper_busy=sum(1 for r, c in c2 if not c["idle"] and not r["keyframe"]),
        keyframes=sum(1 for r, _ in checks if r["keyframe"]),
        keyframes_by_c2=sum(1 for r, c in checks if r["keyframe"] and c["c2"]),
        keyframes_by_cadence_alone=sum(1 for r, c in checks
                                       if r["keyframe"] and c["c1a"] and not c["c2"]),
        mapper_idle_share=float(np.mean([c["idle"] for _, c in checks])) if checks else None,
        inliers_over_ref_tracked_p50=float(np.median(
            [c["inliers"] / max(c["ref_tracked"], 1) for _, c in checks])) if checks else None,
    )


def record_sweeps(system, poses) -> list:
    """Record each keyframe NMI sweep of `system` as it lands (a list the
    sweeps are appended to): frame, whether it relocalized, and the camera-
    centre error against `poses` of the keyframe's pose before the sweep and
    of the pose it found. Installed before the drive; frames past `poses`
    are not recorded."""
    sweeps: list = []

    def row(frame_id, before, found, relocalized):
        if frame_id >= len(poses):  # a frame beyond the circuit has no truth
            return
        truth = _center(poses[frame_id])
        sweeps.append(dict(frame=int(frame_id), relocalized=bool(relocalized),
                           err_before_m=float(np.linalg.norm(_center(before) - truth)),
                           err_found_m=float(np.linalg.norm(_center(found) - truth))))

    worker, tr = system.nmi_worker, system.tracker
    if worker is not None:
        apply = worker._apply

        def recorded_apply(k, out, dist0, rot0, frame_id, epoch):
            with system.map.lock:
                before = system.map.kf_Tcw[k].copy()
            row(frame_id, before, out.Tcw, out.relocalized)
            if sweeps and sweeps[-1]["frame"] == frame_id:
                sweeps[-1]["landed_at"] = int(tr.last_frame.frame_id)
            return apply(k, out, dist0, rot0, frame_id, epoch)

        worker._apply = recorded_apply
    else:
        run = tr._run_nmi

        def recorded_run(frame, initializing, search_scale=1.0):
            before = frame.Tcw.copy()
            ok = run(frame, initializing, search_scale)
            if not initializing:
                row(frame.frame_id, before, frame.Tcw, ok)
            return ok

        tr._run_nmi = recorded_run
    return sweeps


def record_landings_in_solve(system) -> list:
    """Record the anchors that land while a local BA holding their keyframe
    free solves: at the BA's write-back (under the map lock) the keyframe is
    free in the solve and anchored in the map. Returns the list the
    keyframes' frame ids are appended to."""
    m, lm = system.map, system.local_mapper
    landed: list = []
    apply = lm._ba_apply

    def recorded(res, cams, pts, fixed, *rest):
        landed.extend(int(m.kf_frame_id[kf]) for i, kf in enumerate(cams)
                      if not fixed[i] and m.kf_valid[kf] and m.kf_nmi_reloc[kf])
        return apply(res, cams, pts, fixed, *rest)

    lm._ba_apply = recorded
    return landed


def drive(system, frames, poses, mapper: str = "async", chunks=None) -> tuple:
    """Drive `system` (fresh, from `entry.circuit_system`) over `frames`
    through `PipelinedFrontend.run` in `chunks` ((start, end) frame ranges;
    by default of 40 frames); with `mapper` "idle"
    the mapping worker is drained after every fused frame, with "drained"
    both workers, an anchor's local BA included ("async" and "sync" drive
    the system as it is built). Drains the workers and shuts
    the system down. Returns (front-end, results, summary dict); the
    summary's `worker_errors` holds the workers' errors."""
    n = frames.shape[0]
    m, tr = system.map, system.tracker
    fe = PipelinedFrontend(system)
    if mapper == "idle":
        fe.debug_hook = lambda fid, frame, u: system.pipeline.flush(600.0)
    elif mapper == "drained":  # an anchor queues its local BA before the worker goes idle
        fe.debug_hook = lambda fid, frame, u: (system.nmi_worker.flush(600.0),
                                               system.pipeline.flush(600.0))
    sweeps = record_sweeps(system, poses)
    landed = record_landings_in_solve(system)
    ts = np.arange(n) / system.cfg.camera.fps
    results = []
    t0 = time.perf_counter()
    try:
        for c0, c1 in chunks or [(c, min(c + CHUNK, n)) for c in range(0, n, CHUNK)]:
            results.extend(fe.run(frames[c0:c1], ts[c0:c1], start_id=c0))
        drive_s = time.perf_counter() - t0
        for worker in (system.nmi_worker, system.pipeline):
            if worker is not None:
                worker.flush(600.0)
        errors = system.errors()
        with m.lock:
            rows = recompose_trajectory(tr.trajectory, m)
            vk = m.valid_keyframe_indices()
            anchors = [int(f) for f, a in zip(m.kf_frame_id[vk], m.kf_nmi_reloc[vk]) if a]
            kf_frames = [int(f) for f in m.kf_frame_id[: m.n_keyframes]]
            obs = m.mp_obs_n[m.valid_point_indices()]
    finally:
        system.shutdown()
    tracked = [i for i, r in enumerate(results)
               if r is not None and r.state == TrackingState.OK and r.Tcw is not None]
    ate = ate_rmse([r[2] for r in rows], [poses[r[0]] for r in rows], align=False)
    snapped = [w for w in sweeps if w["relocalized"]]
    summary = dict(
        mapper=mapper, frames=n, tracked=len(tracked), keyframes_created=len(kf_frames),
        keyframes_surviving=int(len(vk)), keyframe_frames=kf_frames, anchors=len(anchors),
        anchor_frames=anchors, ate_rmse_m=float(ate), map_points=int(len(obs)),
        point_obs=dict(mean=float(obs.mean()), share_ge3=float((obs >= 3).mean())),
        decisions=decision_counts(fe.records), rewinds=fe.n_rewinds, drive_s=drive_s,
        frames_per_s=n / drive_s, nmi_sweeps=len(sweeps), nmi_snapped=len(snapped),
        nmi_err_before_m=float(np.mean([w["err_before_m"] for w in snapped])) if snapped else None,
        nmi_err_found_m=float(np.mean([w["err_found_m"] for w in snapped])) if snapped else None,
        landed_in_solve=landed, sweeps=sweeps, worker_errors=errors)
    return fe, results, summary


def diag_rows(world, results, n_total: int, lo: int = 0, hi: int | None = None) -> list:
    """The JAX tool's per-frame rows of `results[lo:hi]`: frame, state, the
    online camera-centre error against `world`'s truth (4 decimals), inliers
    and whether the frame made a keyframe."""
    rows = []
    for i in range(lo, len(results) if hi is None else hi):
        r = results[i]
        row = {"i": i}
        if r is None or r.Tcw is None:
            row["state"] = "none"
        else:
            row["state"] = r.state.name
            row["err_m"] = round(float(np.linalg.norm(
                _center(r.Tcw) - _center(world.pose_at(i, n_total)))), 4)
            row["inl"] = int(r.n_inliers)
            row["kf"] = bool(r.is_keyframe)
        rows.append(row)
    return rows


def online_errors(rows) -> dict:
    """p50, p95 and max of the rows' online errors, in the keys of
    PIPELINED_VS_CLASSIC_r05.json."""
    e = np.asarray([r["err_m"] for r in rows if "err_m" in r], np.float64)
    if not len(e):
        return dict(online_err_p50_m=None, online_err_p95_m=None, online_err_max_m=None)
    return dict(online_err_p50_m=float(np.median(e)),
                online_err_p95_m=float(np.quantile(e, 0.95)), online_err_max_m=float(e.max()))


def run_diag(world, frames, pipelined: bool, use_nmi: bool, threshold: float, out_path: str,
             n_total: int | None = None, async_mapping: bool = True, device="cuda") -> dict:
    """The JAX tool's drive (`orbslam2_nmi_tpu/tools/circuit_diag.run_diag`):
    `replay_bench.build_system` on `world` (async mapping and async NMI, as
    the JAX tool builds it, unless `async_mapping` is off), the init poses
    frames 0 and `offset`'s truth, then every frame through the classic
    front-end (`track_monocular`) or, with `pipelined`, through
    `PipelinedFrontend.run` in chunks of 40; rows flushed to
    `out_path + ".part"` every 40 frames. Drains the workers, raises on
    their errors, writes the rows (with `err_final_m`, the error of the
    recomposed trajectory) and the captured log to `out_path`, shuts the
    system down and returns the JAX summary's keys with the rows' online
    error p50/p95/max."""
    n_frames, height, width = frames.shape
    n_total = n_total or n_frames
    sys_ = replay_bench.build_system(world, width, height, use_nmi=use_nmi,
                                     async_mapping=async_mapping, threshold=threshold,
                                     device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_total),
                            world.pose_at(sys_.cfg.nmi.offset, n_total))
        log_rows: list = []
        orig_log = sys_.log

        def capture_log(msg):
            log_rows.append(msg)
            orig_log(msg)

        sys_.log = sys_.tracker.log = capture_log
        ts = np.arange(n_frames) / 30.0
        results: list = []
        t0 = time.perf_counter()
        with open(out_path + ".part", "w") as part:
            if pipelined:
                fe = PipelinedFrontend(sys_)
                for c0 in range(0, n_frames, CHUNK):
                    c1 = min(c0 + CHUNK, n_frames)
                    results.extend(fe.run(frames[c0:c1], ts[c0:c1], start_id=c0))
                    part.writelines(json.dumps(r) + "\n"
                                    for r in diag_rows(world, results, n_total, c0, c1))
                    part.flush()
            else:
                for i in range(n_frames):
                    results.append(sys_.track_monocular(frames[i], float(ts[i])))
                    if (i + 1) % CHUNK == 0 or i == n_frames - 1:
                        part.writelines(json.dumps(r) + "\n" for r in diag_rows(
                            world, results, n_total, max(0, i + 1 - CHUNK), i + 1))
                        part.flush()
        wall = time.perf_counter() - t0
        replay_bench.drain(sys_)

        rows = diag_rows(world, results, n_total)
        m = sys_.map
        with m.lock:
            traj = recompose_trajectory(sys_.tracker.trajectory, m)
            vk = m.valid_keyframe_indices()
            kf_ids = [int(f) for f in m.kf_frame_id[vk]]
            nmi_kf_ids = [int(f) for f, a in zip(m.kf_frame_id[vk], m.kf_nmi_reloc[vk]) if a]
            n_keyframes, n_kf_valid = int(m.n_keyframes), int(m.kf_valid.sum())
        final_err = {int(fid): round(float(np.linalg.norm(
            _center(Tcw) - _center(world.pose_at(fid, n_total)))), 4)
            for fid, _t, Tcw, *_ in traj}
        for row in rows:
            if row["i"] in final_err:
                row["err_final_m"] = final_err[row["i"]]
        est = [r[2] for r in traj]
        gt = [world.pose_at(r[0], n_total) for r in traj]
        ate = ate_rmse(est, gt, align=not use_nmi) if est else float("inf")
        with open(out_path, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in rows)
            f.write(json.dumps({"log": log_rows}) + "\n")
    finally:
        sys_.shutdown()
    n_ok = sum(1 for r in results
               if r is not None and r.Tcw is not None and r.state == TrackingState.OK)
    return {"pipelined": pipelined, "use_nmi": use_nmi, "n_frames": n_frames,
            "n_tracked": n_ok, "n_keyframes": n_keyframes, "n_kf_valid": n_kf_valid,
            "ate_rmse": round(float(ate), 4), "wall_s": round(wall, 1),
            "kf_frame_ids": kf_ids, "nmi_anchor_frame_ids": nmi_kf_ids, "out": out_path,
            **online_errors(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mapper", choices=("async", "idle", "drained", "sync"), nargs="+",
                   default=["async"],
                   help="idle: drain the mapping worker after every fused frame; drained: "
                   "both workers; sync: no workers (several modes run one after another)")
    p.add_argument("--prefix", type=int, default=0,
                   help="drive the N-frame domain-gap prefix of tools/bench.py's replay instead")
    p.add_argument("--repeat", type=int, default=1, help="drive the list of modes R times")
    p.add_argument("--out", default="build/circuit_diag")
    p.add_argument("--frames", type=int, default=0,
                   help="the JAX tool's drive (run_diag) of the first N frames, on the front-ends "
                   "asked for (--classic, --pipelined; classic if neither) and the --mapper modes "
                   "async or sync")
    p.add_argument("--total", type=int, default=None,
                   help="with --frames: the circuit's length (default N)")
    p.add_argument("--classic", action="store_true", help="with --frames: track_monocular")
    p.add_argument("--pipelined", action="store_true", help="with --frames: PipelinedFrontend")
    p.add_argument("--no-nmi", action="store_true", help="with --frames: no localizer")
    p.add_argument("--domain-gap", action="store_true",
                   help="with --frames: the domain-gap imagery, threshold 0.1 (else 0.45)")
    p.add_argument("--wide", action="store_true", help="with --frames: the wide circuit")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.frames and set(args.mapper) - {"async", "sync"}:
        p.error("--frames drives the --mapper modes async and sync only")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("circuit_diag: CUDA is not available; this tool drives the circuit on an NVIDIA "
              "GPU (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    os.makedirs(args.out, exist_ok=True)
    if args.frames:
        return main_diag(args, smi)
    t = time.perf_counter()
    if args.prefix:
        world, frames = replay_bench.generate_sequence(
            args.prefix, 960, 540, n_total=CIRCUIT_FRAMES, domain_gap=True, cache=False,
            device=args.device)
        poses = np.stack([world.pose_at(i, CIRCUIT_FRAMES) for i in range(args.prefix)])
        chunks = [(0, replay_bench.WARMUP), (replay_bench.WARMUP, args.prefix)]

        def make(mode):
            s = replay_bench.build_system(world, 960, 540, async_mapping=mode != "sync",
                                          threshold=0.1, device=args.device)
            s.set_init_poses(poses[0], world.pose_at(s.cfg.nmi.offset, CIRCUIT_FRAMES))
            return s
        system = None
    else:
        system, frames, poses = circuit_entry(args.device)
        chunks = None

        def make(mode):
            return circuit_system(args.device, asynchronous=mode != "sync")[0]
        if args.mapper[0] == "sync":
            system.shutdown()
            system = None
    if args.device == "cuda":
        torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    failed = False
    for run, mode in enumerate(args.mapper * args.repeat):
        if system is None:
            system = make(mode)
        fe, results, summary = drive(system, frames, poses, mode, chunks)
        system = None
        errors = summary.pop("worker_errors")
        summary.update(render_s=render_s, worker_errors=len(errors), device=smi)
        with open(os.path.join(args.out, f"rows_{run}_{mode}.jsonl"), "w") as f:
            for i, r in enumerate(results):
                row = dict(i=i, state=r.state.name if r is not None else "none")
                if r is not None and r.Tcw is not None:
                    row["err_m"] = float(np.linalg.norm(_center(r.Tcw) - _center(poses[i])))
                rec = fe.records.get(i, {})
                row.update({k: rec[k] for k in ("path", "n_inliers", "keyframe", "kf_check")
                            if k in rec})
                f.write(json.dumps(row) + "\n")
        with open(os.path.join(args.out, f"summary_{run}_{mode}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps({k: v for k, v in summary.items()
                          if k not in ("keyframe_frames", "sweeps")}), flush=True)
        if errors:
            print(errors[0], file=sys.stderr)
            failed = True
    return 1 if failed else 0


def main_diag(args, smi: str) -> int:
    """`--frames N`: the JAX tool's drive on each front-end and mapper mode
    asked for, one after another on the same rendered frames; prints each
    summary as a JSON line with the card's `nvidia-smi` line."""
    world, frames = replay_bench.generate_sequence(
        args.frames, 960, 540, n_total=args.total, domain_gap=args.domain_gap, cache=False,
        circuit="wide" if args.wide else "standard", device=args.device)
    fronts = [f for f, on in (("classic", args.classic or not args.pipelined),
                              ("pipelined", args.pipelined)) if on]
    for run, (front, mode) in enumerate((f, m) for m in args.mapper * args.repeat for f in fronts):
        gap = "_dg" if args.domain_gap else ""
        summary = run_diag(world, frames, pipelined=front == "pipelined", use_nmi=not args.no_nmi,
                           threshold=0.1 if args.domain_gap else 0.45,
                           out_path=os.path.join(args.out, f"diag_{run}_{front}_{mode}{gap}.jsonl"),
                           n_total=args.total or args.frames, async_mapping=mode == "async",
                           device=args.device)
        summary.update(frontend=front, mapper=mode, domain_gap=args.domain_gap, device=smi)
        print(json.dumps({k: v for k, v in summary.items() if k != "kf_frame_ids"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
