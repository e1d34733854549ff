"""Scaling of the sharded paths over worlds of 1, 2, 4, ... ranks.

Port of `orbslam2_nmi_tpu/tools/scaling_bench.py`, at its shapes: the
pose-grid-sharded NMI search (8 renders x 8 warps at 240x320 on 200,000
splat points), the point-sharded Schur BA (64 cameras, 4,096 points, 15 % of
the pairs observed, 3 + 3 iterations) and the edge-sharded pose graph (V 256
with chain, loop and covisibility edges, 5 iterations). One fresh world a
rank count (`parallel.distributed.spawn_world`); each stage runs once to warm
up, then `--runs` times, every rank starting together after a barrier, timed
on rank 0's host clock around work that ends in a synchronize (a rank that
finishes first waits in the last collective).

    python -m orbslam2_nmi_torch.tools.scaling_bench --device cpu --out S.json
    python -m orbslam2_nmi_torch.tools.scaling_bench            # NCCL, the visible cards

`--device cpu` runs gloo worlds of 1/2/4/8 ranks on the CPU, as the JAX tool
ran 1/2/4/8 virtual CPU devices: the ranks share one machine's cores and the
total work is fixed, so the wall time cannot fall with the rank count, and
`overhead_factor` t(n)/t(1) (ideal 1.0) measures what sharding adds
(collectives, padding, the root's solves). `--device cuda` runs NCCL worlds
up to the visible card count (one card a rank). The JSON has the JAX tool's
keys (SCALING_r05.json): `device_counts`, and under `stages.{nmi_s, ba_s,
pose_graph_s}` `median_s`, `cv`, `min_s`, `max_s`, `n_runs`,
`overhead_factor` and `efficiency_estimate`; `device` names what ran.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from orbslam2_nmi_torch import kernels

STAGES = ("nmi", "ba", "pg")
_KEY = {"nmi": "nmi_s", "ba": "ba_s", "pg": "pose_graph_s"}  # the JAX tool's keys


def _problems(dev):
    """The three stages' inputs on `dev`, from default_rng(0) in the JAX
    tool's order."""
    from orbslam2_nmi_torch.ops import homography, render
    from orbslam2_nmi_torch.solvers import local_ba, pose_graph

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    # NMI: 8 translation x 8 rotation candidates at 240x320 (point splat)
    H, W = 240, 320
    pts = np.stack([rng.uniform(-15, 15, 200_000), rng.uniform(-10, 10, 200_000),
                    rng.uniform(8, 20, 200_000)], -1).astype(np.float32)
    gray = ((np.floor(pts[:, 0]) * 37 + np.floor(pts[:, 1]) * 91) % 256).astype(np.float32)
    model = render.RenderModel(points=t(pts), gray=t(gray))
    K = np.array([[240.0, 0, 160], [0, 240.0, 120], [0, 0, 1]], np.float32)
    offsets = render.translation_grid_offsets((2, 2, 2), (0.3, 0.3, 0.3), device=dev)
    angles = homography.rotation_grid_angles((2, 2, 2), (0.03, 0.03, 0.03), device="cpu").numpy()
    I4 = torch.eye(4, device=dev)
    frame = render.render_pointcloud(model, I4, K, H, W, 1.0, 30.0, 3)
    nmi = (model, frame, I4, offsets, angles, K, H, W, 1.0, 30.0)

    # BA: 64 cameras x 4,096 points, ~40k observations
    n_cams, n_pts = 64, 4096
    pw = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-8, 8, n_pts),
                   rng.uniform(10, 30, n_pts)], -1).astype(np.float32)
    Kb = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    cams[:, 0, 3] = np.linspace(0, 6, n_cams)
    oc, op = np.meshgrid(np.arange(n_cams), np.arange(n_pts), indexing="ij")
    oc, op = oc.ravel(), op.ravel()
    keep = rng.random(len(oc)) < 0.15
    oc, op = oc[keep], op[keep]
    pc = np.einsum("oij,oj->oi", cams[oc, :3, :3], pw[op]) + cams[oc, :3, 3]
    uv = pc[:, :2] / pc[:, 2:3] * [300.0, 300.0] + [160.0, 120.0]
    ba = local_ba.BAProblem(
        K=t(Kb), cam_Tcw=t(cams), cam_fixed=t(np.arange(n_cams) < 2),
        cam_valid=t(np.ones(n_cams, bool)),
        pts_w=t(pw + rng.normal(0, 0.02, pw.shape).astype(np.float32)),
        pts_valid=t(np.ones(n_pts, bool)), obs_cam=t(oc.astype(np.int32)),
        obs_pt=t(op.astype(np.int32)), obs_uv=t(uv.astype(np.float32)),
        obs_inv_sigma2=t(np.ones(len(oc), np.float32)), obs_valid=t(np.ones(len(oc), bool)))

    # pose graph: 256 keyframes, chain + loop + covisibility edges
    V = 256
    est = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    est[:, 0, 3] = np.linspace(0, 20, V) + rng.normal(0, 0.05, V)
    ei = list(range(V - 1)) + [0] + list(range(0, V - 8, 4))
    ej = list(range(1, V)) + [V - 1] + list(range(8, V, 4))
    meas = np.stack([est[j] @ np.linalg.inv(est[i]) for i, j in zip(ei, ej)]).astype(np.float32)
    pg = pose_graph.PoseGraphProblem(
        Scw=t(est), fixed=t(np.arange(V) == 0), valid=t(np.ones(V, bool)),
        edge_i=t(np.asarray(ei, np.int32)), edge_j=t(np.asarray(ej, np.int32)),
        edge_Sji=t(meas), edge_valid=t(np.ones(len(ei), bool)))
    return nmi, ba, pg


def _bench_rank(stages, n_runs) -> dict:
    """One rank of a world: each stage warmed up once, then timed `n_runs`
    times (seconds, rank 0's clock is the one reported)."""
    import torch.distributed as dist

    from orbslam2_nmi_torch.parallel import distributed, mesh as mesh_lib
    from orbslam2_nmi_torch.parallel import sharded_ba, sharded_nmi, sharded_pose_graph

    dev = distributed.local_device()
    mesh = mesh_lib.make_mesh()
    nmi, ba, pg = _problems(dev)
    run = {"nmi": lambda: sharded_nmi.sharded_nmi_search(mesh, *nmi),
           "ba": lambda: sharded_ba.sharded_bundle_adjust(mesh, ba, iters1=3, iters2=3),
           "pg": lambda: sharded_pose_graph.sharded_optimize_pose_graph(mesh, pg, iters=5)}

    def once(fn):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    out = {}
    for st in stages:
        once(run[st])  # warm-up
        out[st] = [once(run[st]) for _ in range(n_runs)]
    return out


def _stats(ts):
    med = float(np.median(ts))
    return {"median_s": med, "min_s": float(np.min(ts)), "max_s": float(np.max(ts)),
            "std_s": float(np.std(ts)), "cv": float(np.std(ts) / med), "n_runs": len(ts)}


def run(device_counts=None, out_path: str | None = None, stages: str = "nmi,ba,pg",
        n_runs: int = 5, device="cuda") -> dict:
    """Time the stages in one fresh world per rank count; returns (and with
    `out_path` writes) the table."""
    from orbslam2_nmi_torch.parallel import distributed

    dev = kernels.resolve_device(device, "scaling_bench")
    stages = [s for s in stages.split(",") if s]
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)} (choose from {STAGES})")
    if device_counts is None:
        top = torch.cuda.device_count() if dev.type == "cuda" else 8
        device_counts = [n for n in (1, 2, 4, 8) if n <= top]
    if dev.type == "cuda":
        kernels.build()  # once, before any rank starts
    rows = {n: distributed.spawn_world(_bench_rank, n, stages, n_runs, device=dev.type)[0]
            for n in device_counts}
    n0 = device_counts[0]
    table = {"device_counts": list(device_counts), "stages": {}}
    for st in stages:
        s = {n: _stats(rows[n][st]) for n in device_counts}
        med = {n: s[n]["median_s"] for n in device_counts}
        table["stages"][_KEY[st]] = {
            "median_s": med,
            "cv": {n: round(s[n]["cv"], 3) for n in device_counts},
            "min_s": {n: s[n]["min_s"] for n in device_counts},
            "max_s": {n: s[n]["max_s"] for n in device_counts},
            "n_runs": n_runs,
            # fixed TOTAL work: on shared cores the ideal wall time is flat
            # in n, so t(n)/t(1) isolates the cost sharding adds
            "overhead_factor": {n: med[n] / med[n0] for n in device_counts},
            "efficiency_estimate": {n: med[n0] / med[n] for n in device_counts},
        }
    if dev.type == "cuda":
        table["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count(), "backend": "nccl"}
    else:
        table["device"] = {"platform": "cpu", "backend": "gloo"}
    table["note"] = (
        "gloo worlds on one machine's CPU cores share those cores, so the wall time cannot "
        "fall with the rank count: overhead_factor t(n)/t(1) (ideal 1.0) measures what "
        "sharding adds; NCCL worlds run one card a rank."
        if dev.type == "cpu" else "NCCL worlds, one card a rank.")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(table, f, indent=1)
    return table


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--counts", default=None,
                   help="rank counts, comma-separated (default 1,2,4,8 up to the cards)")
    p.add_argument("--stages", default="nmi,ba,pg")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--out", default=None, help="write the JSON table here")
    args = p.parse_args(argv)
    counts = None if args.counts is None else [int(n) for n in args.counts.split(",")]
    t = run(counts, args.out, args.stages, args.runs, args.device)
    print(json.dumps(t, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
