"""Ground-truth audit of the pipelined front-end's bindings: a far-arc drift probe.

    python3 -m orbslam2_nmi_torch.tools.fused_probe [--frames 300] [--total 520]
        [--probe-from 240] [--use-nmi] [--out PATH] [--device cuda|cpu]

Port of `orbslam2_nmi_tpu/tools/fused_probe.py`. For every fused frame from
`--probe-from` on, it audits the (feature pixel, map point) bindings against
exact ground truth: the terrain's height is analytic
(`io/synthetic.terrain_height`), so each feature pixel's true 3-D point is
found by casting its ray from the true camera pose
(`io/synthetic.raycast_terrain`). It separates three explanations of a pose
jump:

  * map deformation: the bound map points sit far from the features' true
    points, consistently (the median displacement grows);
  * wrong association: a subpopulation of bindings with large displacement
    while the median stays small;
  * a solver jump: the bindings are fine (small displacement) but the pose
    still lands off the truth.

It runs the pipelined front-end with synchronous mapping and synchronous NMI,
so the run is repeatable, and writes one JSON row a probed frame to --out
(default `fused_probe.jsonl` in the working directory).
"""

from __future__ import annotations

import json

import numpy as np

from orbslam2_nmi_torch.io.synthetic import raycast_terrain


def _center(T):
    return -T[:3, :3].T @ T[:3, 3]


def audit_row(fid: int, frame, u, gt: np.ndarray, K: np.ndarray, mp_pos: np.ndarray) -> dict:
    """One probed frame's row: the pose error, the bindings, and for the
    bound features the displacement of their map points from the ray-cast
    true points and their reprojection residual under the true pose.
    `mp_pos` holds the bound features' map-point positions, in order."""
    bound = (frame.mp_idx >= 0) & ~frame.outlier
    idxs = np.nonzero(bound)[0]
    row = {"i": fid, "err_m": float(np.linalg.norm(_center(frame.Tcw) - _center(gt))),
           "n_bound": int(len(idxs)), "n1": u.n_matches1, "inl": u.n_inliers}
    if len(idxs):
        px = np.concatenate([frame.xy[idxs], np.ones((len(idxs), 1))], -1)
        dirs_w = (gt[:3, :3].T @ (np.linalg.inv(K) @ px.T)).T
        pgt = raycast_terrain(_center(gt), dirs_w)
        d = np.linalg.norm(mp_pos - pgt, axis=-1)
        row.update(disp_p50=float(np.median(d)), disp_p90=float(np.quantile(d, 0.9)),
                   frac_gt_15cm=float((d > 0.15).mean()), frac_gt_40cm=float((d > 0.40).mean()))
        # the bound points' reprojection under the true pose: small means the
        # data was consistent and the solver is at fault

        def project(pc):
            return np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                             K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)

        res = np.linalg.norm(project(mp_pos @ gt[:3, :3].T + gt[:3, 3]) - frame.xy[idxs],
                             axis=-1)
        row.update(reproj_gtpose_p50=float(np.median(res)),
                   reproj_gtpose_p90=float(np.quantile(res, 0.9)))
    return row


def main(argv=None) -> int:
    import argparse

    from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend
    from orbslam2_nmi_torch.tools.replay_bench import build_system, generate_sequence

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--total", type=int, default=520)
    p.add_argument("--probe-from", type=int, default=240)
    p.add_argument("--use-nmi", action="store_true")
    p.add_argument("--out", default="fused_probe.jsonl")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    world, frames = generate_sequence(args.frames, n_total=args.total, device=args.device)
    n_frames, height, width = frames.shape
    sys_ = build_system(world, width, height, use_nmi=args.use_nmi, async_mapping=False,
                        async_nmi=False, device=args.device)
    K = world.camera_K(width, height).astype(np.float64)
    try:
        sys_.set_init_poses(world.pose_at(0, args.total),
                            world.pose_at(sys_.cfg.nmi.offset, args.total))
        with open(args.out, "w") as out_f:
            def hook(fid, frame, u):
                if fid < args.probe_from:
                    return
                bound = (frame.mp_idx >= 0) & ~frame.outlier
                with sys_.map.lock:
                    mp_pos = sys_.map.mp_pos[frame.mp_idx[bound]].copy()
                row = audit_row(fid, frame, u, world.pose_at(fid, args.total), K, mp_pos)
                out_f.write(json.dumps(row) + "\n")
                out_f.flush()

            fe = PipelinedFrontend(sys_)
            fe.debug_hook = hook
            results = fe.run(frames, np.arange(n_frames) / 30.0, start_id=0)
        n_ok = sum(1 for r in results if r is not None and r.Tcw is not None)
        print(json.dumps({"n_tracked": n_ok, "n_keyframes": int(sys_.map.n_keyframes),
                          "out": args.out}))
    finally:
        sys_.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
