"""Trajectory and map writers in the reference's output formats.

A numpy copy of `orbslam2_nmi_tpu/io/trajectory.py`, kept in this package so
that the port imports nothing of the JAX package; the quaternion goes
through the port's `geometry/se3.rot_to_quat` on the CPU.

  * SaveFullTrajectory (reference: src/System.cc:514-599): frame poses are
    stored RELATIVE to their reference keyframe at track time
    (Tracking.cc:667-691 mlRelativeFramePoses) and recomposed
    `Tcw = Tcr * Trw` at save time, walking the spanning tree when the
    reference keyframe was culled (System.cc:551-556), so loop closures,
    global BA and NMI anchoring correct the whole saved trajectory. Rows:
    `<id> <t> [KF][, NMI][, FAILED] x y z qx qy qz qw` (+ a companion `_twc`
    file with inverse-pose matrices and NMI previous poses).
  * SaveKeyFrameTrajectoryTUM (src/System.cc:417): `t x y z qx qy qz qw`.
  * PrintMapPoints .xyz dumps (src/Tracking.cc:2422-2449) go through
    `io.model_loader.save_xyz_pointcloud`.
Plus ATE-RMSE evaluation for the replay harness.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch.geometry import se3


def _quat_wxyz(Rwc: np.ndarray) -> np.ndarray:
    R = torch.from_numpy(np.ascontiguousarray(Rwc[None], dtype=np.float32))
    return se3.rot_to_quat(R)[0].numpy()


def recompose_trajectory(rows: list, map_store) -> list:
    """Recompose absolute per-frame poses from the tracker's relative rows.

    rows: (frame_id, t, Tcr, ref_kf, lost, previous_poses) as accumulated by
    the Tracker (Tracking.cc:667-691). Returns
    (frame_id, t, Tcw, flags, previous_poses) with `Tcw = Tcr * Trw` where
    Trw walks the spanning tree past culled reference keyframes accumulating
    the cull-time child->parent relatives (System.cc:543-557: `Trw *= mTcp`).
    Lost rows are skipped, like the reference's `if (*lbL) continue`.
    Flags are derived at save time: `KF` when Tcr ~ identity (System.cc:570),
    NMI / FAILED from the (possibly re-walked) reference keyframe's flags.
    """
    m = map_store
    out = []
    for frame_id, t, Tcr, ref, lost, prev in rows:
        if lost or ref < 0:
            continue
        Trw = np.eye(4, dtype=np.float32)
        k = int(ref)
        while not m.kf_valid[k]:  # spanning-tree walk past culled keyframes
            Trw = Trw @ m.kf_Tcp[k]
            k = int(m.kf_parent[k])
            if k < 0:
                break
        if k < 0:
            continue
        Trw = Trw @ m.kf_Tcw[k]
        Tcw = (Tcr @ Trw).astype(np.float32)
        flags = []
        if float(np.abs(Tcr - np.eye(4)).sum()) < 0.01:  # System.cc:570
            flags.append("KF")
            if m.kf_nmi_reloc[k]:
                flags.append("NMI")
            if m.kf_nmi_failed[k]:
                flags.append("FAILED")
        out.append((frame_id, t, Tcw, flags, prev))
    return out


def save_full_trajectory(path: str, rows: list, map_store):
    """SaveFullTrajectory (System.cc:514-599). Writes `<path>.txt` (quat rows)
    and `<path>_twc.txt` (inverse-pose matrices + NMI previous poses)."""
    with open(path + ".txt", "w") as f1, open(path + "_twc.txt", "w") as f2:
        for frame_id, t, Tcw, flags, prev in recompose_trajectory(rows, map_store):
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            q = _quat_wxyz(Rwc)  # [w, x, y, z]
            tag = ""
            if "KF" in flags:
                tag += " KF"
                if "NMI" in flags:
                    tag += ", NMI"
                if "FAILED" in flags:
                    tag += ", FAILED"
            f1.write(
                f"{frame_id} {t:.6f}{tag} "
                f"{twc[0]:.9f} {twc[1]:.9f} {twc[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )
            f2.write(f"{frame_id} {t:.6f}{tag}\n")
            if "NMI" in flags and prev:
                f2.write("//////////Previous Poses\\\\\\\\\\\n")
                for P in prev:
                    np.savetxt(f2, P, fmt="%.9f")
                f2.write("//////////Previous Poses End\\\\\\\\\\\n")
            Twc = np.linalg.inv(Tcw)
            np.savetxt(f2, Twc, fmt="%.9f")


def save_keyframe_trajectory_tum(path: str, kf_timestamps: np.ndarray, kf_Tcw: np.ndarray):
    """TUM format: `t x y z qx qy qz qw` per keyframe (System.cc:417)."""
    with open(path, "w") as f:
        for t, Tcw in zip(kf_timestamps, kf_Tcw):
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            q = _quat_wxyz(Rwc)
            f.write(
                f"{t:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def ate_rmse(est_Tcw: list, gt_Tcw: list, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over camera centers), optional SE3
    (Umeyama, scale-free) alignment — the standard TUM evaluation."""
    est = np.array([-T[:3, :3].T @ T[:3, 3] for T in est_Tcw])
    gt = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt_Tcw])
    assert est.shape == gt.shape and len(est) > 0
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = (U @ S @ Vt).T
        t = mu_g - R @ mu_e
        est = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
