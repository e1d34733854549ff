"""The port's trajectory writers against the JAX package's
(`tests/test_trajectory.py`, `tests/test_tracking_unit.py`'s chained culls).

The map state is written by the JAX package as a checkpoint and loaded by
the port (`slam/checkpoint.py`: the same npz fields), so both recompose the
same rows over the same keyframes. Bars: recomposed rows and flags equal
(both are the same float32 numpy products, so exactly), the saved files equal
byte for byte (the quaternion goes through each package's `rot_to_quat` in
float32: measured equal), `ate_rmse` within 1e-9 with and without alignment.
"""

import numpy as np
import pytest

from orbslam2_nmi_torch.io import trajectory as ttraj
from orbslam2_nmi_torch.slam import checkpoint as tck
from orbslam2_nmi_torch.slam.map_store import MapStore as TMapStore
from orbslam2_nmi_tpu.config import CameraConfig, ORBConfig, SystemConfig, TrackingConfig
from orbslam2_nmi_tpu.io import trajectory as jtraj
from orbslam2_nmi_tpu.slam import checkpoint as jck
from orbslam2_nmi_tpu.slam.map_store import MapStore as JMapStore
from torch_port_fixtures import THREADS  # noqa: F401  (one torch thread a worker)

ATE_ATOL = 1e-9


def _se3(rot_z: float, t):
    c, s = np.cos(rot_z), np.sin(rot_z)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = t
    return T


def _jax_map(n_kf=6):
    """tests/test_trajectory.py's small map, with a spanning tree (each KF the
    child of the one before), NMI flags on KF 1 and a FAILED flag on KF 4."""
    cfg = SystemConfig(
        camera=CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320, height=240),
        orb=ORBConfig(n_features=16, n_levels=2),
        tracking=TrackingConfig(max_keyframes=8, max_map_points=64, max_features=16),
    )
    m = JMapStore(cfg)
    rng = np.random.default_rng(3)
    for i in range(n_kf):
        m.add_keyframe(_se3(0.1 * i, [float(i), 0.2 * i, 0.0]), i * 10, float(i),
                       np.zeros((16, 2), np.float32), np.zeros(16, np.int32),
                       np.zeros(16, np.float32),
                       rng.integers(0, 2**32, (16, 8), dtype=np.uint32), np.ones(16, bool))
        m.kf_parent[i] = i - 1
    m.kf_nmi_reloc[1] = True
    m.kf_nmi_failed[4] = True
    return cfg, m


def _rows(m):
    """Tracker rows relative to each keyframe, with lost rows and NMI
    previous poses (the `_twc` file's block)."""
    rng = np.random.default_rng(5)
    rows = []
    for k in range(m.n_keyframes):
        rows.append((10 * k, float(k), np.eye(4, dtype=np.float32), k, False,
                     [_se3(0.01, [0.1, 0, 0])] if k == 1 else []))
        for j in (1, 2):
            T = _se3(0.1 * k + 0.01 * j, [k + 0.1 * j, 0.2 * k, 0.05 * j]) \
                @ _se3(0, rng.normal(0, 0.01, 3))
            rows.append((10 * k + j, k + 0.1 * j,
                         (T @ np.linalg.inv(m.kf_Tcw[k])).astype(np.float32), k, False, []))
    rows.append((99, 9.9, rows[-1][2], rows[-1][3], True, []))  # a lost row
    return rows


@pytest.fixture
def maps(tmp_path):
    """(jax map, port map loaded from the JAX package's checkpoint, rows),
    after culling keyframes 3 then 2 (a chained cull) on the JAX side."""
    cfg, jm = _jax_map()
    rows = _rows(jm)
    jm.remove_keyframe(3)
    jm.remove_keyframe(2)
    path = str(tmp_path / "map.npz")
    jck.save_map(path, jm)
    tm = TMapStore(cfg)
    tck.load_map(path, tm)
    return jm, tm, rows


def test_recomposed_rows_equal_walking_culled_keyframes(maps):
    jm, tm, rows = maps
    j, t = jtraj.recompose_trajectory(rows, jm), ttraj.recompose_trajectory(rows, tm)
    assert len(t) == len(j) == len(rows) - 1  # the lost row is skipped
    for a, b in zip(t, j):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])
    flags = {r[0]: r[3] for r in t}
    assert flags[10] == ["KF", "NMI"] and flags[40] == ["KF", "FAILED"] and flags[11] == []
    # the frames of culled keyframes 2 and 3 still recompose to their poses
    for fid, T in [(r[0], r[2]) for r in t if r[0] // 10 in (2, 3)]:
        row = next(r for r in rows if r[0] == fid)
        k = row[3]
        expect = row[2] @ _se3(0.1 * k, [float(k), 0.2 * k, 0.0])
        np.testing.assert_allclose(T, expect, atol=1e-5)


def test_lost_rows_and_unreachable_refs_are_skipped(maps):
    jm, tm, rows = maps
    eye = np.eye(4, dtype=np.float32)
    extra = [(50, 5.0, eye, 1, True, []), (51, 5.1, eye, -1, False, [])]
    for m, mod in ((jm, jtraj), (tm, ttraj)):
        assert mod.recompose_trajectory(extra, m) == []


def test_files_identical(maps, tmp_path):
    jm, tm, rows = maps
    jtraj.save_full_trajectory(str(tmp_path / "j"), rows, jm)
    ttraj.save_full_trajectory(str(tmp_path / "t"), rows, tm)
    for suffix in (".txt", "_twc.txt"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    kfs = tm.valid_keyframe_indices()
    jtraj.save_keyframe_trajectory_tum(str(tmp_path / "jk"), jm.kf_timestamp[kfs], jm.kf_Tcw[kfs])
    ttraj.save_keyframe_trajectory_tum(str(tmp_path / "tk"), tm.kf_timestamp[kfs], tm.kf_Tcw[kfs])
    assert (tmp_path / "tk").read_bytes() == (tmp_path / "jk").read_bytes()
    assert "Previous Poses" in (tmp_path / "t_twc.txt").read_text()


@pytest.mark.parametrize("align", [False, True])
def test_ate_rmse_matches_reference(align):
    rng = np.random.default_rng(0)
    gt = [_se3(rng.uniform(-1, 1), rng.normal(0, 2, 3)) for _ in range(12)]
    est = [(_se3(0.02, [0.1, -0.2, 0.05]) @ T @ _se3(0, rng.normal(0, 0.02, 3))).astype(np.float32)
           for T in gt]
    a, b = ttraj.ate_rmse(est, gt, align=align), jtraj.ate_rmse(est, gt, align=align)
    assert abs(a - b) <= ATE_ATOL and a > 0


def test_quaternions_match_reference():
    """Both packages take the quaternion in float32 by the same branchless
    Shepperd's method; XLA's arithmetic order differs from torch's in the
    last bit: on 300 random rotations 48 quaternions differ by one float32
    ulp (max 6e-8), which the 9-decimal rows of SaveFullTrajectory can show.
    The map of these tests writes identical files."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from orbslam2_nmi_tpu.geometry import se3 as jse3

    rng = np.random.default_rng(1)
    for _ in range(300):
        R = Rotation.from_rotvec(rng.normal(0, 1.5, 3)).as_matrix().astype(np.float32)
        q_t = ttraj._quat_wxyz(R)
        q_j = np.asarray(jse3.rot_to_quat(jnp.asarray(R[None]))[0])
        np.testing.assert_allclose(q_t, q_j, atol=1.2e-7, rtol=0)
