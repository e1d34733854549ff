"""The port's SO(3)/SE(3) functions against the JAX package's, float32 on the
CPU, on seeded batches that include near-identity and near-pi rotations.

Bar: 1e-6 absolute, the float32 rounding of the same formulas in another
operation order (measured: at most 4.8e-7, and 9.5e-7 on the log's
translation, which divides by V).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.geometry import se3 as tse3
from orbslam2_nmi_tpu.geometry import se3 as jse3

ATOL = 1e-6


def _axis_angles(seed, n=64):
    """[n, 3] rotation vectors: generic, near identity (|w| ~ 1e-6..1e-3) and
    near pi (pi - 1e-4 .. pi - 1e-2, where the log takes its diagonal branch
    below sin 1e-5), each along random axes."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0.0, 3.0, n - 24),
        10.0 ** rng.uniform(-6, -3, 12),
        np.pi - 10.0 ** rng.uniform(-5.5, -2, 12),
    ])
    return (axes * angles[:, None]).astype(np.float32)


def _tangents(seed, n=64):
    rng = np.random.default_rng(seed + 100)
    rho = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    return np.concatenate([rho, _axis_angles(seed, n)], axis=1)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_log_matches_reference(seed):
    R = np.array(jse3.so3_exp(jnp.asarray(_axis_angles(seed))))
    _close(tse3.so3_log(torch.from_numpy(R)), jse3.so3_log(jnp.asarray(R)))
    _close(tse3.so3_log(torch.from_numpy(R[3])), jse3.so3_log(jnp.asarray(R[3])))  # unbatched


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternions_match_reference(seed):
    R = np.array(jse3.so3_exp(jnp.asarray(_axis_angles(seed))))
    q_t = tse3.rot_to_quat(torch.from_numpy(R))
    _close(q_t, jse3.rot_to_quat(jnp.asarray(R)))
    q = np.random.default_rng(seed).normal(size=(64, 4)).astype(np.float32)
    _close(tse3.quat_to_rot(torch.from_numpy(q)), jse3.quat_to_rot(jnp.asarray(q)))
    q2 = np.random.default_rng(seed + 7).normal(size=(64, 4)).astype(np.float32)
    _close(tse3.quat_mul(torch.from_numpy(q), torch.from_numpy(q2)),
           jse3.quat_mul(jnp.asarray(q), jnp.asarray(q2)))
    # round trip through the port alone
    _close(tse3.quat_to_rot(q_t), R)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_log_match_reference(seed):
    xi = _tangents(seed)
    T_t = tse3.se3_exp(torch.from_numpy(xi))
    _close(T_t, jse3.se3_exp(jnp.asarray(xi)))
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    # the log's translation divides by V, whose conditioning grows near pi:
    # compare it at 1e-6 relative to the translation's size
    log_t = tse3.se3_log(torch.from_numpy(T)).numpy()
    log_j = np.asarray(jse3.se3_log(jnp.asarray(T)))
    np.testing.assert_allclose(log_t[:, 3:], log_j[:, 3:], atol=ATOL, rtol=0)
    scale = np.maximum(1.0, np.abs(log_j[:, :3]).max(axis=1, keepdims=True))
    np.testing.assert_allclose(log_t[:, :3] / scale, log_j[:, :3] / scale, atol=ATOL, rtol=0)


def test_mm_is_plain_float32():
    """`mm` and `mv` are the matrix products of the pose math: equal to a
    float64 product rounded to float32 within float32 rounding."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 4, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4, 4)).astype(np.float32)
    v = rng.normal(size=(5, 4)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(tse3.mm(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref,
                               atol=2e-6, rtol=0)
    refv = np.einsum("nij,nj->ni", a.astype(np.float64), v.astype(np.float64))
    np.testing.assert_allclose(tse3.mv(torch.from_numpy(a), torch.from_numpy(v)).numpy(), refv,
                               atol=2e-6, rtol=0)


def test_camera_model_matches_reference():
    """geometry/camera.py: projection, unprojection, distortion and the
    iterative undistortion, and the undistorted image bounds, within 1e-6
    relative to the values' scale, for float32 rounding in another order
    (measured: equal)."""
    from orbslam2_nmi_torch.geometry import camera as tcam
    from orbslam2_nmi_tpu.geometry import camera as jcam

    rng = np.random.default_rng(4)
    K = np.array([[435.0, 0, 475.5], [0, 435.0, 274.7], [0, 0, 1]], np.float32)
    dist = np.array([-0.05, 0.01, 1e-3, -2e-3, 0.002], np.float32)
    pc = np.stack([rng.uniform(-5, 5, 64), rng.uniform(-3, 3, 64), rng.uniform(2, 30, 64)],
                  1).astype(np.float32)
    uv = np.stack([rng.uniform(0, 960, 64), rng.uniform(0, 540, 64)], 1).astype(np.float32)
    depth = rng.uniform(2, 30, 64).astype(np.float32)
    Kt, Kj = torch.from_numpy(K), jnp.asarray(K)
    pairs = [
        (tcam.project(Kt, torch.from_numpy(pc)), jcam.project(Kj, jnp.asarray(pc))),
        (tcam.unproject(Kt, torch.from_numpy(uv), torch.from_numpy(depth)),
         jcam.unproject(Kj, jnp.asarray(uv), jnp.asarray(depth))),
        (tcam.distort_normalized(torch.from_numpy(uv / 1000), torch.from_numpy(dist)),
         jcam.distort_normalized(jnp.asarray(uv / 1000), jnp.asarray(dist))),
        (tcam.undistort_points(Kt, torch.from_numpy(dist), torch.from_numpy(uv)),
         jcam.undistort_points(Kj, jnp.asarray(dist), jnp.asarray(uv))),
    ]
    for t, j in pairs:
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6 * max(1.0, np.abs(j).max()), rtol=0)
    for d in (dist, np.zeros(5, np.float32)):
        np.testing.assert_allclose(tcam.compute_image_bounds(K, d, 960, 540),
                                   jcam.compute_image_bounds(K, d, 960, 540), atol=1e-3, rtol=0)
