"""The port's pose-only optimization against the JAX package's, on the CPU.

The cases of tests/test_pose_gn.py (noiseless from identity, outliers from a
perturbed pose, a valid mask over garbage observations, octave weights),
each through both packages on the same inputs. Bars:
  * Tcw within 1e-5 (measured max 9.7e-7, the outlier case: the solves
    factor opposite triangles and the sums run in another order);
  * the inlier sets identical, except edges whose final chi2 lies within
    1e-4 of 5.991 (where a rounding can cross the gate): counted and held
    to zero on these inputs (measured: none);
  * the per-edge chi2 within 1e-5 relative plus 1e-3 absolute (measured
    0.094 absolute, 5.3e-7 relative, on the masked garbage edges of chi2
    ~1.8e5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch.geometry import se3 as tse3
from orbslam2_nmi_torch.solvers import pose_gn as tgn
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.solvers import pose_gn as jgn

K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
TCW_ATOL = 1e-5
GATE_BAND = 1e-4
CHI2_RTOL, CHI2_ATOL = 1e-5, 1e-3


def make_scene(n=200, seed=0, noise=0.0, outlier_frac=0.0):
    """tests/test_pose_gn.py's scene: points 4-12 m ahead, a true pose, and
    their (noisy, partly corrupted) projections."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)],
                   axis=-1).astype(np.float32)
    T_true = np.array(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.02, 0.05],
                                               jnp.float32)))
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + rng.normal(0, noise, uv.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        uv[:n_out] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return pts, uv.astype(np.float32), T_true


def _case(name):
    eye = np.eye(4, dtype=np.float32)
    if name == "noiseless":
        pts, uv, T = make_scene()
        return pts, uv, T, eye, np.ones(len(pts), np.float32), np.ones(len(pts), bool)
    if name == "outliers":
        pts, uv, T = make_scene(noise=0.5, outlier_frac=0.25, seed=1)
        T0 = np.array(jse3.se3_exp(jnp.asarray([0.05, 0.0, 0.15, 0.02, -0.01, 0.03],
                                               jnp.float32)))
        return pts, uv, T, T0, np.ones(len(pts), np.float32), np.ones(len(pts), bool)
    if name == "valid_mask":
        pts, uv, T = make_scene(seed=2)
        uv[150:] = 0.0  # garbage observations, masked out
        valid = np.arange(len(pts)) < 150
        return pts, uv, T, eye, np.ones(len(pts), np.float32), valid
    pts, uv, T = make_scene(noise=1.0, seed=3)  # octave weights
    inv_sigma2 = np.ones(len(pts), np.float32)
    inv_sigma2[::2] = 1.0 / 1.2**2
    return pts, uv, T, eye, inv_sigma2, np.ones(len(pts), bool)


def _run_both(name, device="cpu"):
    pts, uv, T_true, T0, inv_sigma2, valid = _case(name)
    j = jgn.pose_optimization_jit(jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts),
                                  jnp.asarray(uv), jnp.asarray(inv_sigma2), jnp.asarray(valid))
    t = tgn.pose_optimization_k(K, *(torch.from_numpy(a).to(device)
                                     for a in (T0, pts, uv, inv_sigma2, valid)))
    return t, j, T_true


@pytest.mark.parametrize("name", ["noiseless", "outliers", "valid_mask", "octave_weights"])
def test_pose_optimization_matches_reference(name):
    t, j, T_true = _run_both(name)
    np.testing.assert_allclose(t.Tcw.numpy(), np.asarray(j.Tcw), atol=TCW_ATOL, rtol=0)
    chi2_j = np.asarray(j.chi2)
    np.testing.assert_allclose(t.chi2.numpy(), chi2_j, atol=CHI2_ATOL, rtol=CHI2_RTOL)
    differ = t.inliers.numpy() != np.asarray(j.inliers)
    near_gate = np.abs(chi2_j - tgn.CHI2_MONO) < GATE_BAND
    assert not (differ & ~near_gate).any()
    assert differ.sum() == 0  # measured: no edge near the gate on these inputs
    assert int(t.n_inliers) == int(j.n_inliers) and t.n_inliers.dtype == torch.int32
    # and the reference test's own accuracy bars, through the port
    err = tse3.se3_log(torch.from_numpy(np.linalg.inv(T_true).astype(np.float32)) @ t.Tcw)
    if name == "outliers":
        assert err[:3].abs().max() < 0.02 and err[3:].abs().max() < 0.005
        assert not t.inliers[:50].any()
    elif name == "octave_weights":
        assert err[:3].abs().max() < 0.03
    else:
        assert err.abs().max() < 1e-3
    if name == "valid_mask":
        assert not t.inliers[150:].any()


@pytest.mark.gpu
def test_pose_optimization_on_card_matches_cpu(cuda_device, record_property):
    """The solve on the card against the CPU, and with TF32 turned on: the
    pose math is elementwise float32, so TF32 changes nothing. Bar just above
    what an H100 measured (80GB HBM3, 700 W): Tcw 4.8e-7 apart."""
    gaps = []
    for name in ("noiseless", "outliers", "valid_mask", "octave_weights"):
        c, _, _ = _run_both(name, cuda_device)
        h, _, _ = _run_both(name)
        gaps.append(float((c.Tcw.cpu() - h.Tcw).abs().max()))
        assert torch.equal(c.inliers.cpu(), h.inliers)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            c32, _, _ = _run_both(name, cuda_device)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        assert float((c32.Tcw - c.Tcw).abs().max()) <= 1e-6
    record_property("tcw_gap", max(gaps))
    assert max(gaps) <= 1e-6
