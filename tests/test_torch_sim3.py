"""The port's Sim(3) solvers (`solvers/sim3.py`) against the JAX package's, on
the CPU, on tests/test_place_recognition.py's similarity scene (80 matches,
15 outliers) and on a padded copy of it.

The port takes the RANSAC samples as an argument; the tests feed it the
JAX package's own draws (`torch_port_fixtures.JaxDraws`), so both solve the
same 128 hypotheses.

Bars, measured on these inputs:
  * `horn_sim3`: the rotation (never the quaternion, whose sign is free), the
    translation and the scale within 1e-5 (measured 3.8e-6 over 16 samples
    of 3-18 points);
  * `sim3_ransac`: the same best hypothesis, so S12 within 1e-5 (measured
    3.2e-6, and 1.3e-6 padded), the same inlier count, and inlier masks equal
    except on rows whose chi2 lies within 1e-3 of the 9.21 threshold
    (measured: equal);
  * `optimize_sim3` from a perturbed start: S12 within 1e-5 (measured
    1.2e-7), inliers equal.
On the card (the `gpu` marker), the same calls against the CPU's within
3e-6, the gaps recorded as junit properties (NVIDIA H100 80GB HBM3, 700.00 W:
9.5e-7 for the RANSAC's S12, 3.6e-7 for the optimized one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import JaxDraws, cuda_device  # noqa: F401

from orbslam2_nmi_torch.solvers import sim3 as ts
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.solvers import sim3 as js

ATOL = 1e-5
TIE = 1e-3
CARD_S12 = 3e-6  # the card against the CPU (H100: 9.5e-7 RANSAC, 3.6e-7 optimized)


def _scene(pad=0):
    rng = np.random.default_rng(7)
    n = 80
    p2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(5, 10, n)],
                  -1).astype(np.float32)
    R_true = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.1, 0.08], jnp.float32)))
    s_true, t_true = 1.4, np.array([0.4, -0.2, 0.6], np.float32)
    p1 = (s_true * (p2 @ R_true.T) + t_true).astype(np.float32)
    p1[:15] += rng.uniform(1, 3, (15, 3)).astype(np.float32)

    def proj(p):
        return (p[:, :2] / p[:, 2:3] * 400.0 + [320.0, 240.0]).astype(np.float32)

    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    octave = rng.integers(0, 3, (2, n))
    inv_s2 = (1.0 / 1.2 ** (2 * octave)).astype(np.float32)
    arrays = [p1, p2, proj(p1), proj(p2), inv_s2[0], inv_s2[1], np.ones(n, bool)]
    if pad:
        arrays = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrays]
    return K, arrays, (R_true, t_true, s_true)


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _chi2(K, S12, arrays):
    p1, p2, uv1, uv2, i1, i2, _ = arrays
    sR, t = S12[:3, :3].astype(np.float64), S12[:3, 3].astype(np.float64)
    s = np.linalg.norm(sR[:, 0])

    def proj(p):
        return np.stack([K[0, 0] * p[:, 0] / p[:, 2] + K[0, 2], K[1, 1] * p[:, 1] / p[:, 2]
                         + K[1, 2]], -1)

    e1 = ((proj(p2 @ sR.T + t) - uv1) ** 2).sum(-1) * i1
    e2 = ((proj((p1 - t) @ sR / s ** 2) - uv2) ** 2).sum(-1) * i2
    return e1, e2


def test_horn_sim3_matches_reference():
    K, arrays, _ = _scene()
    p1, p2 = arrays[:2]
    rng = np.random.default_rng(1)
    w = np.zeros((16, len(p1)), np.float32)
    for h in range(16):
        w[h, rng.choice(len(p1), 3 + h, replace=False)] = 1.0
    R, t, s = ts.horn_sim3(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(w))
    for h in range(16):
        Rj, tj, sj = js.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w[h]))
        np.testing.assert_allclose(R[h].numpy(), np.asarray(Rj), atol=ATOL, rtol=0)
        np.testing.assert_allclose(t[h].numpy(), np.asarray(tj), atol=ATOL, rtol=0)
        assert abs(float(s[h]) - float(sj)) < ATOL


@pytest.mark.parametrize("pad", [0, 48])
def test_sim3_ransac_with_reference_draws(pad):
    K, arrays, (R_true, t_true, s_true) = _scene(pad)
    n = len(arrays[0])
    key = jax.random.PRNGKey(1)
    draws = JaxDraws.draws(key, n, n - pad, 128, 3)
    ref = js.sim3_ransac(key, jnp.asarray(K), *map(jnp.asarray, arrays))
    out = ts.sim3_ransac(torch.from_numpy(draws), K, *_torch(arrays))
    S_ref = np.asarray(ref.S12)
    np.testing.assert_allclose(out.S12.numpy(), S_ref, atol=ATOL, rtol=0)
    assert int(out.n_inliers) == int(ref.n_inliers) and bool(out.ok) == bool(ref.ok)
    diff = out.inliers.numpy() != np.asarray(ref.inliers)
    if diff.any():
        e1, e2 = _chi2(K, S_ref, arrays)
        assert np.all(np.minimum(abs(e1 - 9.21), abs(e2 - 9.21))[diff] < TIE)
    # the reference test's bars on the truth
    assert bool(out.ok) and abs(float(out.scale) - s_true) < 0.05
    np.testing.assert_allclose(out.S12.numpy()[:3, :3] / float(out.scale), R_true, atol=5e-3)
    np.testing.assert_allclose(out.S12.numpy()[:3, 3], t_true, atol=5e-2)


def test_optimize_sim3_matches_reference():
    K, arrays, _ = _scene(pad=48)
    key = jax.random.PRNGKey(1)
    S0 = np.asarray(js.sim3_ransac(key, jnp.asarray(K), *map(jnp.asarray, arrays)).S12)
    S0 = S0 @ np.asarray(jse3.sim3_exp(jnp.asarray([0.05, -0.03, 0.02, 0.01, 0.0, -0.01, 0.02],
                                                   jnp.float32)))  # start it off
    ref = js.optimize_sim3(jnp.asarray(K), jnp.asarray(S0), *map(jnp.asarray, arrays))
    out = ts.optimize_sim3(K, torch.from_numpy(S0), *_torch(arrays))
    np.testing.assert_allclose(out.S12.numpy(), np.asarray(ref.S12), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers)


@pytest.mark.gpu
def test_sim3_card_against_cpu(cuda_device, record_property):  # noqa: F811
    K, arrays, _ = _scene(pad=48)
    n = len(arrays[0])
    draws = torch.from_numpy(JaxDraws.draws(jax.random.PRNGKey(1), n, n - 48, 128, 3))
    cpu = ts.sim3_ransac(draws, K, *_torch(arrays))
    card = ts.sim3_ransac(draws.to(cuda_device), K, *_torch(arrays, cuda_device))
    g_r = float((card.S12.cpu() - cpu.S12).abs().max())
    o_cpu = ts.optimize_sim3(K, cpu.S12, *_torch(arrays))
    o_card = ts.optimize_sim3(K, cpu.S12.to(cuda_device), *_torch(arrays, cuda_device))
    g_o = float((o_card.S12.cpu() - o_cpu.S12).abs().max())
    record_property("ransac_S12_gap", g_r)
    record_property("optimize_S12_gap", g_o)
    assert int(card.n_inliers) == int(cpu.n_inliers)
    assert int(o_card.n_inliers) == int(o_cpu.n_inliers)
    assert g_r <= CARD_S12 and g_o <= CARD_S12, (g_r, g_o)
