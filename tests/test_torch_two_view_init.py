"""The port's two-view initialization against the JAX package's
(`tests/test_two_view_init.py`'s three scenes).

The JAX package draws each hypothesis's rows with `jax.random.choice` from
one key a hypothesis (the H draw and the F draw share it); the port takes
the rows as arguments, and these tests feed it the JAX package's draws
(`torch_port_fixtures.JaxDraws.draws` on the same key). Bars: the same
model choice and accept decision, equal inlier masks, Tcw2 within 1e-4
(measured 5e-6 to 4.7e-5: the SVDs of LAPACK and XLA differ in the last
bits, and the argmax over near-equal hypothesis scores can pick another
hypothesis of the same model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.solvers import two_view_init as ttv
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.solvers import two_view_init as jtv
from torch_port_fixtures import JaxDraws

TCW_ATOL = 1e-4
K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)


def project(T, pts):
    pc = pts @ T[:3, :3].T + T[:3, 3]
    return (pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)


def scene(case):
    """tests/test_two_view_init.py's scenes: a general scene (F), a plane
    (H), a general scene with 20 % outliers."""
    seed, n = {"general": (1, 150), "planar": (2, 150), "outliers": (3, 200)}[case]
    rng = np.random.default_rng(seed)
    z = np.full(n, 10.0) if case == "planar" else rng.uniform(5, 15, n)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), z], -1).astype(np.float32)
    xi = {"general": [0.8, 0.05, 0.1, 0.02, -0.04, 0.01], "planar": [0.6, 0, 0, 0, -0.03, 0],
          "outliers": [0.7, 0, 0, 0, 0.02, 0]}[case]
    T2 = np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))
    uv1, uv2 = project(np.eye(4, dtype=np.float32), pts), project(T2, pts)
    if case == "outliers":
        n_out = int(0.2 * n)
        uv2[:n_out] += np.random.default_rng(0).uniform(30, 60, (n_out, 2)).astype(np.float32)
    return uv1, uv2, T2


@pytest.mark.parametrize("case", ["general", "planar", "outliers"])
def test_two_view_matches_reference(case):
    uv1, uv2, T2 = scene(case)
    n = len(uv1)
    key = jax.random.PRNGKey(0)
    ref = jtv.initialize_two_view(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
                                  jnp.ones(n, bool))
    out = ttv.initialize_two_view(JaxDraws.draws(key, n, n, ttv.N_HYPOTHESES, 4),
                                  JaxDraws.draws(key, n, n, ttv.N_HYPOTHESES, 8), K,
                                  torch.from_numpy(uv1), torch.from_numpy(uv2),
                                  torch.ones(n, dtype=torch.bool))
    assert bool(out.ok) == bool(ref.ok)
    assert bool(out.used_homography) == bool(ref.used_homography) == (case == "planar")
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(out.Tcw2.numpy(), np.asarray(ref.Tcw2), atol=TCW_ATOL, rtol=0)
    if case != "planar":
        assert bool(out.ok)
        t_e = out.Tcw2[:3, 3].numpy() / np.linalg.norm(out.Tcw2[:3, 3].numpy())
        t_t = T2[:3, 3] / np.linalg.norm(T2[:3, 3])
        assert np.arccos(min(abs(float(t_e @ t_t)), 1.0)) < 0.05
    if case == "outliers":
        assert not out.inliers[:20].any()
