"""The port's PnP (`solvers/pnp.py`) against the JAX package's, on the CPU, on
tests/test_place_recognition.py's PnP scenes: EPnP's 6-point minimal case,
and RANSAC with 25 % and 35 % outliers. The port takes the RANSAC samples as
an argument; the tests feed it the JAX package's own draws
(`torch_port_fixtures.JaxDraws`).

Bars, measured on these inputs:
  * `epnp_pose` on the clean 6-point sample: Tcw within 1e-4 of the
    reference's (measured 1.7e-5: the 12x12 eigenvectors and the beta
    solves round differently) and every point within 0.5 px (the reference
    test's bar; measured 1.9e-4 px); a batch of samples equals the single
    solves;
  * `_dlt_pose`: Tcw within 1e-5 (measured 1.9e-6);
  * `pnp_ransac` with the reference's draws: the polished Tcw within 1e-5
    (measured 6.9e-7 and 1.2e-6) and the inlier masks equal. The hypotheses themselves
    may differ: with 4 points M^T M has a 4-dimensional null space, whose
    basis `eigh` picks freely, and EPnP's cases use its first vectors (27 of
    128 hypotheses counted other inliers than the reference's); the vote and
    the polish agree.
A hypothesis that samples a point far enough to overflow counts no inlier,
and RANSAC's outcome with such hypotheses equals the reference's; with a
point at inf or NaN neither package returns a pose.
On the card (the `gpu` marker), `pnp_ransac` against the CPU's within 3e-6
with the same inlier count, the gap recorded as a junit property (NVIDIA
H100 80GB HBM3, 700.00 W: 4.8e-7), and without an error on hypotheses that
overflow, where CUDA's `eigh` raises on the unmasked batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import JaxDraws, cuda_device  # noqa: F401

from orbslam2_nmi_torch.solvers import pnp as tp
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.solvers import pnp as jp

T_ATOL = 1e-5
CARD_ATOL = 3e-6  # the card against the CPU (H100: 4.8e-7)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _minimal_scene():
    rng = np.random.default_rng(11)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.15], jnp.float32)))
    t = np.array([0.3, -0.2, 0.5], np.float32)
    pw = rng.uniform(-2, 2, (24, 3)).astype(np.float32)
    pw[:, 2] += 6.0
    pc = pw @ R.T + t
    uv = np.stack([300.0 * pc[:, 0] / pc[:, 2] + 160.0, 300.0 * pc[:, 1] / pc[:, 2] + 120.0],
                  -1).astype(np.float32)
    w = np.zeros(24, np.float32)
    w[[0, 5, 11, 17, 20, 23]] = 1.0
    return K, pw, uv, w


def _ransac_scene(which):
    """(K, pw, uv, n_outliers, T_true) of test_epnp_ransac_with_outliers
    ("epnp") or test_pnp_ransac_with_outliers ("pnp")."""
    if which == "epnp":
        rng = np.random.default_rng(12)
        K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
        R = np.asarray(jse3.so3_exp(jnp.asarray([-0.05, 0.12, 0.04], jnp.float32)))
        t = np.array([0.1, 0.25, -0.3], np.float32)
        n = 80
        pw = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        pw[:, 2] += 8.0
        pc = pw @ R.T + t
        uv = np.stack([300.0 * pc[:, 0] / pc[:, 2] + 160.0, 300.0 * pc[:, 1] / pc[:, 2] + 120.0],
                      -1).astype(np.float32)
        uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
        n_out = int(0.35 * n)
        uv[:n_out] = rng.uniform(0, 320, (n_out, 2)).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        return K, pw, uv, n_out, T
    rng = np.random.default_rng(6)
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    n = 120
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 12, n)],
                  -1).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.2, -0.1, 0.3, 0.05, -0.03, 0.08], jnp.float32)))
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3] * 400.0 + [320.0, 240.0]
    uv[:30] += rng.uniform(40, 90, (30, 2))
    return K, pw, uv.astype(np.float32), 30, T


def test_epnp_minimal_case_exact():
    K, pw, uv, w = _minimal_scene()
    T = tp.epnp_pose(K, *_t(pw, uv, w)).numpy()
    ref = np.asarray(jp.epnp_pose(jnp.asarray(K), jnp.asarray(pw), jnp.asarray(uv),
                                  jnp.asarray(w)))
    np.testing.assert_allclose(T, ref, atol=1e-4, rtol=0)
    err = tp._reproj_err2(K, *_t(T, pw, uv)).numpy()
    assert np.sqrt(err.max()) < 0.5, np.sqrt(err.max())
    batch = tp.epnp_pose(K, *_t(pw, uv, np.stack([w[::-1], w]))).numpy()
    np.testing.assert_array_equal(batch[1], T)


def test_dlt_pose_matches_reference():
    K, pw, uv, w = _minimal_scene()
    T = tp._dlt_pose(K, *_t(pw, uv, w)).numpy()
    ref = np.asarray(jp._dlt_pose(jnp.asarray(K), jnp.asarray(pw), jnp.asarray(uv),
                                  jnp.asarray(w)))
    np.testing.assert_allclose(T, ref, atol=T_ATOL, rtol=0)


@pytest.mark.parametrize("which", ["epnp", "pnp"])
def test_pnp_ransac_with_reference_draws(which):
    K, pw, uv, n_out, T_true = _ransac_scene(which)
    n = len(pw)
    key = jax.random.PRNGKey(0)
    draws = JaxDraws.draws(key, n, n, 128, 4)
    ref = jp.pnp_ransac(key, jnp.asarray(K), jnp.asarray(pw), jnp.asarray(uv), jnp.ones(n),
                        jnp.ones(n, bool))
    out = tp.pnp_ransac(torch.from_numpy(draws), K, *_t(pw, uv, np.ones(n, np.float32),
                                                        np.ones(n, bool)))
    np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(ref.Tcw), atol=T_ATOL, rtol=0)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert bool(out.ok) and int(out.n_inliers) == int(ref.n_inliers)
    assert not out.inliers.numpy()[:n_out].any()
    d = np.asarray(jse3.se3_log(jnp.asarray(np.linalg.inv(T_true) @ out.Tcw.numpy())))
    assert np.linalg.norm(d[:3]) < 0.05 and np.linalg.norm(d[3:]) < 0.01


def _ransac_with_a_far_point(device="cpu", far=1e30):
    """The "epnp" scene with point 40 moved to `far` m: in the JAX package
    every hypothesis that samples it overflows to NaN."""
    K, pw, uv, _, _ = _ransac_scene("epnp")
    pw = pw.copy()
    pw[40] = far
    n = len(pw)
    key = jax.random.PRNGKey(0)
    draws = JaxDraws.draws(key, n, n, 128, 4)
    out = tp.pnp_ransac(torch.from_numpy(draws).to(device), K,
                        *_t(pw, uv, np.ones(n, np.float32), np.ones(n, bool), device=device))
    return key, K, pw, uv, draws, out


@pytest.mark.parametrize("far", [1e30, 1e20])
def test_non_finite_hypothesis_counts_no_inlier(far):
    """RANSAC with hypotheses that sample a point at 1e30 or 1e20 m (whose
    square overflows float32): they count no inlier, and the vote and the
    polish give the JAX package's pose and inliers on the same draws (the
    JAX package's `eigh` returns NaN there)."""
    key, K, pw, uv, draws, out = _ransac_with_a_far_point(far=far)
    n = len(pw)
    assert (draws == 40).any(-1).sum() > 0
    ref = jp.pnp_ransac(key, jnp.asarray(K), jnp.asarray(pw), jnp.asarray(uv), jnp.ones(n),
                        jnp.ones(n, bool))
    assert bool(out.ok) and int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(ref.Tcw), atol=T_ATOL, rtol=0)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert not out.inliers.numpy()[40]


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
def test_non_finite_point_gives_no_pose(value):
    """RANSAC with one point at inf or NaN (ROADMAP C7): the JAX package's
    weighted sums multiply it by zero weights (inf * 0 is NaN), so every
    hypothesis is NaN and its RANSAC returns no pose; the port returns the
    same on the same draws: 0 inliers, `ok` false, a NaN pose."""
    key, K, pw, uv, _, out = _ransac_with_a_far_point(far=value)
    n = len(pw)
    ref = jp.pnp_ransac(key, jnp.asarray(K), jnp.asarray(pw), jnp.asarray(uv), jnp.ones(n),
                        jnp.ones(n, bool))
    assert int(ref.n_inliers) == 0 and not bool(ref.ok)
    assert int(out.n_inliers) == 0 and not bool(out.ok)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert np.isnan(out.Tcw.numpy()).any() and np.isnan(np.asarray(ref.Tcw)).any()


def test_eigen_solves_survive_what_cuda_refused(monkeypatch):
    """ROADMAP C9: CUDA's batched `eigh` raised on one EPnP hypothesis of a
    relocalization's batch. A hypothesis whose normal matrix overflows
    float32 is returned as NaN beside the others' unchanged poses (the
    reference's eigen-solve gives NaN there), and a batch whose eigen-solve
    fails to converge is solved again in float64, within the minimal case's
    bar of its float32 pose."""
    K, pw, uv, w = _minimal_scene()
    W = np.stack([w, w[::-1]])
    T = tp.epnp_pose(K, *_t(pw, uv, W))
    gram = tp._gram64

    def overflowing(x):  # the first hypothesis's normal matrix overflows
        g = gram(x)
        g[0, 3, 3] = float("inf")
        return g

    monkeypatch.setattr(tp, "_gram64", overflowing)
    T_bad = tp.epnp_pose(K, *_t(pw, uv, W))
    assert torch.isnan(T_bad[0]).all() and torch.equal(T_bad[1], T[1])
    monkeypatch.setattr(tp, "_gram64", gram)

    eigh = torch.linalg.eigh

    def refusing(M, *args, **kw):  # a failure to converge, on every float32 batch
        if M.dtype == torch.float32:
            raise torch.linalg.LinAlgError("linalg.eigh: failed to converge")
        return eigh(M, *args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", refusing)
    T64 = tp.epnp_pose(K, *_t(pw, uv, W))
    assert T64.dtype == torch.float32
    np.testing.assert_allclose(T64.numpy(), T.numpy(), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_non_finite_hypothesis_on_card(cuda_device):  # noqa: F811
    """The same RANSAC on the card: no error, the CPU's inliers. Without the
    mask CUDA's batched `eigh` raises on one non-finite matrix of the batch
    (the failure of ROADMAP C5; on finite matrices up to 3e38 it returns)."""
    g = torch.Generator().manual_seed(0)
    torch.randn(128, 3, 3, generator=g)
    a = torch.randn(128, 12, 12, generator=g)
    A = (a @ a.transpose(1, 2)).to(cuda_device)
    for value in (float("inf"), float("nan"), 3e38):
        B = A.clone()
        B[114, 0, 0] = B[114, 1, 0] = B[114, 0, 1] = value
        if value == 3e38:
            torch.linalg.eigh(B)
        else:
            with pytest.raises(torch.linalg.LinAlgError):
                torch.linalg.eigh(B)
    *_, cpu = _ransac_with_a_far_point()
    *_, card = _ransac_with_a_far_point(cuda_device)
    assert bool(card.ok) and int(card.n_inliers) == int(cpu.n_inliers)
    np.testing.assert_array_equal(card.inliers.cpu().numpy(), cpu.inliers.numpy())


@pytest.mark.gpu
def test_pnp_card_against_cpu(cuda_device, record_property):  # noqa: F811
    K, pw, uv, _, _ = _ransac_scene("epnp")
    n = len(pw)
    draws = JaxDraws.draws(jax.random.PRNGKey(0), n, n, 128, 4)
    args = (pw, uv, np.ones(n, np.float32), np.ones(n, bool))
    cpu = tp.pnp_ransac(torch.from_numpy(draws), K, *_t(*args))
    card = tp.pnp_ransac(torch.from_numpy(draws).to(cuda_device), K,
                         *_t(*args, device=cuda_device))
    gap = float((card.Tcw.cpu() - cpu.Tcw).abs().max())
    record_property("pnp_Tcw_gap", gap)
    assert int(card.n_inliers) == int(cpu.n_inliers)
    assert gap <= CARD_ATOL, gap
