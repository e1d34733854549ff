"""Parity of orbslam2_nmi_torch.ops.histogram_nmi with the JAX package.

The same numpy inputs (seeded) go through the JAX functions and their ports.
The Pallas kernels run in interpret mode on the CPU, as the JAX package's own
tests run them; the port runs the plain versions of kernels B1 and B2 (its
wrappers take them for CPU tensors).

Tolerance: histograms are exact integer counts on both sides, so entropies
and scores differ only by the f32 rounding of the entropy sums. That is why
the bar is atol=1e-5, tighter than the reference's own 1e-3 (which covered
its earlier f32-accumulated one-hot sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch import kernel_cases
from orbslam2_nmi_torch.ops import histogram_nmi as th
from orbslam2_nmi_tpu.ops import histogram_nmi as jh

ATOL = 1e-5


def _bins(rng, n, p, zero_frac=0.0):
    b = rng.integers(0, 256, (n, p)).astype(np.int32)
    if zero_frac:
        b[:, : int(p * zero_frac)] = 0
    return b


@pytest.mark.parametrize("mask_zero", [False, True])
def test_joint_entropy_grid_matches_pallas_interpret(mask_zero):
    rng = np.random.default_rng(4)
    S, R, P = 3, 4, jh._JSUPER
    sb = _bins(rng, S, P, 1 / 3 if mask_zero else 0.0)
    wb = _bins(rng, R, P)
    if mask_zero:
        wb[:, P // 2 :] = 0
    ref = np.asarray(jh.joint_entropy_grid_pallas(
        jnp.asarray(sb), jnp.asarray(wb), P, interpret=True, mask_zero=mask_zero))
    out = th.joint_entropy_grid(
        torch.from_numpy(sb.astype(np.uint8)), torch.from_numpy(wb.astype(np.uint8)), P,
        mask_zero=mask_zero,
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def _exact_entropy(b, n):
    h = np.bincount(b, minlength=256) / n
    h = h[h > 0]
    return -(h * np.log2(h)).sum()


def test_marginal_entropy_grid_matches_pallas_interpret():
    """The Pallas marginal kernel reduces 128 replicated lane columns in f32
    and divides by 128; that alone puts its output up to 2.8e-5 off the exact
    (f64) entropy on these inputs. So the port is held to 1e-5 against the
    exact value and the JAX scatter-add oracle, and to 5e-5 against the
    Pallas kernel itself."""
    rng = np.random.default_rng(6)
    P = jh._CHUNK * 2
    b = _bins(rng, 3, P)
    b[1, : P // 2] = 7  # a skewed histogram too
    ref = np.asarray(jh.marginal_entropy_pallas(jnp.asarray(b), P, interpret=True))
    oracle = np.asarray(jnp.stack([jh.marginal_entropy(jnp.asarray(x), P) for x in b]))
    out = th.marginal_entropy_grid(torch.from_numpy(b.astype(np.uint8)), P).numpy()
    np.testing.assert_allclose(out, [_exact_entropy(x, P) for x in b], atol=ATOL)
    np.testing.assert_allclose(out, oracle, atol=ATOL)
    np.testing.assert_allclose(out, ref, atol=5e-5)


@pytest.mark.parametrize("S,R,P", [(3, 2, 3001), (2, 5, 6143)])
def test_marginal_entropy_sets_match_pallas_interpret(S, R, P):
    """The two-set form of B2 (renders, then warps, in one call) against the
    Pallas marginal kernel run on each set, with S != R and P not a multiple
    of 16. The Pallas kernel itself is 4.0e-5 (3001 pixels) and 2.8e-5 (6143)
    off the exact entropy here, for the reason given in the test above, so
    the port is held to 1e-5 against the exact value and the JAX scatter-add
    oracle (measured 4.4e-7 and 1.4e-6) and to 5e-5 against the Pallas
    kernel."""
    rng = np.random.default_rng(11)
    a, b = _bins(rng, S, P), _bins(rng, R, P)
    a[0, : P // 2] = 0  # a zero border
    b[-1, ::3] = 7  # a skewed histogram
    ref = np.concatenate([np.asarray(jh.marginal_entropy_pallas(
        jh.pad_pixels(jnp.asarray(x)), P, interpret=True)) for x in (a, b)])
    oracle = np.concatenate([np.asarray(jnp.stack([jh.marginal_entropy(jnp.asarray(r), P)
                                                   for r in x])) for x in (a, b)])
    out = th.marginal_entropy_sets(torch.from_numpy(a.astype(np.uint8)),
                                   torch.from_numpy(b.astype(np.uint8)), P)
    assert out.shape == (S + R,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), [_exact_entropy(x, P) for x in np.concatenate([a, b])],
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("case", kernel_cases.MARGINAL_CASES)
def test_marginal_cases_plain_is_exact(case):
    """On each adversarial input of B2 (kernel_cases.marginal_case), the plain
    version that the card's kernel is held against gives the exact (f64)
    entropy: 0 where an image is one gray, 8 where every bin is equally
    full."""
    for a, b in kernel_cases.marginal_case(case, "cpu"):
        P = a.shape[1]
        if b is None:
            out, rows = th.marginal_entropy_grid(a, P), a.numpy()
        else:
            out = th.marginal_entropy_sets(a, b, P)
            rows = np.concatenate([a.numpy(), b.numpy()])
        exact = [_exact_entropy(x, P) for x in rows]
        np.testing.assert_allclose(out.numpy(), exact, atol=ATOL)
        if case == "constant":
            np.testing.assert_array_equal(out.numpy(), 0.0)
        if case == "uniform":
            np.testing.assert_array_equal(out.numpy(), 8.0)


def test_reference_helpers_match():
    """The oracle helpers (scatter-add histograms, pads = -1) match their JAX
    counterparts, and so do quantize_to_bins and the two combiners."""
    rng = np.random.default_rng(8)
    P = 4096
    a = _bins(rng, 1, P)[0]
    b = _bins(rng, 1, P)[0]
    a[:100] = -1  # pads
    b[50:300] = 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        th.marginal_entropy(ta, P).numpy(), np.asarray(jh.marginal_entropy(jnp.asarray(a), P)),
        atol=ATOL)
    np.testing.assert_allclose(
        th.joint_entropy_reference(ta, tb, P).numpy(),
        np.asarray(jh.joint_entropy_reference(jnp.asarray(a), jnp.asarray(b), P)), atol=ATOL)
    for x, y in zip(th.masked_entropies_reference(ta, tb, P),
                    jh.masked_entropies_reference(jnp.asarray(a), jnp.asarray(b), P)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL)
    img = rng.uniform(-20, 300, (5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        th.quantize_to_bins(torch.from_numpy(img)).numpy(),
        np.asarray(jh.quantize_to_bins(jnp.asarray(img))))
    Ha, Hb = rng.uniform(1, 8, 3).astype(np.float32), rng.uniform(1, 8, 4).astype(np.float32)
    Hab = rng.uniform(1, 12, (3, 4)).astype(np.float32)
    for metric in ("SUC", "ENMI"):
        np.testing.assert_allclose(
            th._combine(*map(torch.from_numpy, (Ha, Hb, Hab)), metric).numpy(),
            np.asarray(jh._combine(*map(jnp.asarray, (Ha, Hb, Hab)), metric)), rtol=1e-6)
        np.testing.assert_allclose(
            th._combine_pairwise(*map(torch.from_numpy, (Hab, Hab, Hab)), metric).numpy(),
            np.asarray(jh._combine_pairwise(*map(jnp.asarray, (Hab, Hab, Hab)), metric)),
            rtol=1e-6)


@pytest.mark.parametrize("metric", ["SUC", "ENMI"])
@pytest.mark.parametrize("use_background", [True, False])
def test_nmi_scores_match_reference(metric, use_background):
    rng = np.random.default_rng(7)
    H, W = 32, 64
    base = rng.uniform(1, 255, (H, W)).astype(np.float32)
    synth = np.stack([base, np.roll(base, 3, 1), rng.uniform(0, 255, (H, W))]).astype(np.float32)
    synth[:, :, : W // 4] = 0.0  # partial coverage
    warped = np.stack([base, np.roll(base, -2, 0)]).astype(np.float32)
    ref = np.asarray(jh.nmi_scores(jnp.asarray(synth), jnp.asarray(warped), metric=metric,
                                   use_pallas=False, use_background=use_background))
    out = th.nmi_scores(torch.from_numpy(synth), torch.from_numpy(warped), metric=metric,
                        use_background=use_background)
    assert out.shape == (3, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert int(out.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("use_background", [True, False])
def test_nmi_scores_odd_pixel_count_match_reference(use_background):
    """nmi_scores with S != R and a pixel count that is not a multiple of 16
    (B2 takes both sets in one call) against the JAX nmi_scores."""
    rng = np.random.default_rng(12)
    H, W = 17, 31
    synth = rng.uniform(0, 255, (4, H, W)).astype(np.float32)
    synth[1:, :, :5] = 0.0
    warped = np.stack([synth[0], np.roll(synth[0], 2, 1), rng.uniform(0, 255, (H, W))])
    warped = warped.astype(np.float32)
    ref = np.asarray(jh.nmi_scores(jnp.asarray(synth), jnp.asarray(warped), use_pallas=False,
                                   use_background=use_background))
    out = th.nmi_scores(torch.from_numpy(synth), torch.from_numpy(warped),
                        use_background=use_background)
    assert out.shape == (4, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert int(out.argmax()) == int(ref.argmax())


def test_nmi_scores_reject_other_bin_counts():
    """The port scores over 256 bins only (the kernels count uint8 bins): it
    takes no bin count, and grays past 255 fall into the last bin, as in the
    reference at its default of 256 bins."""
    x = torch.zeros(1, 4, 4)
    with pytest.raises(TypeError):
        th.nmi_scores(x, x, n_bins=128)
    rng = np.random.default_rng(3)
    synth = rng.uniform(0, 400, (2, 8, 16)).astype(np.float32)
    warped = rng.uniform(0, 400, (3, 8, 16)).astype(np.float32)
    ref = np.asarray(jh.nmi_scores(jnp.asarray(synth), jnp.asarray(warped), use_pallas=False))
    out = th.nmi_scores(torch.from_numpy(synth), torch.from_numpy(warped)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """B1 (both epilogues) and B2 against their plain versions on the card."""
    rng = np.random.default_rng(9)
    P = 518400
    sb = torch.from_numpy(rng.integers(0, 256, (4, P)).astype(np.uint8)).to(cuda_device)
    wb = torch.from_numpy(rng.integers(0, 256, (5, P)).astype(np.uint8)).to(cuda_device)
    sb[:, : P // 4] = 0
    for mask_zero in (False, True):
        k = th.joint_entropy_grid(sb, wb, P, mask_zero=mask_zero)
        p = th.joint_entropy_grid_plain(sb, wb, P, mask_zero=mask_zero)
        torch.testing.assert_close(k, p, atol=ATOL, rtol=0)
    torch.testing.assert_close(th.marginal_entropy_grid(sb, P),
                               th.marginal_entropy_grid_plain(sb, P), atol=ATOL, rtol=0)
    torch.testing.assert_close(th.marginal_entropy_sets(sb, wb, P),
                               th.marginal_entropy_sets_plain(sb, wb, P), atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["constant", "zero_rows_cols", "odd_pixel_count",
                                  "unaligned_rows", "one_pair"])
@pytest.mark.parametrize("mask_zero", [False, True])
def test_joint_entropy_adversarial_on_card(cuda_device, case, mask_zero):
    """B1 against its plain version on kernel_cases.joint_cases: one bin
    holding every count, row 0 and column 0 holding most, P % 16 != 0,
    unaligned rows, S = R = 1."""
    sb, wb = {n: (a, b) for n, a, b in kernel_cases.joint_cases(cuda_device)}[case]
    P = sb.shape[1]
    torch.testing.assert_close(th.joint_entropy_grid(sb, wb, P, mask_zero=mask_zero),
                               th.joint_entropy_grid_plain(sb, wb, P, mask_zero=mask_zero),
                               atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", kernel_cases.MARGINAL_CASES)
def test_marginal_entropy_adversarial_on_card(cuda_device, case):
    """B2 against its plain version on each call of kernel_cases.marginal_case:
    one bin holding every count, every bin equally full, CTAs with empty
    shares, unaligned rows, 4K frames, S = 1 or R = 1, more clusters than one
    wave, one set, and two calls in a row."""
    for a, b in kernel_cases.marginal_case(case, cuda_device):
        assert kernel_cases.marginal_error(a, b) <= ATOL


@pytest.mark.gpu
def test_joint_entropy_kernel_refuses_too_many_pixels(cuda_device):
    """B1's spill table holds P / 2**14 bins, so the wrapper refuses P >= 2**25
    on the card rather than count wrongly."""
    big = torch.zeros(1, th.JOINT_MAX_PIXELS, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="fewer than"):
        th.joint_entropy_grid(big, big, th.JOINT_MAX_PIXELS)
