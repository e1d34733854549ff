"""The port's descriptor matching against the JAX package's, on the CPU.

Everything here is integer arithmetic or comparisons of equal float32
values, so every bar is exact: Hamming distances (held against a naive
popcount too), match indices and distances with ties, spatial masks, the
ratio test and the rotation check, the window mask, and the epipolar and
fuse batches. The descriptor sets are tie-heavy on purpose: a few base codes
with 0-2 bits flipped, so many distances are equal and the first-minimum
rule of `argmin` decides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch.ops import matching as tm
from orbslam2_nmi_tpu.ops import matching as jm


def rand_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def tied_desc(rng, n, base):
    """n descriptors drawn from `base` with 0-2 random bits flipped."""
    return flipped(rng, base[rng.integers(0, len(base), n)])


def flipped(rng, desc):
    """A copy of `desc` with 0-2 random bits of each row flipped."""
    out = desc.copy()
    for row in out:
        for bit in rng.integers(0, 256, rng.integers(0, 3)):
            row[bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    return out


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _both(fn_t, fn_j, *arrays, **kw):
    """Run the port and the reference on the same numpy inputs."""
    t = fn_t(*[_i32(a) if a.dtype == np.uint32 else torch.from_numpy(a) for a in arrays], **kw)
    j = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return t, j


@pytest.fixture(scope="module")
def tied():
    rng = np.random.default_rng(0)
    base = rand_desc(rng, 40)
    a, b = tied_desc(rng, 300, base), tied_desc(rng, 280, base)
    return dict(a=a, b=b, va=rng.random(300) > 0.1, vb=rng.random(280) > 0.1,
                sm=rng.random((300, 280)) > 0.3,
                angle_a=rng.uniform(-3, 3, 300).astype(np.float32),
                angle_b=rng.uniform(-3, 3, 280).astype(np.float32))


def test_hamming_matrix_exact():
    rng = np.random.default_rng(1)
    a, b = rand_desc(rng, 12), rand_desc(rng, 17)
    a[0] = 0
    b[0] = 0xFFFFFFFF  # distance 256 and the sign bit of every word
    d = tm.hamming_matrix(_i32(a), _i32(b)).numpy()
    assert d.dtype == np.int32
    np.testing.assert_array_equal(d, np.asarray(jm.hamming_matrix(jnp.asarray(a),
                                                                  jnp.asarray(b))))
    for i in range(12):
        for j in range(17):
            assert d[i, j] == sum(bin(int(a[i, w]) ^ int(b[j, w])).count("1") for w in range(8))
    assert d[0, 0] == 256


def test_hamming_matrix_batched():
    rng = np.random.default_rng(2)
    a, b = rand_desc(rng, 3 * 10).reshape(3, 10, 8), rand_desc(rng, 3 * 7).reshape(3, 7, 8)
    d = tm.hamming_matrix(_i32(a), _i32(b)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(
            d[k], np.asarray(jm.hamming_matrix(jnp.asarray(a[k]), jnp.asarray(b[k]))))


CASES = {
    "ratio": dict(),
    "no_ratio": dict(apply_ratio=False),
    "mask_th_high": dict(spatial_mask=True, max_dist=100),
    "mask_ratio_0.8": dict(spatial_mask=True, max_dist=100, nn_ratio=0.8),
    "rotation": dict(check_rotation=True, apply_ratio=False, max_dist=100),
    "mask_rotation": dict(spatial_mask=True, check_rotation=True, apply_ratio=False,
                          max_dist=100),
}


@pytest.mark.parametrize("case", CASES)
def test_match_descriptors_exact_with_ties(tied, case):
    kw = dict(CASES[case])
    kt, kj = dict(kw), dict(kw)
    if kw.pop("spatial_mask", False):
        kt["spatial_mask"], kj["spatial_mask"] = torch.from_numpy(tied["sm"]), jnp.asarray(tied["sm"])
    if kw.get("check_rotation"):
        kt.update(angle_a=torch.from_numpy(tied["angle_a"]), angle_b=torch.from_numpy(tied["angle_b"]))
        kj.update(angle_a=jnp.asarray(tied["angle_a"]), angle_b=jnp.asarray(tied["angle_b"]))
    it, dt = tm.match_descriptors(_i32(tied["a"]), torch.from_numpy(tied["va"]), _i32(tied["b"]),
                                  torch.from_numpy(tied["vb"]), **kt)
    ij, dj = jm.match_descriptors(jnp.asarray(tied["a"]), jnp.asarray(tied["va"]),
                                  jnp.asarray(tied["b"]), jnp.asarray(tied["vb"]), **kj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).sum() > 5  # the case matched something
    m = it.numpy()[it.numpy() >= 0]
    assert len(np.unique(m)) == len(m)  # one-to-one


def test_match_finds_permutation_and_respects_empty_mask():
    """tests/test_matching.py's permutation and forbid-all cases."""
    rng = np.random.default_rng(2)
    b = rand_desc(rng, 64)
    perm = rng.permutation(64)
    a = b[perm].copy()
    a[0, 0] ^= 0b111
    ones = np.ones(64, bool)
    (it, dt), (ij, dj) = _both(tm.match_descriptors, jm.match_descriptors, a, ones, b, ones)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    ok = it.numpy() >= 0
    assert ok.sum() > 55 and (it.numpy()[ok] == perm[ok]).all() and dt.numpy()[0] == 3
    mask = np.zeros((64, 64), bool)
    it, _ = tm.match_descriptors(_i32(a), torch.from_numpy(ones), _i32(b),
                                 torch.from_numpy(ones), spatial_mask=torch.from_numpy(mask))
    assert (it.numpy() == -1).all()


def test_rotation_consistency_mask_exact():
    n = 60
    rng = np.random.default_rng(5)
    angle_b = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angle_a = (angle_b + 0.5).astype(np.float32)
    angle_a[0] = angle_b[0] + 2.5
    angle_a[1:4] = angle_b[1:4] - 0.2  # a weak second peak
    idx = rng.permutation(n).astype(np.int32)  # row i of A matched to row idx[i] of B
    angle_b_p = np.empty_like(angle_b)
    angle_b_p[idx] = angle_b
    idx[5] = -1
    valid = np.ones(n, bool)
    valid[[5, 6]] = False
    t = tm.rotation_consistency_mask(torch.from_numpy(angle_a), torch.from_numpy(angle_b_p),
                                     torch.from_numpy(idx), torch.from_numpy(valid)).numpy()
    j = np.asarray(jm.rotation_consistency_mask(jnp.asarray(angle_a), jnp.asarray(angle_b_p),
                                                jnp.asarray(idx), jnp.asarray(valid)))
    np.testing.assert_array_equal(t, j)
    assert not t[0] and t[7:].sum() >= n - 12


@pytest.mark.parametrize("per_a", [False, True])
def test_window_mask_exact(per_a):
    rng = np.random.default_rng(6)
    xa = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    xb = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    xb[:5] = xa[:5] + 5.0  # exactly on the window's edge: excluded (strict <)
    oa = rng.integers(0, 8, 50).astype(np.int32)
    ob = rng.integers(0, 8, 70).astype(np.int32)
    r = rng.uniform(-1, 20, 50).astype(np.float32) if per_a else 5.0
    t = tm.window_mask(torch.from_numpy(xa), torch.from_numpy(xb),
                       torch.from_numpy(r) if per_a else r, torch.from_numpy(oa),
                       torch.from_numpy(ob), level_window=1).numpy()
    j = np.asarray(jm.window_mask(jnp.asarray(xa), jnp.asarray(xb),
                                  jnp.asarray(r) if per_a else r, jnp.asarray(oa),
                                  jnp.asarray(ob), level_window=1))
    np.testing.assert_array_equal(t, j)
    assert t.any() and not t.all()


def _epipolar_pair(rng, f1=150, f2=160):
    """Two views of random points, with a fundamental matrix and
    descriptors that match across the views (a few bits flipped)."""
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pts = np.stack([rng.uniform(-4, 4, f1), rng.uniform(-3, 3, f1), rng.uniform(6, 12, f1)], 1)
    t = np.array([0.5, 0.1, 0.0])
    xy1 = pts[:, :2] / pts[:, 2:] * 300.0 + [160, 120]
    p2 = pts - t
    xy2 = p2[:, :2] / p2[:, 2:] * 300.0 + [160, 120]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    F12 = Kinv.T @ tx.T @ Kinv  # x1^T F12 x2 = 0 for x2 = x1 moved by t
    base = rand_desc(rng, f1)
    d2 = np.concatenate([flipped(rng, base), rand_desc(rng, f2 - f1)])
    order = rng.permutation(f2)
    xy2 = np.concatenate([xy2, rng.uniform(0, 320, (f2 - f1, 2))])[order]
    return (base, xy1.astype(np.float32), d2[order], xy2.astype(np.float32),
            F12.astype(np.float32))


def test_match_epipolar_exact():
    rng = np.random.default_rng(7)
    d1, xy1, d2, xy2, F12 = _epipolar_pair(rng)
    free1 = rng.random(len(d1)) > 0.1
    free2 = rng.random(len(d2)) > 0.1
    s2 = rng.choice([1.0, 1.44, 2.07], len(d2)).astype(np.float32)
    (it, dt), (ij, dj) = _both(tm.match_epipolar, jm.match_epipolar, d1, free1, d2, free2, xy1,
                               xy2, F12, s2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).sum() > len(d1) // 2


def test_match_epipolar_batch_exact():
    rng = np.random.default_rng(8)
    pairs = [_epipolar_pair(rng) for _ in range(3)]
    d1, xy1 = pairs[0][0], pairs[0][1]
    free1 = rng.random((3, len(d1))) > 0.2
    d2 = np.stack([p[2] for p in pairs])
    xy2 = np.stack([p[3] for p in pairs])
    F = np.stack([pairs[0][4]] * 3)
    free2 = rng.random(d2.shape[:2]) > 0.1
    s2 = np.ones(d2.shape[:2], np.float32)
    t = tm.match_epipolar_batch(_i32(d1), torch.from_numpy(free1), torch.from_numpy(xy1),
                                _i32(d2), torch.from_numpy(free2), torch.from_numpy(xy2),
                                torch.from_numpy(F), torch.from_numpy(s2)).numpy()
    j = np.asarray(jm.match_epipolar_batch(jnp.asarray(d1), jnp.asarray(free1), jnp.asarray(xy1),
                                           jnp.asarray(d2), jnp.asarray(free2), jnp.asarray(xy2),
                                           jnp.asarray(F), jnp.asarray(s2)))
    np.testing.assert_array_equal(t, j)
    assert t.shape == (3, len(d1)) and (t[0] >= 0).sum() > 10


def test_fuse_match_batch_exact():
    rng = np.random.default_rng(9)
    P, NB, F = 4, 40, 60
    base = rand_desc(rng, 30)
    ds = np.stack([tied_desc(rng, NB, base) for _ in range(P)])
    dd = np.stack([tied_desc(rng, F, base) for _ in range(P)])
    xd = rng.uniform(0, 50, (P, F, 2)).astype(np.float32)
    proj = (xd[:, :NB] + rng.uniform(-4, 4, (P, NB, 2))).astype(np.float32)
    vs = rng.random((P, NB)) > 0.1
    vd = rng.random((P, F)) > 0.1
    t = tm.fuse_match_batch(_i32(ds), torch.from_numpy(vs), torch.from_numpy(proj), _i32(dd),
                            torch.from_numpy(vd), torch.from_numpy(xd)).numpy()
    j = np.asarray(jm.fuse_match_batch(jnp.asarray(ds), jnp.asarray(vs), jnp.asarray(proj),
                                       jnp.asarray(dd), jnp.asarray(vd), jnp.asarray(xd)))
    np.testing.assert_array_equal(t, j)
    assert (t >= 0).sum() >= 5


@pytest.mark.gpu
def test_match_ties_on_card(cuda_device, tied):
    """argmin's first-minimum rule and the +-1 product hold on the card."""
    args = [_i32(tied["a"]), torch.from_numpy(tied["va"]), _i32(tied["b"]),
            torch.from_numpy(tied["vb"])]
    kw = dict(spatial_mask=torch.from_numpy(tied["sm"]), max_dist=100, apply_ratio=False,
              angle_a=torch.from_numpy(tied["angle_a"]),
              angle_b=torch.from_numpy(tied["angle_b"]), check_rotation=True)
    h = tm.match_descriptors(*args, **kw)
    c = tm.match_descriptors(*[a.to(cuda_device) for a in args],
                             **{k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
                                for k, v in kw.items()})
    assert torch.equal(c[0].cpu(), h[0]) and torch.equal(c[1].cpu(), h[1])
    assert torch.equal(tm.hamming_matrix(args[0].to(cuda_device), args[2].to(cuda_device)).cpu(),
                       tm.hamming_matrix(args[0], args[2]))
