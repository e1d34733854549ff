"""The port's vocabulary (`slam/vocabulary.py`) against the JAX package's, on
the CPU, with the same seeded descriptors.

Bars: all exact. The trained tree (node descriptors, children, leaves, idf
weights) equals the reference's array for array (the numpy training is a
copy); `quantize` and `bow_vector` equal exactly (the descent counts bits
through a byte table, exact integers, and takes the first of equal
distances as `jnp.argmin` does); a `.npz` or DBoW2-text vocabulary written
by either package loads in the other with the same arrays. `bow_l1_score`
within 1e-6 (float32 sums in another order). On the card, `quantize`
equals the CPU's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.slam import vocabulary as tv
from orbslam2_nmi_tpu.slam import vocabulary as jv

FIELDS = ("node_desc", "children", "leaf_id", "word_weight")


def _clustered(seed=0, n_centers=32, per=30, flips=4):
    """tests/test_place_recognition.py's clustered descriptors."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2**32, (n_centers, 8), dtype=np.uint32)
    out = []
    for c in centers:
        for _ in range(per):
            d = c.copy()
            for _ in range(flips):
                d[rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
            out.append(d)
    return np.stack(out)


def _queries(voc, seed):
    """Random descriptors, the tree's own node descriptors (ties between
    siblings that share a parent's bits) and one-bit flips of them."""
    rng = np.random.default_rng(seed)
    nodes = voc.node_desc[rng.integers(0, len(voc.node_desc), 200)]
    flipped = nodes.copy()
    flipped[np.arange(200), rng.integers(0, 8, 200)] ^= np.uint32(1)
    return np.concatenate([rng.integers(0, 2**32, (300, 8), dtype=np.uint32), nodes, flipped])


@pytest.fixture(scope="module")
def trees():
    small = _clustered()
    big = _clustered(seed=5, n_centers=128, per=40, flips=12)  # ensure_vocabulary's shape
    return [(tv.Vocabulary.train(small, k=4, depth=3, seed=1),
             jv.Vocabulary.train(small, k=4, depth=3, seed=1)),
            (tv.Vocabulary.train(big, k=8, depth=4, seed=0),
             jv.Vocabulary.train(big, k=8, depth=4, seed=0))]


def test_trained_tree_equals_reference(trees):
    for t, j in trees:
        assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_synthetic_tree_equals_reference():
    t, j = tv.Vocabulary.synthetic(k=5, depth=4, seed=3), jv.Vocabulary.synthetic(5, 4, seed=3)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


@pytest.mark.parametrize("which", [0, 1])
def test_quantize_and_bow_vector_exact(trees, which):
    t, j = trees[which]
    q = _queries(t, seed=which)
    valid = np.random.default_rng(9).random(len(q)) > 0.1
    np.testing.assert_array_equal(t.quantize(q), j.quantize(q))
    np.testing.assert_array_equal(t.quantize(q, valid), j.quantize(q, valid))
    np.testing.assert_array_equal(t.bow_vector(q, valid), j.bow_vector(q, valid))


def test_quantize_exact_at_reference_scale():
    """A 100,000-word synthetic tree (k=10, depth=5; the reference's ORBvoc is
    k=10, depth=6)."""
    t, j = tv.Vocabulary.synthetic(10, 5, seed=1), jv.Vocabulary.synthetic(10, 5, seed=1)
    q = np.random.default_rng(3).integers(0, 2**32, (512, 8), dtype=np.uint32)
    np.testing.assert_array_equal(t.quantize(q), j.quantize(q))


def test_bow_l1_score_matches_reference(trees):
    t, _ = trees[0]
    rng = np.random.default_rng(4)
    v = np.stack([t.bow_vector(rng.integers(0, 2**32, (200, 8), dtype=np.uint32))
                  for _ in range(3)])
    for a, b in ((v[0], v), (v, v)):
        np.testing.assert_allclose(tv.bow_l1_score(torch.from_numpy(a), torch.from_numpy(b)),
                                   jv.bow_l1_score(jnp.asarray(a), jnp.asarray(b)), atol=1e-6)
    assert abs(float(tv.bow_l1_score(torch.from_numpy(v[0]), torch.from_numpy(v[:1]))[0])
               - 1.0) < 1e-5


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_files_cross_load(trees, tmp_path, fmt):
    """A vocabulary saved by either package loads in the other."""
    t, j = trees[1]
    q = _queries(t, seed=7)
    for writer, reader, name in ((j, tv.Vocabulary, "j"), (t, jv.Vocabulary, "t")):
        path = str(tmp_path / f"voc_{name}.{fmt}")
        (writer.save if fmt == "npz" else writer.save_dbow2_text)(path)
        loaded = reader.load(path)
        assert loaded.k == writer.k and loaded.n_words == writer.n_words
        for f in ("node_desc", "children", "leaf_id"):
            np.testing.assert_array_equal(getattr(loaded, f), getattr(writer, f), err_msg=f)
        np.testing.assert_allclose(loaded.word_weight, writer.word_weight, rtol=1e-6)
        np.testing.assert_array_equal(loaded.quantize(q), writer.quantize(q))


def test_vocabulary_from_numpy(trees):
    _, j = trees[1]
    t = convert.vocabulary_from_numpy(vars(j), device="cpu")
    q = _queries(t, seed=11)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    np.testing.assert_array_equal(t.quantize(q), j.quantize(q))


@pytest.mark.gpu
def test_quantize_card_equals_cpu(cuda_device, trees):  # noqa: F811
    for t, _ in trees + [(tv.Vocabulary.synthetic(10, 5, seed=1), None)]:
        q = _queries(t, seed=13)
        on_cpu = t.quantize(q)
        t.to(cuda_device)
        try:
            np.testing.assert_array_equal(t.quantize(q), on_cpu)
        finally:
            t.to("cpu")
