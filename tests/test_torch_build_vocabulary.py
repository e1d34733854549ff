"""The port's vocabulary builder (`orbslam2_nmi_torch/tools/build_vocabulary.py`)
against the JAX package's `tools/build_vocabulary.py`, on the CPU.

  * `harvest_synthetic` (2 frames of the seed-0 point world at 160x120, 300
    features): the same number of descriptors, at most 1e-4 of their bits
    apart (measured: 547 descriptors, 1 bit apart in one of them: the ORB
    angles' float gap, tests/test_torch_orb.py);
  * `main` on the same descriptors (the JAX harvest, fed to both): the
    trained trees are equal array for array, and the `.npz` and DBoW2-text
    files each writes load in the other package with the same arrays;
  * `ensure_circuit_vocabulary` on a small circuit sequence (both packages
    fed the port's 4 frames at 160x96): descriptors within the harvest's
    bar, the file cached under the port's sequence cache and reused.
"""

import numpy as np
import pytest
import torch
from torch_port_fixtures import THREADS  # noqa: F401  (one torch thread a test worker)

from orbslam2_nmi_torch.slam import vocabulary as tv
from orbslam2_nmi_torch.tools import build_vocabulary as tbv
from orbslam2_nmi_torch.tools import replay_bench as trb
from orbslam2_nmi_tpu.slam import vocabulary as jv
from orbslam2_nmi_tpu.tools import build_vocabulary as jbv
from orbslam2_nmi_tpu.tools import replay_bench as jrb

FIELDS = ("node_desc", "children", "leaf_id", "word_weight")
BITS_APART = 1e-4


def _bits_apart(a, b):
    return float(np.mean(np.unpackbits(a.view(np.uint8)) != np.unpackbits(b.view(np.uint8))))


@pytest.fixture(scope="module")
def harvests():
    t = tbv.harvest_synthetic(2, 160, 120, 300, 0, device="cpu")
    j = np.asarray(jbv.harvest_synthetic(2, 160, 120, 300, 0))
    return t, j


def test_harvest_matches_reference(harvests):
    t, j = harvests
    assert t.dtype == j.dtype == np.uint32 and t.shape == j.shape and len(t) > 300
    assert _bits_apart(t, j) <= BITS_APART


def _assert_same_tree(a, b):
    assert (a.k, a.depth, a.n_words) == (b.k, b.depth, b.n_words)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("suffix", [".npz", ".txt"])
def test_main_files_cross_packages(harvests, suffix, tmp_path, monkeypatch):
    _, descs = harvests
    monkeypatch.setattr(tbv, "harvest_synthetic", lambda *a, **k: descs)
    monkeypatch.setattr(jbv, "harvest_synthetic", lambda *a: descs)
    args = ["--synthetic-frames", "2", "--k", "4", "--depth", "2", "--seed", "3"]
    t_path, j_path = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    assert tbv.main(args + ["--out", t_path, "--device", "cpu"]) == 0
    assert jbv.main(args + ["--out", j_path]) == 0
    trained = tv.Vocabulary.train(descs, k=4, depth=2, seed=3)
    for path in (t_path, j_path):
        _assert_same_tree(tv.Vocabulary.load(path), jv.Vocabulary.load(path))
    if suffix == ".npz":  # the text format keeps no idf weights of its own
        _assert_same_tree(tv.Vocabulary.load(t_path), trained)
        _assert_same_tree(tv.Vocabulary.load(j_path), trained)
    else:
        assert open(t_path).read() == open(j_path).read()


def test_ensure_circuit_vocabulary(tmp_path, monkeypatch):
    monkeypatch.setenv("ORBSLAM2_NMI_TORCH_SEQ_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("ORBSLAM2_NMI_TPU_SEQ_CACHE", str(tmp_path / "j"))
    world, frames = trb.generate_sequence(4, 160, 96, n_total=520, cache=False, device="cpu")
    calls = []

    def port_seq(n, w, h, seed=1, circuit="standard", device="cuda"):
        calls.append((n, w, h, seed, circuit))
        return world, frames

    monkeypatch.setattr(trb, "generate_sequence", port_seq)
    monkeypatch.setattr(jrb, "generate_sequence", lambda *a, **k: (None, frames.numpy()))
    got = []

    def capture(train):
        def wrapped(descs, **kw):
            got.append(descs)
            return train(descs, **kw)
        return wrapped

    monkeypatch.setattr(tv.Vocabulary, "train", staticmethod(capture(tv.Vocabulary.train)))
    monkeypatch.setattr(jv.Vocabulary, "train", staticmethod(capture(jv.Vocabulary.train)))
    kw = dict(k=4, depth=2, n_frames=2)
    t_path = tbv.ensure_circuit_vocabulary(device="cpu", **kw)
    j_path = jbv.ensure_circuit_vocabulary(**kw)
    assert calls == [(520, 960, 540, 1, "standard")]
    assert t_path.startswith(str(tmp_path / "t")) and t_path.endswith("k4d2s1_2f.npz")
    assert got[0].shape == got[1].shape and _bits_apart(got[0], np.asarray(got[1])) <= BITS_APART
    assert tv.Vocabulary.load(t_path).n_words == jv.Vocabulary.load(j_path).n_words > 1
    # cached: a second call trains nothing
    assert tbv.ensure_circuit_vocabulary(device="cpu", **kw) == t_path and len(got) == 2


def test_cuda_is_the_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbv.main(["--synthetic-frames", "1", "--out", str(tmp_path / "v.npz")])
