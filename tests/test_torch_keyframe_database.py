"""The port's keyframe database (`slam/keyframe_database.py`) against the JAX
package's on tests/test_loop_closing.py's looped map (14 keyframes, the last
a revisit of the first), each bound to its own package's map store and
vocabulary (trained from the same descriptors with the same seed, so the
trees are equal).

Bars: all exact. The entries (sorted words, L1-normalized tf-idf weights),
the inverted file, the scores of every keyframe against a query, and the
loop and relocalization candidates equal the reference's; so do they after
an erase and a re-add, and for a database carried across by
`convert.database_from_fields`.
"""

import dataclasses

import numpy as np
import pytest
from torch_port_fixtures import LOOP_N_CHAIN, looped_map_state, map_fields

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.slam import keyframe_database as tdb
from orbslam2_nmi_torch.slam import vocabulary as tv
from orbslam2_nmi_tpu.slam import keyframe_database as jdb
from orbslam2_nmi_tpu.slam import vocabulary as jv

ENTRY_FIELDS = ("kf_words", "kf_weights", "kf_nwords", "active")


@pytest.fixture(scope="module")
def dbs():
    jcfg, jm, _, _ = looped_map_state()
    tm = convert.map_store_from_fields(map_fields(jm),
                                       convert.system_config_from_dict(dataclasses.asdict(jcfg)))
    descs = np.concatenate([jm.kf_feat_desc[i] for i in range(LOOP_N_CHAIN)])
    tvoc = tv.Vocabulary.train(descs, k=5, depth=3, seed=2)
    jvoc = jv.Vocabulary.train(descs, k=5, depth=3, seed=2)
    tdb_, jdb_ = tdb.KeyFrameDatabase(tvoc, 32), jdb.KeyFrameDatabase(jvoc, 32)
    for k in range(LOOP_N_CHAIN):
        tdb_.add(k, tm.kf_feat_desc[k], tm.kf_feat_valid[k])
        jdb_.add(k, jm.kf_feat_desc[k], jm.kf_feat_valid[k])
    return tm, jm, tdb_, jdb_


def _same_entries(t, j):
    for f in ENTRY_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.inverted == j.inverted


def test_entries_and_inverted_file_equal(dbs):
    tm, jm, t, j = dbs
    _same_entries(t, j)
    for k in range(LOOP_N_CHAIN):
        tw, tx = t.compute_entry(tm.kf_feat_desc[k], tm.kf_feat_valid[k])
        jw, jx = j.compute_entry(jm.kf_feat_desc[k], jm.kf_feat_valid[k])
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tx, jx)


def test_scores_and_candidates_equal(dbs):
    tm, jm, t, j = dbs
    last = LOOP_N_CHAIN - 1
    kfs = np.arange(LOOP_N_CHAIN)
    for k in (0, 5, last):
        w, x = t.compute_entry(tm.kf_feat_desc[k], tm.kf_feat_valid[k])
        np.testing.assert_array_equal(t.score_against(w, x, kfs), j.score_against(w, x, kfs))
        for min_score in (0.0, 0.05):
            tc = t.detect_loop_candidates(tm, k, w, x, min_score)
            assert tc == j.detect_loop_candidates(jm, k, w, x, min_score), (k, min_score)
    w, x = t.compute_entry(tm.kf_feat_desc[last], tm.kf_feat_valid[last])
    assert 0 in t.detect_loop_candidates(tm, last, w, x, 0.0)
    rng = np.random.default_rng(3)
    for k in (0, 7, last):
        q = tm.kf_feat_desc[k].copy()
        q[:10, 0] ^= np.uint32(3)  # a noisy revisit
        valid = rng.random(len(q)) > 0.05
        tc = t.detect_relocalization_candidates(tm, q, valid)
        assert tc == j.detect_relocalization_candidates(jm, q, valid), k
        assert k in tc


def test_erase_and_readd(dbs):
    tm, jm, t, j = dbs
    for db in (t, j):
        db.erase(0)
    w, x = t.compute_entry(tm.kf_feat_desc[13], tm.kf_feat_valid[13])
    assert t.detect_loop_candidates(tm, 13, w, x, 0.0) == j.detect_loop_candidates(
        jm, 13, w, x, 0.0)
    assert 0 not in t.detect_loop_candidates(tm, 13, w, x, 0.0)
    t.add(0, tm.kf_feat_desc[0], tm.kf_feat_valid[0])
    j.add(0, jm.kf_feat_desc[0], jm.kf_feat_valid[0])
    _same_entries(t, j)


def test_database_from_fields(dbs):
    tm, jm, t, j = dbs
    carried = convert.database_from_fields(vars(j), t.vocab)
    _same_entries(carried, j)
    w, x = t.compute_entry(tm.kf_feat_desc[13], tm.kf_feat_valid[13])
    assert carried.detect_loop_candidates(tm, 13, w, x, 0.0) == j.detect_loop_candidates(
        jm, 13, w, x, 0.0)
