"""Keyframe database for loop detection and relocalization candidates.

A numpy copy of `orbslam2_nmi_tpu/slam/keyframe_database.py`, bound to the
port's own `MapStore` and `Vocabulary` (whose `quantize` runs on the
vocabulary's device); entries, scores and candidates are the JAX package's
for the same map and tree. The notes below are the JAX package's.

Replaces KeyFrameDatabase (reference: src/KeyFrameDatabase.cc). Like the
reference, the core structure is an INVERTED FILE (word -> keyframe list,
KeyFrameDatabase.cc:43 mvInvertedFile) plus per-keyframe sparse BoW entries
(sorted word ids + L1-normalized tf-idf weights in fixed-width arrays) — the
memory bound is O(max_keyframes * max_features), INDEPENDENT of vocabulary
size, so reference-scale (~1M word) vocabularies fit. Candidate scoring is a
vectorized sorted-intersection over the shortlisted keyframes (the reference
scores only shortlisted KFs too, :129-148).

Selection logic preserved:

  * DetectLoopCandidates (KeyFrameDatabase.cc:79-200): exclude covisible
    neighbors, gate by 0.8 * max-common-words (:123), require score >= the
    min covisible-neighbor score, accumulate scores over each candidate's
    top-10 covisibility group (:151-176), retain >= 0.75 * best accumulated
    score (:179).
  * DetectRelocalizationCandidates (:202): same flow, no covisibility
    exclusion, no minScore gate.

DBoW2's L1 score 1 - 0.5*|v1 - v2|_1 over L1-normalized vectors reduces to
sum(min(w1_i, w2_i)) over common words — computed sparsely here.
"""

from __future__ import annotations

import numpy as np

from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, vocab: Vocabulary, max_keyframes: int, max_words: int = 2048):
        self.vocab = vocab
        W = max_words
        self.kf_words = np.full((max_keyframes, W), -1, np.int64)  # sorted per row
        self.kf_weights = np.zeros((max_keyframes, W), np.float32)
        self.kf_nwords = np.zeros(max_keyframes, np.int32)
        self.active = np.zeros(max_keyframes, bool)
        # inverted file: word -> list of keyframes (lazy-deleted via `active`)
        self.inverted: dict[int, list[int]] = {}

    def clear(self):
        self.active[:] = False
        self.kf_nwords[:] = 0
        self.inverted.clear()

    # --------------------------------------------------------------- entries

    def compute_entry(self, desc: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(sorted unique word ids, L1-normalized tf-idf weights) for a
        descriptor set — the sparse BoW vector."""
        w = self.vocab.quantize(desc, valid)
        w = w[w >= 0]
        words, counts = np.unique(w, return_counts=True)
        weights = counts.astype(np.float32) * self.vocab.word_weight[words]
        s = weights.sum()
        if s > 0:
            weights = weights / s
        return words.astype(np.int64), weights

    def add(self, kf: int, desc: np.ndarray, valid: np.ndarray):
        words, weights = self.compute_entry(desc, valid)
        self.add_entry(kf, words, weights)

    def add_entry(self, kf: int, words: np.ndarray, weights: np.ndarray):
        if self.kf_nwords[kf] > 0:  # re-add (backfill/load): drop old postings
            for w in self.kf_words[kf, : self.kf_nwords[kf]]:
                lst = self.inverted.get(int(w))
                if lst and kf in lst:
                    lst.remove(kf)
        n = min(len(words), self.kf_words.shape[1])
        self.kf_words[kf, :n] = words[:n]
        self.kf_weights[kf, :n] = weights[:n]
        self.kf_words[kf, n:] = -1
        self.kf_weights[kf, n:] = 0.0
        self.kf_nwords[kf] = n
        self.active[kf] = True
        for w in words[:n]:
            self.inverted.setdefault(int(w), []).append(kf)

    def erase(self, kf: int):
        """KeyFrameDatabase::erase (:51) — the inverted lists are cleaned
        lazily via the `active` mask at query time."""
        self.active[kf] = False

    # --------------------------------------------------------------- scoring

    def _shortlist(self, words: np.ndarray, exclude: set | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Walk the inverted file: (candidate kfs, shared-word counts)."""
        counts: dict[int, int] = {}
        for w in words:
            for kf in self.inverted.get(int(w), ()):
                if self.active[kf] and (exclude is None or kf not in exclude):
                    counts[kf] = counts.get(kf, 0) + 1
        if not counts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        kfs = np.fromiter(counts.keys(), np.int64, len(counts))
        ns = np.fromiter(counts.values(), np.int64, len(counts))
        return kfs, ns

    def score_against(self, words: np.ndarray, weights: np.ndarray, kfs: np.ndarray) -> np.ndarray:
        """L1 similarity sum(min(w_q, w_k)) of the query entry against each
        keyframe in `kfs`, vectorized (one searchsorted batch)."""
        if len(kfs) == 0:
            return np.zeros(0, np.float32)
        rows_w = self.kf_words[kfs]  # [C, W] sorted with -1 pad at the end...
        rows_x = self.kf_weights[kfs]
        # -1 pads sort BEFORE real ids; rows were written sorted ascending
        # with pads after — make pads +inf-like by replacing with a sentinel
        big = np.int64(np.iinfo(np.int64).max)
        rows_sorted = np.where(rows_w >= 0, rows_w, big)
        order = np.argsort(rows_sorted, axis=1, kind="stable")
        rows_sorted = np.take_along_axis(rows_sorted, order, axis=1)
        rows_x = np.take_along_axis(rows_x, order, axis=1)
        C, W = rows_sorted.shape
        # positions of each query word in each row
        pos = np.stack([np.searchsorted(rows_sorted[c], words) for c in range(C)])
        pos = np.minimum(pos, W - 1)
        hit = np.take_along_axis(rows_sorted, pos, axis=1) == words[None, :]
        wk = np.take_along_axis(rows_x, pos, axis=1)
        return np.where(hit, np.minimum(wk, weights[None, :]), 0.0).sum(1).astype(np.float32)

    def score_pair(self, kf_a: int, kf_b: int) -> float:
        wa, xa = self.kf_words[kf_a, : self.kf_nwords[kf_a]], self.kf_weights[kf_a, : self.kf_nwords[kf_a]]
        return float(self.score_against(wa, xa, np.array([kf_b]))[0])

    # ------------------------------------------------------------ candidates

    def _group_retention(
        self, map_store: MapStore, keep: list[int], scores: dict[int, float]
    ) -> list[int]:
        """Covisibility-group score accumulation + 0.75-of-best retention
        (KeyFrameDatabase.cc:151-179)."""
        acc_scores = {}
        best_child = {}
        keep_set = set(keep)
        for k in keep:
            group = [k] + [int(x) for x in map_store.best_covisible(k, 10)]
            in_keep = [g for g in group if g in keep_set or g == k]
            acc_scores[k] = sum(scores.get(g, 0.0) for g in in_keep)
            best_child[k] = max(in_keep, key=lambda g: scores.get(g, 0.0))
        best_acc = max(acc_scores.values())
        retain = 0.75 * best_acc
        return sorted({best_child[k] for k, a in acc_scores.items() if a > retain})

    def detect_loop_candidates(
        self,
        map_store: MapStore,
        kf: int,
        words: np.ndarray,
        weights: np.ndarray,
        min_score: float,
    ) -> list[int]:
        """Loop candidates for `kf` given its query entry (words, weights)."""
        if len(words) == 0:
            return []
        connected = set(int(x) for x in map_store.covisible_keyframes(kf, min_weight=1))
        connected.add(kf)
        cand, common = self._shortlist(words, exclude=connected)
        if len(cand) == 0:
            return []
        th = 0.8 * common.max()  # KeyFrameDatabase.cc:123
        sel = common > th
        cand = cand[sel]
        s = self.score_against(words, weights, cand)
        keep = [int(k) for k, sc in zip(cand, s) if sc >= min_score]
        if not keep:
            return []
        scores = {int(k): float(sc) for k, sc in zip(cand, s)}
        return self._group_retention(map_store, keep, scores)

    def detect_relocalization_candidates(
        self, map_store: MapStore, desc: np.ndarray, valid: np.ndarray
    ) -> list[int]:
        words, weights = self.compute_entry(desc, valid)
        if len(words) == 0:
            return []
        cand, common = self._shortlist(words)
        if len(cand) == 0:
            return []
        th = 0.8 * common.max()
        sel = common > th
        cand = cand[sel]
        s = self.score_against(words, weights, cand)
        keep = [int(k) for k in cand]
        scores = {int(k): float(sc) for k, sc in zip(cand, s)}
        return self._group_retention(map_store, keep, scores)
