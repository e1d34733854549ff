"""Binary ORB vocabulary: a hierarchical k-medians tree as dense arrays.

Port of `orbslam2_nmi_tpu/slam/vocabulary.py`, the replacement for DBoW2's
TemplatedVocabulary<FORB> (reference: include/ORBVocabulary.h:31). Training,
the synthetic tree, the `.npz` and DBoW2-text files and the dense BoW vector
are numpy copies of the JAX package's, so a tree trained from the same
descriptors with the same seed is the same array for array, and a file
written by either package loads in the other. The notes below are the JAX
package's:

  * The tree lives in flat arrays (node descriptors [n_nodes, 8] uint32,
    children table [n_nodes, k]); descriptor->word lookup is a vectorized
    L-step descent over all N descriptors at once (XOR + popcount argmin per
    level) -- no pointer chasing.
  * The vocabulary is trained on the fly from harvested descriptors
    (hierarchical k-medians under Hamming distance, majority-bit centers)
    and serialized as .npz -- the reference's pretrained vocabulary is not
    redistributable here, and scoring only needs a consistent partition of
    descriptor space.

Where the port differs:
  * `quantize`, the descent, runs on `device` (`to(device)`; a new tree is on
    the CPU). Torch has no popcount: each level XORs the descriptor words
    with its children's and counts the bits of each byte through a
    256-entry table, exact integers on every device. The argmin over the
    children takes the first minimum, as `jnp.argmin` does.
  * `bow_l1_score` takes torch tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from orbslam2_nmi_torch.utils import profiling
from orbslam2_nmi_torch.utils.profiling import labelled
from orbslam2_nmi_torch.utils.readback import to_host

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def popcount_rows(x: np.ndarray) -> np.ndarray:
    """Bit count per row of a uint32 array [..., 8]."""
    return _POPCNT8[x.view(np.uint8)].sum(-1, dtype=np.int32)


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[A, 8] x [B, 8] uint32 -> [A, B] int Hamming distances (numpy).

    Byte-LUT popcount (8x less transient memory than unpackbits), chunked
    over A so vocabulary training on 10^5+ descriptors stays in cache."""
    A = len(a)
    out = np.empty((A, len(b)), np.int32)
    a8 = a.view(np.uint8)
    b8 = b.view(np.uint8)
    step = max(1, (1 << 24) // max(len(b), 1))
    for i in range(0, A, step):
        x = a8[i : i + step, None, :] ^ b8[None, :, :]
        out[i : i + step] = _POPCNT8[x].sum(-1, dtype=np.int32)
    return out


def majority_center(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of binary descriptors [N, 8] uint32."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [N, 256]
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


@dataclass
class Vocabulary:
    k: int  # branching factor
    depth: int  # levels below root
    node_desc: np.ndarray  # [n_nodes, 8] uint32
    children: np.ndarray  # [n_nodes, k] int32 (-1 = none)
    leaf_id: np.ndarray  # [n_nodes] int32 word id for leaves, -1 internal
    word_weight: np.ndarray  # [n_words] float32 idf weights
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    # ------------------------------------------------------------- training

    @staticmethod
    def train(descriptors: np.ndarray, k: int = 8, depth: int = 4, seed: int = 0,
              kmeans_iters: int = 6) -> "Vocabulary":
        """Hierarchical k-medians (Hamming) like DBoW2's create()."""
        rng = np.random.default_rng(seed)
        descriptors = np.unique(descriptors, axis=0)
        node_desc = [np.zeros(8, np.uint32)]
        children: list[list[int]] = [[]]
        leaf_of_node: list[int] = [-1]
        word_counts: list[int] = []

        def split(node: int, descs: np.ndarray, level: int):
            if level == depth or len(descs) <= k:
                leaf_of_node[node] = len(word_counts)
                word_counts.append(len(descs))
                return
            # k-medians init: random distinct seeds
            sel = rng.choice(len(descs), size=min(k, len(descs)), replace=False)
            centers = descs[sel]
            for _ in range(kmeans_iters):
                d = hamming_np(descs, centers)
                assign = d.argmin(1)
                new_centers = []
                for c in range(len(centers)):
                    member = descs[assign == c]
                    new_centers.append(majority_center(member) if len(member) else centers[c])
                centers = np.stack(new_centers)
            d = hamming_np(descs, centers)
            assign = d.argmin(1)
            for c in range(len(centers)):
                member = descs[assign == c]
                if len(member) == 0:
                    continue
                child = len(node_desc)
                node_desc.append(centers[c])
                children.append([])
                leaf_of_node.append(-1)
                children[node].append(child)
                split(child, member, level + 1)

        split(0, descriptors, 0)
        n_nodes = len(node_desc)
        child_arr = np.full((n_nodes, k), -1, np.int32)
        for n, ch in enumerate(children):
            child_arr[n, : len(ch)] = ch
        n_words = len(word_counts)
        total = max(sum(word_counts), 1)
        # idf weights (DBoW2 TF_IDF): log(N / n_i)
        wc = np.maximum(np.array(word_counts, np.float64), 1)
        idf = np.log(total / wc).astype(np.float32)
        return Vocabulary(
            k=k,
            depth=depth,
            node_desc=np.stack(node_desc).astype(np.uint32),
            children=child_arr,
            leaf_id=np.array(leaf_of_node, np.int32),
            word_weight=idf,
        )

    @staticmethod
    def synthetic(k: int, depth: int, seed: int = 0) -> "Vocabulary":
        """Structurally complete random vocabulary of k^depth words.

        For validating the lookup/database/serialization paths at the
        reference's ORBvoc scale (k=10, depth=6 => 1M words, System.cc:87)
        without hours of k-medians training — every code path treats it
        identically to a trained tree."""
        rng = np.random.default_rng(seed)
        level_sizes = [k**i for i in range(depth + 1)]
        n_nodes = sum(level_sizes)
        node_desc = rng.integers(0, 2**32, (n_nodes, 8), dtype=np.uint32)
        node_desc[0] = 0
        children = np.full((n_nodes, k), -1, np.int32)
        # level L occupies [offset_L, offset_L + k^L); children are contiguous
        off = np.cumsum([0] + level_sizes)
        for lvl in range(depth):
            parents = np.arange(off[lvl], off[lvl + 1])
            first_child = off[lvl + 1] + (parents - off[lvl]) * k
            children[parents] = first_child[:, None] + np.arange(k)[None, :]
        leaf_id = np.full(n_nodes, -1, np.int32)
        n_words = level_sizes[-1]
        leaf_id[off[depth] :] = np.arange(n_words, dtype=np.int32)
        word_weight = rng.uniform(0.5, 2.0, n_words).astype(np.float32)
        return Vocabulary(
            k=k, depth=depth, node_desc=node_desc, children=children,
            leaf_id=leaf_id, word_weight=word_weight,
        )

    # ---------------------------------------------------------------- io

    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, depth=self.depth, node_desc=self.node_desc,
            children=self.children, leaf_id=self.leaf_id, word_weight=self.word_weight,
        )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        """Load either our .npz serialization or a DBoW2 text vocabulary
        (ORBvoc.txt, optionally .tar.gz/.gz-compressed as released by the
        reference — System.cc:87 loads the extracted .txt). The first load's
        seconds are the set-up counter `vocabulary.load`."""
        t0 = time.perf_counter()
        if path.endswith((".txt", ".txt.tar.gz", ".txt.gz", ".tar.gz")):
            voc = Vocabulary.load_dbow2_text(path)
        else:
            z = np.load(path)
            voc = Vocabulary(
                k=int(z["k"]), depth=int(z["depth"]), node_desc=z["node_desc"],
                children=z["children"], leaf_id=z["leaf_id"], word_weight=z["word_weight"],
            )
        profiling.record_setup("vocabulary.load", time.perf_counter() - t0)
        return voc

    @staticmethod
    def load_dbow2_text(path: str) -> "Vocabulary":
        """Parse DBoW2's TemplatedVocabulary text format (the reference's
        ORBvoc.txt, loaded by ORBVocabulary::loadFromTextFile via System.cc:87).

        Format: header line `k L scoring weighting`, then one line per non-root
        node in file order: `parent is_leaf b0 .. b31 weight` (32 descriptor
        bytes, OpenCV bit order). Node ids are implicit (root = 0, first data
        line = 1, ...); word ids are assigned to leaves in file order, exactly
        like DBoW2's loadFromTextFile.
        """
        import gzip
        import tarfile

        if path.endswith(".tar.gz"):
            with tarfile.open(path, "r:gz") as tf:
                member = next(m for m in tf.getmembers() if m.name.endswith(".txt"))
                raw = tf.extractfile(member).read().decode()
        elif path.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                raw = f.read()
        else:
            with open(path) as f:
                raw = f.read()
        head_end = raw.index("\n")
        k, depth, _scoring, _weighting = (int(x) for x in raw[:head_end].split()[:4])

        # vectorized parse: every data line is `parent is_leaf b0..b31 weight`
        # (35 numeric columns) — at reference scale (~1.1M lines for the
        # 145 MB ORBvoc.txt) a Python per-line loop takes minutes; fromstring
        # over the whole payload takes seconds
        import io

        body = raw[head_end + 1 :]
        data = np.loadtxt(io.StringIO(body), dtype=np.float64, ndmin=2)
        assert data.shape[1] == 35, f"malformed vocabulary file ({data.shape[1]} cols)"
        n_data = len(data)
        n_nodes = 1 + n_data

        node_desc = np.zeros((n_nodes, 8), np.uint32)
        node_desc[1:] = (
            data[:, 2:34].astype(np.uint8).reshape(n_data, 32).view(np.uint32)
        )  # little-endian byte packing, OpenCV bit order
        parent = data[:, 0].astype(np.int64)
        is_leaf = data[:, 1] != 0
        w_col = data[:, 34]

        # children table: stable-sort nodes by parent; slot = rank within group
        node_ids = np.arange(1, n_nodes, dtype=np.int64)
        order = np.argsort(parent, kind="stable")
        sorted_parent = parent[order]
        sorted_child = node_ids[order]
        uniq, first = np.unique(sorted_parent, return_index=True)
        slot = np.arange(n_data) - np.repeat(first, np.diff(np.append(first, n_data)))
        children = np.full((n_nodes, k), -1, np.int32)
        children[sorted_parent, slot] = sorted_child

        # word ids assigned to leaves in file order (DBoW2 loadFromTextFile)
        leaf_id = np.full(n_nodes, -1, np.int32)
        leaf_nodes = node_ids[is_leaf]
        leaf_id[leaf_nodes] = np.arange(is_leaf.sum(), dtype=np.int32)
        weights = w_col[is_leaf].astype(np.float32)

        return Vocabulary(
            k=k,
            depth=depth,
            node_desc=node_desc,
            children=children,
            leaf_id=leaf_id,
            word_weight=weights,
        )

    def save_dbow2_text(self, path: str):
        """Write the DBoW2 text format (interchange with the reference).
        Inverse of load_dbow2_text; nodes are emitted in index order, which in
        our construction always places parents before children."""
        n_nodes = len(self.node_desc)
        parent = np.zeros(n_nodes, np.int64)
        src = np.repeat(np.arange(n_nodes), self.children.shape[1])
        dst = self.children.reshape(-1)
        ok = dst >= 0
        parent[dst[ok]] = src[ok]
        is_leaf = (self.leaf_id >= 0).astype(np.int64)
        w = np.zeros(n_nodes, np.float32)
        w[is_leaf.astype(bool)] = self.word_weight[self.leaf_id[is_leaf.astype(bool)]]
        desc_bytes = self.node_desc.view(np.uint8).reshape(n_nodes, 32)
        cols = np.concatenate(
            [
                parent[1:, None].astype(np.float64),
                is_leaf[1:, None].astype(np.float64),
                desc_bytes[1:].astype(np.float64),
                w[1:, None].astype(np.float64),
            ],
            axis=1,
        )
        with open(path, "w") as f:
            f.write(f"{self.k} {self.depth} 0 0\n")
            np.savetxt(f, cols, fmt=["%d", "%d"] + ["%d"] * 32 + ["%.9g"])

    # ------------------------------------------------------------- lookup

    def to(self, device) -> "Vocabulary":
        """Run `quantize` on `device` from now on (the tree is uploaded once,
        on first use). Returns self."""
        self.device = torch.device(device)
        self.__dict__.pop("_tree", None)
        return self

    def _device_tree(self):
        tree = self.__dict__.get("_tree")
        if tree is None:
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
            tree = (up(self.node_desc.view(np.int32)), up(self.children).long(),
                    up(self.leaf_id), up(_POPCNT8.astype(np.int32)))
            self.__dict__["_tree"] = tree
        return tree

    @labelled("vocab_quantize")
    def quantize(self, desc: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
        """[N, 8] uint32 -> [N] word ids (-1 for invalid), by the descent on
        `device`."""
        node_desc, children, leaf_id, lut = self._device_tree()
        d = torch.from_numpy(np.ascontiguousarray(desc, np.uint32).view(np.int32)).to(self.device)
        words = to_host(quantize_descent(d, node_desc, children, leaf_id, lut, self.depth))
        if valid is not None:
            words = np.where(valid, words, -1)
        return words

    def bow_vector(self, desc: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
        """Dense L1-normalized tf-idf BoW vector [n_words] float32."""
        words = self.quantize(desc, valid)
        v = np.zeros(self.n_words, np.float32)
        ok = words >= 0
        np.add.at(v, words[ok], self.word_weight[words[ok]])
        s = v.sum()
        return v / s if s > 0 else v


def quantize_descent(desc: torch.Tensor, node_desc: torch.Tensor, children: torch.Tensor,
                     leaf_id: torch.Tensor, lut: torch.Tensor, depth: int) -> torch.Tensor:
    """The L-level descent of `_quantize_impl` (vocabulary.py:319-344 of the
    JAX package): [N, 8] int32 descriptor words -> [N] int32 word ids. Each
    level takes the child at the least Hamming distance (the first of equals;
    a missing child counts 10,000) and stays put at a leaf."""
    n = desc.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=desc.device)
    for _ in range(depth):
        ch = children[node]  # [N, k]
        cd = node_desc[torch.clamp(ch, min=0)]  # [N, k, 8]
        x = torch.bitwise_xor(desc[:, None, :], cd).contiguous()
        d = lut[x.view(torch.uint8).long()].sum(-1)  # [N, k] bit counts
        d = torch.where(ch >= 0, d, 10_000)
        nxt = torch.gather(ch, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
        node = torch.where(nxt >= 0, nxt, node)
    return leaf_id[node]


def bow_l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score: 1 - 0.5 * |v1 - v2|_1 for L1-normalized vectors.

    Broadcasts: v1 [V] vs v2 [B, V] -> [B]; [A, V] vs [B, V] -> [A, B] when
    v1 has an explicit middle axis.
    """
    if v1.dim() == 1:
        return 1.0 - 0.5 * torch.abs(v1[None, :] - v2).sum(-1)
    return 1.0 - 0.5 * torch.abs(v1[:, None, :] - v2[None, :, :]).sum(-1)
