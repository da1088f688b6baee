"""Bipartitions (splits), RF distance, split hashtables.

Host-side port (a copy of the JAX package's module) of
``src/tree/utree_distances.c`` (840 LoC) + ``tree_hashtable.c`` (455
LoC). A split is a bit vector over tips (``pll_split_t``); here the
whole split SET is one ``uint64 [n_splits, n_words]`` matrix, so
extraction, normalization, comparison, Hamming distances and TBE scans
are vectorized numpy (``np.bitwise_count`` — the host-native analog of
the reference's hand-rolled popcount tables).

Conventions preserved from the reference:
- one split per inner edge; trivial (tip) splits excluded,
- normalization: the side containing tip 0 is the zero side
  (utree_distances.c:396-540 normalization "first bit = 0"),
- RF distance = 2·(n−3−shared) for binary trees
  (pllmod_utree_rf_distance, utree_distances.c:200-263),
- the split "hashtable" is keyed by the split's bytes; it stores support
  counts + per-tree presence exactly like ``bitv_hashtable``
  (tree_hashtable.h:25-88).
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import (TreeError, TREE_ERROR_INVALID_SPLIT,
                                     TREE_ERROR_EMPTY_SPLIT,
                                     TREE_ERROR_INVALID_TREE)


def n_words(n_tips: int) -> int:
    return (n_tips + 63) // 64


def popcount(x: np.ndarray) -> np.ndarray:
    """Popcount summed over the word axis."""
    return np.bitwise_count(x).sum(axis=-1).astype(np.int64)


def tip_mask(n_tips: int) -> np.ndarray:
    """All-ones over the valid tip bits."""
    w = n_words(n_tips)
    m = np.zeros(w, np.uint64)
    full, rem = divmod(n_tips, 64)
    m[:full] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if rem:
        m[full] = np.uint64((1 << rem) - 1)
    return m


def normalize(splits: np.ndarray, n_tips: int) -> np.ndarray:
    """Flip splits so tip 0's bit is clear (canonical side)."""
    splits = np.atleast_2d(splits).astype(np.uint64)
    mask = tip_mask(n_tips)
    has_zero = (splits[:, 0] & np.uint64(1)).astype(bool)
    out = splits.copy()
    out[has_zero] = (~splits[has_zero]) & mask
    return out


def tree_splits(tree, include_tips: bool = False):
    """Extract normalized splits for every (inner) edge.

    Returns (splits uint64 [k, W], edge_ids int [k]) in edge-id order.
    Equivalent of pllmod_utree_split_create (cb_get_splits post-order
    merge, utree_distances.c:396-470).
    """
    nt = tree.n_tips
    W = n_words(nt)
    node_split = np.zeros((tree.n_nodes, W), np.uint64)
    for t in range(nt):
        node_split[t, t // 64] = np.uint64(1) << np.uint64(t % 64)

    # root on any inner node; accumulate subtree tip sets post-order
    adj = tree.adjacency()
    root = next(n for n in range(nt, tree.n_nodes) if adj[n])
    order = tree.postorder(root)
    edge_split = {}
    for node, parent, pedge in order:
        if node >= nt:
            acc = np.zeros(W, np.uint64)
            for nbr, e in adj[node]:
                if nbr == parent:
                    continue
                acc |= node_split[nbr]
            node_split[node] = acc
        if pedge >= 0:
            edge_split[pedge] = node_split[node].copy()

    rows, ids = [], []
    mask = tip_mask(nt)
    for e, (u, v) in enumerate(tree.edge_nodes):
        if int(u) < 0 or e not in edge_split:
            continue
        s = edge_split[e]
        pc = int(np.bitwise_count(s).sum())
        if not include_tips and (pc <= 1 or pc >= nt - 1):
            continue  # trivial split
        rows.append(s)
        ids.append(e)
    if not rows:
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    return normalize(np.stack(rows), nt), np.asarray(ids)


def split_key(split: np.ndarray) -> bytes:
    return split.astype(np.uint64).tobytes()


def split_set(splits: np.ndarray) -> set[bytes]:
    return {split_key(s) for s in np.atleast_2d(splits)}


def rf_distance(tree1, tree2) -> int:
    """Robinson-Foulds distance (pllmod_utree_rf_distance semantics:
    2·(n−3−shared) for binary trees; generally |S1|+|S2|−2|S1∩S2|)."""
    if tree1.n_tips != tree2.n_tips:
        raise TreeError(TREE_ERROR_INVALID_TREE, "tip counts differ")
    if tree1.labels != tree2.labels:
        from pllmod_tpu_torch.tree.topology import set_tip_order
        tree2 = set_tip_order(tree2, tree1.labels)
    s1, _ = tree_splits(tree1)
    s2, _ = tree_splits(tree2)
    return rf_distance_splits(s1, s2)


def rf_distance_splits(s1: np.ndarray, s2: np.ndarray) -> int:
    """RF from two normalized split matrices (pllmod_utree_split_rf_distance)."""
    from pllmod_tpu_torch import native
    if native.available() and len(s1) and len(s2):
        shared = native.shared_splits(s1, s2)
        return len(s1) + len(s2) - 2 * shared
    a = split_set(s1)
    b = split_set(s2)
    return len(a) + len(b) - 2 * len(a & b)


def max_rf_distance(n_tips: int) -> int:
    return 2 * (n_tips - 3)


def hamming_distance(a: np.ndarray, b: np.ndarray, n_tips: int) -> int:
    """min(d, n−d) Hamming distance between two splits
    (utree_distances.c:347-389)."""
    d = int(np.bitwise_count(a ^ b).sum())
    return min(d, n_tips - d)


def split_from_tips(tip_ids, n_tips: int) -> np.ndarray:
    """Build a normalized split from a tip-id list
    (pllmod_utree_split_from_tips)."""
    s = np.zeros(n_words(n_tips), np.uint64)
    for t in tip_ids:
        if not (0 <= t < n_tips):
            raise TreeError(TREE_ERROR_INVALID_SPLIT, f"tip {t} out of range")
        s[t // 64] |= np.uint64(1) << np.uint64(t % 64)
    if not s.any():
        raise TreeError(TREE_ERROR_EMPTY_SPLIT, "empty split")
    return normalize(s[None], n_tips)[0]


def lightside(split: np.ndarray, n_tips: int) -> int:
    """Size of the smaller side of a split
    (pllmod_utree_split_lightside, utree_distances.c:347-389)."""
    c = int(np.bitwise_count(np.asarray(split, np.uint64)).sum())
    return min(c, n_tips - c)


def show_split(split: np.ndarray, n_tips: int) -> str:
    """Render a split as the reference does (pllmod_utree_split_show,
    utree_distances.c): one char per tip, tip 0 first, '*' = in the
    split's one-side, '-' = zero-side."""
    split = np.asarray(split, np.uint64)
    return "".join(
        "*" if (int(split[t // 64]) >> (t % 64)) & 1 else "-"
        for t in range(n_tips))


def compatible(a: np.ndarray, b: np.ndarray, n_tips: int) -> bool:
    """Split compatibility: one of the four intersections A∩B, A∩~B,
    ~A∩B, ~A∩~B is empty (consensus.c:61-107)."""
    mask = tip_mask(n_tips)
    na = (~a) & mask
    nb = (~b) & mask
    return (not (a & b).any() or not (a & nb).any()
            or not (na & b).any() or not (na & nb).any())


class SplitHashtable:
    """Split set with support counts + per-tree presence
    (bitv_hashtable, tree_hashtable.c). Keys are split bytes."""

    def __init__(self, n_tips: int):
        self.n_tips = n_tips
        self.entries: dict[bytes, dict] = {}

    def __len__(self):
        return len(self.entries)

    def insert(self, split: np.ndarray, support: float = 1.0,
               tree_index: int | None = None):
        k = split_key(split)
        e = self.entries.get(k)
        if e is None:
            e = {"split": np.array(split, np.uint64), "support": 0.0,
                 "trees": set()}
            self.entries[k] = e
        e["support"] += support
        if tree_index is not None:
            e["trees"].add(tree_index)
        return e

    def lookup(self, split: np.ndarray):
        return self.entries.get(split_key(split))

    def remove(self, split: np.ndarray):
        return self.entries.pop(split_key(split), None)

    def update(self, splits: np.ndarray, support: float = 1.0,
               tree_index: int | None = None):
        for s in np.atleast_2d(splits):
            self.insert(s, support, tree_index)

    def as_arrays(self):
        """(splits [k, W], supports [k]) sorted by support descending."""
        items = sorted(self.entries.values(), key=lambda e: -e["support"])
        if not items:
            return (np.zeros((0, n_words(self.n_tips)), np.uint64),
                    np.zeros(0))
        return (np.stack([e["split"] for e in items]),
                np.array([e["support"] for e in items]))
