"""Consensus trees: strict / majority-rule / MRE, weighted, from files.

Host-side port (a copy of the JAX package's module) of
``src/tree/consensus.c`` (1,298 LoC + flex/bison split parser).
Semantics preserved:

- threshold ≥ 0.5: majority-rule filter over the split hashtable —
  every kept split occurs in > threshold fraction of trees (strict = 1.0),
- threshold < 0.5: **MRE** — after the majority filter, remaining splits
  are added greedily in support order if pairwise-compatible with the
  accepted set (consensus.c:270-352, 841-901),
- weighted consensus over in-memory trees (weights must sum to 1,
  consensus.c:366-489),
- file/iterator-based consensus streams Newick strings one at a time and
  converts each directly to splits without keeping trees
  (consensus.c:502-634; the flex/bison parser's role is played by the
  host Newick parser + split extraction).

The consensus tree is built from the compatible split system by nesting
clusters (consensus.c:109-268): clusters (split sides not containing tip
0) of a compatible set form a laminar family, so each cluster's parent is
the smallest strictly-containing cluster.
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import (TreeError, TREE_ERROR_INVALID_THRESHOLD)
from pllmod_tpu_torch.tree import splits as sp
from pllmod_tpu_torch.tree.topology import Tree


def consensus_from_splits(split_counts: sp.SplitHashtable, n_trees: float,
                          threshold: float, labels: list[str]):
    """Core consensus: filter + MRE extension + tree building.

    Returns (Tree, supports dict edge_id -> fraction).
    """
    if not (0.0 <= threshold <= 1.0):
        raise TreeError(TREE_ERROR_INVALID_THRESHOLD,
                        f"threshold {threshold} outside [0, 1]")
    n_tips = split_counts.n_tips
    all_splits, supports = split_counts.as_arrays()
    frac = supports / n_trees

    min_support = max(threshold, 0.5)
    keep = [i for i in range(len(all_splits))
            if frac[i] > min_support - 1e-12]
    # strict consensus keeps only 100% splits
    if threshold >= 1.0 - 1e-12:
        keep = [i for i in keep if frac[i] >= 1.0 - 1e-12]
    accepted = [all_splits[i] for i in keep]
    acc_support = [frac[i] for i in keep]

    if threshold < 0.5:
        # MRE greedy extension in support order
        for i in range(len(all_splits)):
            if i in keep:
                continue
            cand = all_splits[i]
            if all(sp.compatible(cand, a, n_tips) for a in accepted):
                accepted.append(cand)
                acc_support.append(frac[i])

    return build_tree_from_splits(np.array(accepted).reshape(-1, sp.n_words(n_tips)),
                                  np.array(acc_support), n_tips, labels)


def build_tree_from_splits(splits_arr: np.ndarray, supports: np.ndarray,
                           n_tips: int, labels: list[str]):
    """Multifurcating tree from a compatible split system
    (consensus.c:109-268, 939-1299). Returns (Tree, {edge_id: support})."""
    k = len(splits_arr)
    sizes = sp.popcount(splits_arr) if k else np.zeros(0, np.int64)
    order = np.argsort(sizes, kind="stable")  # small clusters first

    def members(s):
        out = []
        for t in range(n_tips):
            if s[t // 64] >> np.uint64(t % 64) & np.uint64(1):
                out.append(t)
        return frozenset(out)

    clusters = [members(splits_arr[i]) for i in order]
    csupport = [float(supports[i]) for i in order]

    # parent[i] = smallest cluster strictly containing cluster i
    parent = [-1] * k
    for i in range(k):
        for j in range(i + 1, k):
            if clusters[i] < clusters[j]:
                parent[i] = j
                break

    edges = []
    lengths = []
    edge_support = {}
    node_of_cluster = {}
    next_node = n_tips
    for i in range(k):
        node_of_cluster[i] = next_node
        next_node += 1
    root = next_node
    next_node += 1

    def attach(child_node, parent_node, support=None):
        e = len(edges)
        edges.append((parent_node, child_node))
        lengths.append(0.0)
        if support is not None:
            edge_support[e] = support
        return e

    # tips: directly under their smallest containing cluster, else root
    for t in range(n_tips):
        best = -1
        for i in range(k):
            if t in clusters[i] and (best == -1
                                     or clusters[i] < clusters[best]):
                best = i
        if best >= 0:
            attach(t, node_of_cluster[best])
        else:
            attach(t, root)

    # clusters under their parents
    for i in range(k):
        pn = root if parent[i] == -1 else node_of_cluster[parent[i]]
        attach(node_of_cluster[i], pn, csupport[i])

    tree = Tree(n_tips, labels, np.array(edges, np.int32).reshape(-1, 2),
                np.array(lengths), n_nodes=next_node)
    # the artificial root may have degree 2 (when a single top cluster +
    # tip 0 side); fuse if so to keep unrooted convention
    if tree.degree(root) == 2:
        (a, ea), (b, eb) = tree.neighbors(root)
        supp = edge_support.pop(max(ea, eb), None) or edge_support.pop(
            min(ea, eb), None)
        keep_e, drop_e = min(ea, eb), max(ea, eb)
        tree.edge_nodes[keep_e] = (a, b)
        if supp is not None:
            edge_support[keep_e] = supp
        last = len(tree.edge_nodes) - 1
        if drop_e != last:
            tree.edge_nodes[drop_e] = tree.edge_nodes[last]
            tree.lengths[drop_e] = tree.lengths[last]
            if last in edge_support:
                edge_support[drop_e] = edge_support.pop(last)
        tree.edge_nodes = tree.edge_nodes[:last]
        tree.lengths = tree.lengths[:last]
        tree.invalidate()
    return tree, edge_support


def consensus(trees, threshold: float = 0.5, weights=None):
    """Consensus over in-memory trees (pllmod_utree_consensus /
    pllmod_utree_weight_consensus).

    Args:
      trees: list of Tree with identical label sets
      threshold: 1.0 strict, 0.5 majority, <0.5 MRE
      weights: optional per-tree weights summing to 1
    Returns:
      (Tree, {edge_id: support_fraction})
    """
    if not trees:
        raise TreeError(TREE_ERROR_INVALID_THRESHOLD, "no trees")
    if weights is not None:
        weights = np.asarray(weights, float)
        if abs(weights.sum() - 1.0) > 1e-6:
            raise TreeError(TREE_ERROR_INVALID_THRESHOLD,
                            "weights must sum to 1")
    ref = trees[0]
    from pllmod_tpu_torch.tree.topology import set_tip_order
    table = sp.SplitHashtable(ref.n_tips)
    total = 0.0
    for ti, t in enumerate(trees):
        if t.labels != ref.labels:
            t = set_tip_order(t, ref.labels)
        s, _ = sp.tree_splits(t)
        w = 1.0 if weights is None else float(weights[ti])
        table.update(s, support=w, tree_index=ti)
        total += w
    return consensus_from_splits(table, total, threshold, ref.labels)


def consensus_from_newicks(newick_iter, threshold: float = 0.5):
    """Streaming consensus: Newick strings -> splits, never keeping trees
    (the flex/bison streaming path, consensus.c:502-634)."""
    table = None
    labels = None
    count = 0
    for nw in newick_iter:
        nw = nw.strip()
        if not nw:
            continue
        t = Tree.from_newick(nw)
        if labels is None:
            labels = t.labels
            table = sp.SplitHashtable(t.n_tips)
        elif t.labels != labels:
            from pllmod_tpu_torch.tree.topology import set_tip_order
            t = set_tip_order(t, labels)
        s, _ = sp.tree_splits(t)
        table.update(s, support=1.0, tree_index=count)
        count += 1
    if table is None:
        raise TreeError(TREE_ERROR_INVALID_THRESHOLD, "no trees")
    return consensus_from_splits(table, float(count), threshold, labels)


def consensus_from_file(path, threshold: float = 0.5):
    with open(path) as fh:
        return consensus_from_newicks(fh, threshold)
