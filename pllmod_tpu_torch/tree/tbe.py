"""Transfer Bootstrap Expectation (Lemoine et al., Nature 2018).

Host-side port (a copy of the JAX package's module) of
``src/tree/tbe_functions.c``: per reference branch b with
light side size p, the transfer index over a bootstrap tree T is the
minimum Hamming distance (transfer distance) between b's bipartition and
ANY branch of T (including trivial ones); TBE support = mean over
bootstrap trees of ``1 − δ(b,T)/(p−1)``.

Two engines (see :func:`transfer_index`):

- the naive scan (tbe_functions.c:318-425) vectorized as one
  ``popcount(xor)`` over a [refs, branches, words] broadcast — O(R·B·
  words), fine to ~2k taxa × 100 boot trees (measured 10 s);
- the Nature counting-traversal regime (pllmod_utree_tbe_nature /
  search_mindist, tbe_functions.c:104-147, 255-313): per ref split one
  O(N) pass over the boot tree accumulating light-side taxa per
  subtree — O(R·N) per boot tree independent of bit-width, native C++
  (pllmod_native.cpp pllmod_tbe_mindist), the ≥10k-taxa scale mode.
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.tree import splits as sp


def transfer_distance_matrix(ref_splits: np.ndarray, boot_splits: np.ndarray,
                             n_tips: int) -> np.ndarray:
    """min-Hamming distance of each ref split to each bootstrap split.

    d(a,b) = min(popcount(a^b), n − popcount(a^b)) — both splits
    normalized. Returns int64 [R, B].
    """
    if len(ref_splits) == 0 or len(boot_splits) == 0:
        return np.zeros((len(ref_splits), len(boot_splits)), np.int64)
    from pllmod_tpu_torch import native
    if native.available():
        return native.transfer_distance_matrix(
            ref_splits, boot_splits, n_tips).astype(np.int64)
    x = ref_splits[:, None, :] ^ boot_splits[None, :, :]
    d = np.bitwise_count(x).sum(axis=-1).astype(np.int64)
    return np.minimum(d, n_tips - d)


def transfer_index(ref_splits: np.ndarray, boot_tree, n_tips: int):
    """Minimum transfer distance of each ref split to any branch of the
    bootstrap tree (trivial branches included: distance floor p−1).

    Two engines, same result:
    - counting traversals (native, the reference's Nature-algorithm
      regime — pllmod_utree_tbe_nature, tbe_functions.c:104-147): one
      O(N) pass per ref split accumulating light-side taxa under every
      boot subtree; O(R·N) per boot tree, independent of the split
      bit-width — the scale mode (≥10k taxa × hundreds of boot trees).
    - popcount matrix (naive, tbe_functions.c:318-425 vectorized):
      O(R·B·words), the small-tree / fallback path.
    """
    pop = sp.popcount(ref_splits)
    p = np.minimum(pop, n_tips - pop)
    post = _boot_postorder(boot_tree) if _use_counting(boot_tree) else None
    if post is not None:
        from pllmod_tpu_torch import native
        light = ref_splits.copy()
        heavy = pop > n_tips - pop
        if heavy.any():
            light[heavy] = (~ref_splits[heavy]) & sp.tip_mask(n_tips)
        best = native.tbe_mindist(light, p.astype(np.int32), post,
                                  n_tips, boot_tree.n_nodes)
        return best.astype(np.int64), p
    boot_splits, _ = sp.tree_splits(boot_tree, include_tips=False)
    # trivial boot branches give distance exactly p-1
    best = (p - 1).astype(np.int64)
    if len(boot_splits):
        d = transfer_distance_matrix(ref_splits, boot_splits, n_tips)
        best = np.minimum(best, d.min(axis=1))
    return best, p


def _use_counting(boot_tree) -> bool:
    from pllmod_tpu_torch import native
    return native.available() and boot_tree.is_binary()


def _boot_postorder(boot_tree) -> np.ndarray | None:
    """int32 [n_inner, 3] (node, left, right) postorder triples of the
    boot tree rooted at tip 0's neighbor (every non-trivial split is
    then exactly one inner node's subtree)."""
    adj = boot_tree.adjacency()
    if not adj[0]:
        return None
    (r, e0), = adj[0]
    rows = []
    for node, parent, pedge in boot_tree.postorder(r, avoid_edge=e0):
        if node < boot_tree.n_tips:
            continue
        par = parent if parent != -1 else 0
        kids = [nbr for nbr, e in adj[node]
                if not (nbr == par and (e == pedge or parent == -1
                                        and e == e0))]
        if len(kids) != 2:
            return None
        rows.append([node, kids[0], kids[1]])
    return np.asarray(rows, np.int32).reshape(-1, 3)


def tbe_support(ref_tree, boot_trees):
    """TBE support per inner edge of ``ref_tree``.

    Returns {edge_id: support in [0,1]} (pllmod_utree_tbe_naive driver
    semantics: mean over bootstrap trees of 1 − mindist/(p−1); p=2
    branches get exact-match support only).
    """
    from pllmod_tpu_torch.tree.topology import set_tip_order
    n_tips = ref_tree.n_tips
    ref_splits, edge_ids = sp.tree_splits(ref_tree)
    if len(ref_splits) == 0:
        return {}
    acc = np.zeros(len(ref_splits))
    n = 0
    for bt in boot_trees:
        if bt.labels != ref_tree.labels:
            bt = set_tip_order(bt, ref_tree.labels)
        mindist, p = transfer_index(ref_splits, bt, n_tips)
        denom = np.maximum(p - 1, 1)
        acc += 1.0 - mindist / denom
        n += 1
    support = acc / max(n, 1)
    return {int(e): float(s) for e, s in zip(edge_ids, support)}


def fbp_support(ref_tree, boot_trees):
    """Classic Felsenstein bootstrap proportions (exact split matches)."""
    from pllmod_tpu_torch.tree.topology import set_tip_order
    ref_splits, edge_ids = sp.tree_splits(ref_tree)
    keys = [sp.split_key(s) for s in ref_splits]
    counts = np.zeros(len(keys))
    n = 0
    for bt in boot_trees:
        if bt.labels != ref_tree.labels:
            bt = set_tip_order(bt, ref_tree.labels)
        bs, _ = sp.tree_splits(bt)
        bset = sp.split_set(bs)
        for i, k in enumerate(keys):
            if k in bset:
                counts[i] += 1
        n += 1
    return {int(e): float(c / max(n, 1)) for e, c in zip(edge_ids, counts)}
