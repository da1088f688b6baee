"""Starting trees: random stepwise addition + parsimony stepwise addition.

Host-side port (a copy of the JAX package's module) of the reference's
starting-tree machinery:

- random tree by stepwise random insertion
  (``pllmod_utree_create_random`` / ``utree_insert_tips_random``,
  pll_tree.c:703-981),
- Fitch parsimony scoring, vectorized over sites as bitmask AND/OR over
  ``uint64 [sites]`` arrays — the host-native analog of libpll's
  SSE/AVX popcount kernels (``pll_fastparsimony_*``, SURVEY §2.9),
- parsimony starting tree by greedy stepwise addition: each new taxon is
  scored against ALL current edges at once using directed Fitch state
  sets (one vectorized pass per insertion — the same
  directed-two-pass trick the likelihood BLO uses),
- multi-partition parsimony trees sum scores across partitions
  (pllmod_utree_create_parsimony, pll_tree.c:987-1108).

The Fitch scoring, the directed Fitch sets and the stepwise addition run
in the port's native library (``native.py``) when it loaded, else in
the Python fallbacks below; both give the same trees and scores.
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import TreeError, TREE_ERROR_INVALID_TREE_SIZE
from pllmod_tpu_torch.tree.topology import Tree


def random_tree(labels, seed: int | None = None,
                default_brlen: float = 0.1) -> Tree:
    """Random unrooted binary tree by stepwise random addition."""
    n = len(labels)
    if n < 3:
        raise TreeError(TREE_ERROR_INVALID_TREE_SIZE, "need >= 3 taxa")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    edges = [[order[0], n], [order[1], n], [order[2], n]]
    next_inner = n + 1
    for tip in order[3:]:
        e = int(rng.integers(len(edges)))
        u, v = edges[e]
        w = next_inner
        next_inner += 1
        edges[e] = [u, w]
        edges.append([w, v])
        edges.append([int(tip), w])
    lengths = np.full(len(edges), default_brlen)
    return Tree(n, list(labels), np.array(edges, np.int32), lengths,
                n_nodes=next_inner)


# ---------------------------------------------------------------------------
# Fitch parsimony (vectorized over sites)
# ---------------------------------------------------------------------------
def _tip_masks(sequences, charmap):
    m = np.stack([charmap.table[np.frombuffer(
        s.encode() if isinstance(s, str) else s, np.uint8)]
        for s in sequences])
    return m  # uint64 [tips, sites]


def _fitch_ops(tree: Tree) -> np.ndarray:
    """Postorder pairwise-combine schedule for the native Fitch kernel:
    rows (unused, childA, childB); ids < n_tips are tips, else scratch
    row (id − n_tips). Multifurcations chain pairwise."""
    n_tips = tree.n_tips
    adj = tree.adjacency()
    root = next(n for n in range(n_tips, tree.n_nodes) if adj[n])
    rows = []
    tmp_of = {}
    for node, parent, _e in tree.postorder(root):
        if node < n_tips:
            tmp_of[node] = node
            continue
        kids = [tmp_of[nbr] for nbr, e in adj[node] if nbr != parent]
        acc = kids[0]
        for k in kids[1:]:
            rows.append([0, acc, k])
            acc = n_tips + len(rows) - 1
        tmp_of[node] = acc
    return np.asarray(rows, np.int32).reshape(-1, 3)


def parsimony_score(tree: Tree, sequences, charmap,
                    pattern_weights=None) -> int:
    """Fitch parsimony score (pll_parsimony semantics): post-order
    intersection/union over site bitmasks; +weight per empty
    intersection. Uses the native C++ kernel when built."""
    masks = _tip_masks(sequences, charmap)
    n_tips, n_sites = masks.shape
    w = (np.ones(n_sites) if pattern_weights is None
         else np.asarray(pattern_weights, float))
    from pllmod_tpu_torch import native
    if native.available():
        return int(round(native.fitch_score(masks, _fitch_ops(tree), w)))
    adj = tree.adjacency()
    root = next(n for n in range(n_tips, tree.n_nodes) if adj[n])
    node_set = {t: masks[t] for t in range(n_tips)}
    score = 0.0
    for node, parent, _e in tree.postorder(root):
        if node < n_tips:
            continue
        acc = None
        for nbr, e in adj[node]:
            if nbr == parent:
                continue
            child = node_set[nbr]
            if acc is None:
                acc = child
                continue
            inter = acc & child
            empty = inter == 0
            score += float((w * empty).sum())
            acc = np.where(empty, acc | child, inter)
        node_set[node] = acc
    return int(round(score))


def _directed_fitch_sets(tree: Tree, masks: np.ndarray):
    """Fitch state set of each side of every edge: {edge: (set_u, set_v)}
    following edge_nodes order — the parsimony analog of directed CLVs."""
    n_tips = masks.shape[0]
    adj = tree.adjacency()

    def fitch2(a, b):
        inter = a & b
        return np.where(inter == 0, a | b, inter)

    # up sets: root at first live tip
    root_tip = next(t for t in range(n_tips) if adj[t])
    (r, e0), = adj[root_tip]
    up = {}  # (node, toward_parent_node) -> set

    order = tree.postorder(r, avoid_edge=e0)
    for node, parent, pedge in order:
        par = parent if parent != -1 else root_tip
        if node < n_tips:
            up[(node, par)] = masks[node]
            continue
        acc = None
        for nbr, e in adj[node]:
            if nbr == par:
                continue
            s = up[(nbr, node)]
            acc = s if acc is None else fitch2(acc, s)
        up[(node, par)] = acc
    up[(root_tip, r)] = masks[root_tip]

    # down sets via preorder
    stack = [(r, root_tip)]
    while stack:
        u, par = stack.pop()
        if u < n_tips:
            continue
        kids = [(nbr, e) for nbr, e in adj[u] if nbr != par]
        for (c, _e) in kids:
            # set of everything at u except child c: parent side + siblings
            acc = up[(par, u)]
            for o, _ in kids:
                if o != c:
                    acc = fitch2(acc, up[(o, u)])
            up[(u, c)] = acc
            stack.append((c, u))
    return up


def _directed_fitch_edge_sets(tree: Tree, masks: np.ndarray):
    """Array form of :func:`_directed_fitch_sets`: (A, B) uint64 [E, S]
    with A[e] = the Fitch set of ``edge_nodes[e, 0]``'s side (toward
    node 1) and B[e] the reverse — edge-indexed so insertion/regraft
    cost scans vectorize over ALL edges at once instead of a python
    loop. Native C++ when built (pllmod_directed_fitch_sets)."""
    from pllmod_tpu_torch import native
    if native.available():
        return native.directed_fitch_sets(tree.edge_nodes, tree.n_tips,
                                          tree.n_nodes, masks)
    up = _directed_fitch_sets(tree, masks)
    E = len(tree.edge_nodes)
    S = masks.shape[1]
    A = np.zeros((E, S), np.uint64)
    B = np.zeros((E, S), np.uint64)
    for e, (u, v) in enumerate(tree.edge_nodes):
        u, v = int(u), int(v)
        if u < 0:
            continue
        A[e] = up[(u, v)]
        B[e] = up[(v, u)]
    return A, B


def _edge_insertion_costs(A, B, tip_mask, w):
    """cost[e] = Σ_sites w·[(fitch2(A[e],B[e]) & tip_mask) == 0] for all
    edges at once."""
    inter = A & B
    es = np.where(inter == 0, A | B, inter)
    return ((es & tip_mask[None, :]) == 0) @ w


def parsimony_stepwise(labels, sequences, charmap, seed: int | None = None,
                       pattern_weights=None,
                       default_brlen: float = 0.1) -> tuple[Tree, int]:
    """Greedy stepwise-addition parsimony tree
    (pll_fastparsimony_stepwise analog). Returns (tree, score).

    Insertion cost of tip t at edge e uses the Fitch set of the edge
    (intersection of the two directed sets, or union when disjoint):
    +w where the tip's mask does not intersect it.
    """
    n = len(labels)
    if n < 3:
        raise TreeError(TREE_ERROR_INVALID_TREE_SIZE, "need >= 3 taxa")
    rng = np.random.default_rng(seed)
    masks = _tip_masks(sequences, charmap)
    n_sites = masks.shape[1]
    w = (np.ones(n_sites) if pattern_weights is None
         else np.asarray(pattern_weights, float))

    order = rng.permutation(n)
    from pllmod_tpu_torch import native
    if n > 3 and native.available():
        # native stepwise: same greedy rule + tie-breaking, all-in-cache
        # C++ (the 1k-taxa python loop was 65 s of the search start —
        # round-4 VERDICT item 4; native ~0.5 s)
        edges = native.parsimony_stepwise(masks, w,
                                          order.astype(np.int32))
        tree = Tree(n, list(labels), edges,
                    np.full(len(edges), default_brlen),
                    n_nodes=n + (n - 2))
        score = parsimony_score(tree, sequences, charmap,
                                pattern_weights)
        return tree, score
    t0, t1, t2 = (int(x) for x in order[:3])
    edges = [[t0, n], [t1, n], [t2, n]]
    next_inner = n + 1
    tree = Tree(n, list(labels), np.array(edges, np.int32),
                np.full(3, default_brlen), n_nodes=next_inner)
    present = {t0, t1, t2}

    for tip in order[3:]:
        tip = int(tip)
        up = _directed_fitch_sets(tree, masks)
        live = [e for e in range(len(tree.edge_nodes))
                if tree.edge_nodes[e, 0] >= 0]
        # vectorized cost per edge
        costs = np.empty(len(live))
        tm = masks[tip]
        for k, e in enumerate(live):
            u, v = (int(x) for x in tree.edge_nodes[e])
            a = up[(u, v)]
            b = up[(v, u)]
            inter = a & b
            edge_set = np.where(inter == 0, a | b, inter)
            costs[k] = float((w * ((edge_set & tm) == 0)).sum())
        best = live[int(np.argmin(costs))]
        # insert
        u, v = (int(x) for x in tree.edge_nodes[best])
        wnode = next_inner
        next_inner += 1
        en = tree.edge_nodes.tolist()
        ln = tree.lengths.tolist()
        en[best] = [u, wnode]
        en.append([wnode, v])
        ln.append(default_brlen)
        en.append([tip, wnode])
        ln.append(default_brlen)
        tree = Tree(n, list(labels), np.array(en, np.int32),
                    np.array(ln), n_nodes=next_inner)
        present.add(tip)

    score = parsimony_score(tree, sequences, charmap, pattern_weights)
    return tree, score


def extend_tree_random(tree: Tree, new_labels, seed: int | None = None,
                       default_brlen: float = 0.1) -> Tree:
    """Insert additional taxa into an existing tree at random edges
    (pllmod_utree_extend_random, pll_tree.c:703-981). Returns a NEW tree;
    new tips get ids after the existing ones."""
    rng = np.random.default_rng(seed)
    old_n = tree.n_tips
    n_new = len(new_labels)
    labels = list(tree.labels) + list(new_labels)
    # shift inner node ids up by n_new so tips stay contiguous
    en = tree.edge_nodes.copy()
    en[en >= old_n] += n_new
    edges = [list(map(int, r)) for r in en if r[0] >= 0]
    lengths = [float(l) for r, l in zip(en, tree.lengths) if r[0] >= 0]
    next_inner = tree.n_nodes + n_new
    for k in range(n_new):
        tip = old_n + k
        e = int(rng.integers(len(edges)))
        u, v = edges[e]
        w = next_inner
        next_inner += 1
        half = lengths[e] / 2.0
        edges[e] = [u, w]
        lengths[e] = half
        edges.append([w, v])
        lengths.append(half)
        edges.append([tip, w])
        lengths.append(default_brlen)
    out = Tree(old_n + n_new, labels, np.array(edges, np.int32),
               np.array(lengths), n_nodes=next_inner)
    out.check_integrity()
    return out


def _norm_parts(msas_and_charmaps):
    """[(sequences, charmap, pattern_weights|None)] → [(masks, w, raw)]"""
    out = []
    for seqs, cmap, pw in msas_and_charmaps:
        masks = _tip_masks(seqs, cmap)
        w = (np.ones(masks.shape[1]) if pw is None
             else np.asarray(pw, float))
        out.append((masks, w, (seqs, cmap, pw)))
    return out


def parsimony_score_multi(tree: Tree, msas_and_charmaps) -> int:
    """Fitch score summed over partitions."""
    return sum(parsimony_score(tree, seqs, cmap, pw)
               for seqs, cmap, pw in msas_and_charmaps)


def parsimony_spr_round(tree: Tree, sequences, charmap,
                        pattern_weights=None, epsilon: int = 0,
                        constraint=None):
    """One parsimony SPR round (pll_fastparsimony_stepwise_spr_round
    analog): for every prunable subtree, score re-insertion into every
    remainder edge via directed Fitch sets, apply the best move when it
    lowers the exact Fitch score.

    Returns (tree, score, n_applied). The tree is modified in place.
    """
    return parsimony_spr_round_multi(
        tree, [(sequences, charmap, pattern_weights)], epsilon=epsilon,
        constraint=constraint)


def parsimony_spr_round_multi(tree: Tree, msas_and_charmaps,
                              epsilon: int = 0, constraint=None):
    """Multi-partition parsimony SPR round, optionally restricted to a
    topological constraint (pll_fastparsimony_stepwise_spr_round with a
    clv_index_map — the reference's constrained-resolution path,
    pll_tree.c:1150-1167). A move is kept only when it lowers the summed
    exact Fitch score AND (with a constraint) the resulting topology
    still passes ``constraint.check_tree``.

    Returns (tree, score, n_applied); tree modified in place."""
    from pllmod_tpu_torch.tree import moves as moves_mod

    parts = _norm_parts(msas_and_charmaps)
    score = parsimony_score_multi(tree, [raw for _, _, raw in parts])
    n_applied = 0

    # candidate list up-front (stable edge ids survive applied moves)
    cands = []
    for e, (u, v) in enumerate(tree.edge_nodes):
        u, v = int(u), int(v)
        if u < 0:
            continue
        for junction in (u, v):
            if not tree.is_tip(junction):
                cands.append((e, junction))

    full_AB = None          # per partition (A, B), valid while the
    for prune_edge, junction in cands:          # topology is unchanged
        u, v = (int(x) for x in tree.edge_nodes[prune_edge])
        if u < 0 or junction not in (u, v):
            continue
        nbrs = [(n, e) for n, e in tree.neighbors(junction)
                if e != prune_edge]
        if len(nbrs) != 2:
            continue
        sub_root = u if junction == v else v
        # subtree Fitch set from the full tree's directed sets (cached
        # across candidates; invalidated only by an applied move)
        if full_AB is None:
            full_AB = [_directed_fitch_edge_sets(tree, masks)
                       for masks, _w, _raw in parts]
        side0 = int(tree.edge_nodes[prune_edge, 0]) == sub_root
        S_sets = [masks[sub_root] if tree.is_tip(sub_root)
                  else (A if side0 else B)[prune_edge]
                  for (masks, _w, _raw), (A, B) in zip(parts, full_AB)]

        # remainder tree
        sub_nodes = moves_mod.subtree_nodes(tree, prune_edge, sub_root)
        R = tree.copy()
        moves_mod.prune(R, junction, keep_edge=prune_edge)
        R.edge_nodes[prune_edge] = (-1, -1)
        for e2, (x, y) in enumerate(R.edge_nodes):
            if x >= 0 and int(x) in sub_nodes and int(y) in sub_nodes:
                R.edge_nodes[e2] = (-1, -1)
        R.invalidate()
        try:
            cost = np.zeros(len(R.edge_nodes))
            for (masks, w, _raw), S_set in zip(parts, S_sets):
                A_R, B_R = _directed_fitch_edge_sets(R, masks)
                cost += _edge_insertion_costs(A_R, B_R, S_set, w)
        except Exception:
            continue
        valid = R.edge_nodes[:, 0] >= 0
        valid[[e for _, e in tree.neighbors(junction)]] = False
        cost[~valid] = np.inf
        best_edge = int(np.argmin(cost))
        if not np.isfinite(cost[best_edge]):
            continue
        # verify with the exact score; apply only on real improvement
        snap = tree.snapshot()
        try:
            moves_mod.spr(tree, prune_edge, best_edge, junction=junction)
        except Exception:
            tree.restore(snap)
            continue
        new_score = parsimony_score_multi(tree,
                                          [raw for _, _, raw in parts])
        keep = new_score + epsilon < score
        if keep and constraint is not None:
            keep = constraint.check_tree(tree)
        if keep:
            score = new_score
            n_applied += 1
            full_AB = None        # topology changed: sets are stale
        else:
            tree.restore(snap)
    return tree, score, n_applied


def parsimony_tree_multi(labels, msas_and_charmaps, seed=None,
                         default_brlen: float = 0.1):
    """Multi-partition parsimony starting tree: greedy stepwise addition
    summing insertion costs across partitions (pll_tree.c:987-1108).

    Args:
      msas_and_charmaps: list of (sequences, charmap, pattern_weights|None)
    Returns (tree, total_score)."""
    # build on the concatenation by scoring each partition separately
    seqs_concat = None
    # simple approach: run stepwise on the first partition ordering but
    # score totals across partitions at each step
    n = len(labels)
    rng = np.random.default_rng(seed)
    parts = [(_tip_masks(seqs, cmap),
              np.ones(len(seqs[0])) if pw is None else np.asarray(pw, float))
             for seqs, cmap, pw in msas_and_charmaps]
    order = rng.permutation(n)
    from pllmod_tpu_torch import native
    if n > 3 and native.available():
        # multi-partition == single on the site-concatenation (the
        # insertion cost is per-site separable)
        masks_cat = np.hstack([m for m, _ in parts])
        w_cat = np.concatenate([w for _, w in parts])
        edges = native.parsimony_stepwise(masks_cat, w_cat,
                                          order.astype(np.int32))
        tree = Tree(n, list(labels), edges,
                    np.full(len(edges), default_brlen),
                    n_nodes=n + (n - 2))
        score = sum(parsimony_score(tree, seqs, cmap, pw)
                    for seqs, cmap, pw in msas_and_charmaps)
        return tree, score
    t0, t1, t2 = (int(x) for x in order[:3])
    tree = Tree(n, list(labels),
                np.array([[t0, n], [t1, n], [t2, n]], np.int32),
                np.full(3, default_brlen), n_nodes=n + 1)
    next_inner = n + 1
    for tip in order[3:]:
        tip = int(tip)
        live = [e for e in range(len(tree.edge_nodes))
                if tree.edge_nodes[e, 0] >= 0]
        total = np.zeros(len(live))
        for masks, w in parts:
            up = _directed_fitch_sets(tree, masks)
            tm = masks[tip]
            for k, e in enumerate(live):
                u, v = (int(x) for x in tree.edge_nodes[e])
                a, b = up[(u, v)], up[(v, u)]
                inter = a & b
                es = np.where(inter == 0, a | b, inter)
                total[k] += float((w * ((es & tm) == 0)).sum())
        best = live[int(np.argmin(total))]
        u, v = (int(x) for x in tree.edge_nodes[best])
        wnode = next_inner
        next_inner += 1
        en = tree.edge_nodes.tolist()
        ln = tree.lengths.tolist()
        en[best] = [u, wnode]
        en.append([wnode, v])
        ln.append(default_brlen)
        en.append([tip, wnode])
        ln.append(default_brlen)
        tree = Tree(n, list(labels), np.array(en, np.int32),
                    np.array(ln), n_nodes=next_inner)
    score = sum(parsimony_score(tree, seqs, cmap, pw)
                for seqs, cmap, pw in msas_and_charmaps)
    return tree, score


def extend_tree_parsimony(tree: Tree, new_labels, msas_and_charmaps,
                          seed: int | None = None,
                          default_brlen: float = 0.1):
    """Insert additional taxa into an existing tree by greedy stepwise
    parsimony, scored across partitions
    (pllmod_utree_extend_parsimony_multipart /
    pll_fastparsimony_stepwise_extend, pll_tree.c:1207-1273).

    Args:
      tree: existing tree over the first ``tree.n_tips`` labels
      new_labels: labels to add; new tips get ids after the existing ones
      msas_and_charmaps: [(sequences, charmap, pattern_weights|None)] —
        sequences indexed by FINAL tip id (existing labels' order first,
        then ``new_labels``)
    Returns (new_tree, total_score). Like the reference, every branch
    length of the result is reset to ``default_brlen``
    (set_length_recursive(..., missing_only=0), pll_tree.c:1255-1257)."""
    old_n = tree.n_tips
    n_new = len(new_labels)
    labels = list(tree.labels) + list(new_labels)
    n = old_n + n_new
    parts = _norm_parts(msas_and_charmaps)
    for masks, _w, _raw in parts:
        if masks.shape[0] != n:
            raise TreeError(TREE_ERROR_INVALID_TREE_SIZE,
                            f"need {n} sequences, got {masks.shape[0]}")
    # shift inner node ids up by n_new so tip ids stay contiguous
    en = tree.edge_nodes.copy()
    en[en >= old_n] += n_new
    edges = [list(map(int, r)) for r in en if r[0] >= 0]
    lengths = [float(l) for r, l in zip(en, tree.lengths) if r[0] >= 0]
    next_inner = tree.n_nodes + n_new
    cur = Tree(n, labels, np.array(edges, np.int32),
               np.array(lengths), n_nodes=next_inner)
    rng = np.random.default_rng(seed)
    for tip in (old_n + int(k) for k in rng.permutation(n_new)):
        total = np.zeros(len(cur.edge_nodes))
        for masks, w, _raw in parts:
            A, B = _directed_fitch_edge_sets(cur, masks)
            total += _edge_insertion_costs(A, B, masks[tip], w)
        total[cur.edge_nodes[:, 0] < 0] = np.inf
        best = int(np.argmin(total))
        u, v = (int(x) for x in cur.edge_nodes[best])
        wnode = next_inner
        next_inner += 1
        en2 = cur.edge_nodes.tolist()
        ln2 = cur.lengths.tolist()
        en2[best] = [u, wnode]
        en2.append([wnode, v])
        ln2.append(default_brlen)
        en2.append([tip, wnode])
        ln2.append(default_brlen)
        cur = Tree(n, labels, np.array(en2, np.int32), np.array(ln2),
                   n_nodes=next_inner)
    cur.lengths[:] = default_brlen
    cur.check_integrity()
    score = parsimony_score_multi(cur, [raw for _, _, raw in parts])
    return cur, score


def resolve_multi_parsimony(multi_tree: Tree, msas_and_charmaps,
                            seed: int | None = None,
                            max_spr_rounds: int = 1,
                            default_brlen: float = 0.1):
    """Resolve a multifurcating (constraint) tree into a binary one guided
    by parsimony (pllmod_utree_resolve_parsimony_multipart,
    pll_tree.c:1110-1200): resolve randomly, then — if the input was not
    already binary — run constrained parsimony SPR rounds until the score
    stops improving or ``max_spr_rounds`` is hit. Moves that would break a
    split of the input tree are rejected (the reference enforces this via
    the clv_index_map passed into the libpll SPR round).

    Returns (tree, score)."""
    from pllmod_tpu_torch.tree.utils import (resolve_multifurcations,
                                       set_length_recursive)
    from pllmod_tpu_torch.tree.constraint import Constraint

    was_binary = multi_tree.is_binary()
    t = resolve_multifurcations(multi_tree, seed=seed,
                                default_brlen=default_brlen)
    score = parsimony_score_multi(t, msas_and_charmaps)
    if not was_binary and max_spr_rounds:
        cons = Constraint(multi_tree, t.labels)
        for _ in range(max_spr_rounds):
            best = score
            t, score, n_applied = parsimony_spr_round_multi(
                t, msas_and_charmaps, constraint=cons)
            if not n_applied or score >= best:
                break
    set_length_recursive(t, default_brlen)
    return t, score
