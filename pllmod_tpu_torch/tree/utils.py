"""Tree utilities: collapse, resolve, rooting, serialization, support.

Host-side port (a copy of the JAX package's module) of the remaining
``src/tree/pll_tree.c`` surface:

- collapse short branches into multifurcations (pll_tree.c:448-530),
- random resolution of multifurcations (pll_tree.c:295-388, 1986-2085),
- outgroup rooting point lookup via splits (pll_tree.c:531-701),
- serialize/expand a tree to a flat byte blob — the reference's
  "MPI-able node array" (pll_tree.c:1509-1573); here the array encoding
  IS already flat, so the blob is a framed dump of the arrays,
- draw support values into (inner) node labels for Newick export
  (pllmod_utree_draw_support, pll_tree.c:1306-...),
- pllmod_utree_compute_lk convenience (p-matrices + partials + edge logL).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from pllmod_tpu_torch.common import (TreeError, TREE_ERROR_INVALID_TREE,
                                     TREE_ERROR_POLYPHYL_OUTGROUP)
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree import splits as sp


def collapse_short_branches(tree: Tree, min_length: float) -> Tree:
    """Collapse inner edges with length < min_length into multifurcations.
    Returns a new tree (possibly multifurcating)."""
    t = tree.copy()
    changed = True
    while changed:
        changed = False
        for e, (u, v) in enumerate(t.edge_nodes):
            u, v = int(u), int(v)
            if u < 0 or t.is_tip(u) or t.is_tip(v):
                continue
            if t.lengths[e] < min_length:
                # merge v into u: reattach all v's other edges to u
                for nbr, e2 in list(t.neighbors(v)):
                    if e2 == e:
                        continue
                    a, b = (int(x) for x in t.edge_nodes[e2])
                    t.edge_nodes[e2] = (u, b) if a == v else (a, u)
                t.edge_nodes[e] = (-1, -1)
                t.invalidate()
                changed = True
                break
    return t


def resolve_multifurcations(tree: Tree, seed: int | None = None,
                            default_brlen: float = 0.0) -> Tree:
    """Randomly resolve every multifurcation into binary nodes
    (pllmod_utree_resolve_multi semantics: random pairing of subnodes)."""
    rng = np.random.default_rng(seed)
    t = tree.copy()
    edges = [list(map(int, r)) for r in t.edge_nodes if r[0] >= 0]
    lengths = [float(t.lengths[e]) for e, r in enumerate(t.edge_nodes)
               if r[0] >= 0]
    next_node = t.n_nodes
    work = True
    while work:
        work = False
        adj = {}
        for k, (u, v) in enumerate(edges):
            adj.setdefault(u, []).append(k)
            adj.setdefault(v, []).append(k)
        for node, inc in adj.items():
            if node < t.n_tips or len(inc) <= 3:
                continue
            # pick two random incident edges, hang them off a new node
            pick = rng.choice(len(inc), 2, replace=False)
            e1, e2 = inc[int(pick[0])], inc[int(pick[1])]
            w = next_node
            next_node += 1
            for ek in (e1, e2):
                a, b = edges[ek]
                edges[ek] = [w, b] if a == node else [a, w]
            edges.append([node, w])
            lengths.append(default_brlen)
            work = True
            break
    out = Tree(t.n_tips, t.labels, np.array(edges, np.int32),
               np.array(lengths), n_nodes=next_node)
    out.check_integrity()
    return out


def outgroup_edge(tree: Tree, outgroup_labels) -> int:
    """Find the edge whose split separates exactly the outgroup taxa
    (pllmod_utree_root_inplace / outgroup rooting, pll_tree.c:531-701).
    Raises POLYPHYL_OUTGROUP if the outgroup is not monophyletic."""
    want_ids = [tree.labels.index(l) for l in outgroup_labels]
    if len(want_ids) == 1:
        # trivial: the tip's pendant edge
        t = want_ids[0]
        ((_, e),) = tree.neighbors(t)
        return e
    want = sp.split_from_tips(want_ids, tree.n_tips)
    all_splits, edge_ids = sp.tree_splits(tree)
    key = sp.split_key(want)
    for s, e in zip(all_splits, edge_ids):
        if sp.split_key(s) == key:
            return int(e)
    raise TreeError(TREE_ERROR_POLYPHYL_OUTGROUP,
                    f"outgroup {outgroup_labels} is not monophyletic")


def serialize_tree(tree: Tree) -> bytes:
    """Flat byte blob (create_serialized_tree analog)."""
    out = io.BytesIO()
    labels = "\x00".join(tree.labels).encode()
    out.write(struct.pack("<III", tree.n_tips, tree.n_nodes, len(labels)))
    out.write(labels)
    en = np.ascontiguousarray(tree.edge_nodes, np.int32)
    ln = np.ascontiguousarray(tree.lengths, np.float64)
    out.write(struct.pack("<I", en.shape[0]))
    out.write(en.tobytes())
    out.write(ln.tobytes())
    return out.getvalue()


def expand_tree(blob: bytes) -> Tree:
    """Inverse of :func:`serialize_tree` (pllmod_utree_expand)."""
    inp = io.BytesIO(blob)
    n_tips, n_nodes, lab_len = struct.unpack("<III", inp.read(12))
    labels = inp.read(lab_len).decode().split("\x00")
    (n_edges,) = struct.unpack("<I", inp.read(4))
    en = np.frombuffer(inp.read(n_edges * 8), np.int32).reshape(-1, 2)
    ln = np.frombuffer(inp.read(n_edges * 8), np.float64)
    return Tree(n_tips, labels, en.copy(), ln.copy(), n_nodes=n_nodes)


def newick_with_support(tree: Tree, supports: dict, precision: int = 6,
                        as_fraction: bool = False) -> str:
    """Newick string with support values as inner-node labels
    (pllmod_utree_draw_support semantics: support of the edge above each
    inner node)."""
    adj = tree.adjacency()
    root = next(n for n in range(tree.n_tips, tree.n_nodes) if adj[n])

    def fmt_sup(v):
        return f"{v:.6g}" if as_fraction else f"{int(round(v * 100))}"

    out = io.StringIO()

    def rec(node, parent, pedge):
        if tree.is_tip(node):
            out.write(tree.labels[node])
        else:
            out.write("(")
            first = True
            for nbr, e in adj[node]:
                if nbr == parent:
                    continue
                if not first:
                    out.write(",")
                rec(nbr, node, e)
                first = False
            out.write(")")
            if pedge >= 0 and pedge in supports:
                out.write(fmt_sup(supports[pedge]))
        if pedge >= 0:
            out.write(f":{tree.lengths[pedge]:.{precision}f}")

    rec(root, -1, -1)
    out.write(";")
    return out.getvalue()


def set_length(tree: Tree, edge: int, length: float) -> None:
    """Set one branch length (pllmod_utree_set_length, pll_tree.h:568)."""
    if tree.edge_nodes[edge, 0] < 0:
        raise TreeError(TREE_ERROR_INVALID_TREE, f"edge {edge} is dead")
    tree.lengths[edge] = length


def set_length_recursive(tree: Tree, length: float,
                         missing_only: bool = False) -> None:
    """Set every branch length, or only unset (<= 0) ones
    (pllmod_utree_set_length_recursive, pll_tree.c:1388-1408)."""
    live = tree.edge_nodes[:, 0] >= 0
    if missing_only:
        live &= tree.lengths <= 0.0
    tree.lengths[live] = length


def scale_branches(tree: Tree, factor: float) -> None:
    """Multiply every branch length by ``factor`` in place
    (pllmod_utree_scale_branches / _all, pll_tree.c)."""
    live = tree.edge_nodes[:, 0] >= 0
    tree.lengths[live] *= factor


def scale_subtree_branches(tree: Tree, edge: int, node: int,
                           factor: float) -> None:
    """Scale ``edge`` plus every branch in the subtree on ``node``'s side
    of it (pllmod_utree_scale_subtree_branches: the directed unode's edge
    and everything below it)."""
    u, v = (int(x) for x in tree.edge_nodes[edge])
    if node not in (u, v):
        raise TreeError(TREE_ERROR_INVALID_TREE,
                        f"node {node} is not an endpoint of edge {edge}")
    tree.lengths[edge] *= factor
    for _n, _p, pedge in tree.postorder(node, avoid_edge=edge):
        if pedge >= 0:
            tree.lengths[pedge] *= factor


def compute_lk(partition, tree: Tree) -> float:
    """pllmod_utree_compute_lk: p-matrices + partials + edge logL."""
    from pllmod_tpu_torch.ops.engine import tree_loglikelihood
    return float(tree_loglikelihood(partition, tree))


def nodes_at_node_dist(tree: Tree, node: int, min_dist: int, max_dist: int):
    """Nodes within BFS distance [min_dist, max_dist] of ``node`` — the
    SPR regraft-candidate generator (pllmod_utree_nodes_at_node_dist,
    utree_operations.c:389-457). Returns a sorted list of node ids; the
    start node itself is excluded."""
    adj = tree.adjacency()
    out = []
    seen = {node}
    frontier = [(node, 0)]
    while frontier:
        u, d = frontier.pop()
        if d >= max_dist:
            continue
        for nbr, _e in adj[u]:
            if nbr in seen:
                continue
            seen.add(nbr)
            if d + 1 >= min_dist:
                out.append(nbr)
            frontier.append((nbr, d + 1))
    return sorted(out)


def nodes_at_edge_dist(tree: Tree, edge: int, min_dist: int, max_dist: int):
    """Nodes within BFS distance of an EDGE (both endpoints at distance
    0 — pllmod_utree_nodes_at_edge_dist, utree_operations.c:459-503)."""
    u, v = (int(x) for x in tree.edge_nodes[edge])
    if u < 0:
        raise TreeError(TREE_ERROR_INVALID_TREE, f"edge {edge} is dead")
    adj = tree.adjacency()
    out = []
    seen = {u, v}
    frontier = [(u, 0), (v, 0)]
    while frontier:
        x, d = frontier.pop()
        if d >= max_dist:
            continue
        for nbr, _e in adj[x]:
            if nbr in seen:
                continue
            seen.add(nbr)
            if d + 1 >= min_dist:
                out.append(nbr)
            frontier.append((nbr, d + 1))
    return sorted(out)
