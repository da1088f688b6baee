"""Topology rearrangement moves: SPR, NNI, TBR + rollback.

Host-side port (a copy of the JAX package's module) of the reference's
move machinery (``src/tree/pll_tree.c:72-288``,
``src/tree/utree_operations.c:69-374``) on the array-encoded
:class:`~pllmod_tpu_torch.tree.topology.Tree`. Semantics preserved:

- **prune** removes a degree-3 junction ``u`` and fuses its two remaining
  edges into one whose length is the **sum** (utree_operations.c prune),
- **regraft** splits the target edge in **half**, inserting ``u`` back
  (utree_operations.c regraft),
- **NNI** swaps one subtree from each side of an internal edge
  (PLL_UTREE_MOVE_NNI_LEFT/RIGHT),
- **TBR** bisects an internal edge and reconnects one edge from each
  resulting subtree, with the reference's validity checks (no leaf
  bisection, reconnection edges must lie in different subtrees and not
  touch the bisected edge; error codes ``pll_tree.h:37-60``),
- every move returns a :class:`Rollback` that restores the exact previous
  topology **and** branch lengths (``pllmod_tree_rollback``); because the
  tree is array-encoded, rollback is just an array restore.

Edge ids are stable under all moves (SURVEY design: edge id == pmatrix
index), so jitted likelihood functions never recompile after a move.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pllmod_tpu_torch.common import (
    TreeError,
    TREE_ERROR_NNI_INVALID_MOVE,
    TREE_ERROR_SPR_INVALID_NODE,
    TREE_ERROR_TBR_LEAF_BISECTION,
    TREE_ERROR_TBR_OVERLAPPED_NODES,
    TREE_ERROR_TBR_SAME_SUBTREE,
    TREE_ERROR_INVALID_REARRAGE,
)
from pllmod_tpu_torch.tree.topology import Tree

NNI_LEFT = 1
NNI_RIGHT = 2


@dataclasses.dataclass
class Rollback:
    """Undo record (pll_tree_rollback_t analog, pll_tree.h:154-189)."""
    move_type: str
    edge_nodes: np.ndarray
    lengths: np.ndarray
    n_nodes: int

    def apply(self, tree: Tree) -> None:
        tree.restore((self.edge_nodes, self.lengths, self.n_nodes))


def _snapshot(tree: Tree, move_type: str) -> Rollback:
    en, ln, nn = tree.snapshot()
    return Rollback(move_type, en, ln, nn)


def _other_end(tree: Tree, edge: int, node: int) -> int:
    a, b = tree.edge_nodes[edge]
    return int(b) if int(a) == node else int(a)


def subtree_nodes(tree: Tree, edge: int, side: int) -> set[int]:
    """All nodes on ``side``'s side of ``edge`` (side excluded edge)."""
    seen = {side}
    stack = [side]
    adj = tree.adjacency()
    while stack:
        n = stack.pop()
        for nbr, e in adj[n]:
            if e != edge and nbr not in seen:
                seen.add(nbr)
                stack.append(nbr)
    return seen


# ---------------------------------------------------------------------------
# prune / regraft primitives (utree_operations.c:69-374)
# ---------------------------------------------------------------------------
def prune(tree: Tree, junction: int, keep_edge: int):
    """Remove degree-3 ``junction``, keeping the subtree attached via
    ``keep_edge`` dangling from it. The junction's other two edges fuse
    into one (length = sum), and the freed edge slot id is returned.

    Returns (freed_edge_id, fused_edge_id)."""
    # direct edge-array scan: junction's incident edges without building
    # (or invalidating) the full adjacency — prune runs once per SPR
    # candidate host build, where the O(n) python adjacency rebuild was
    # the measured cost (same (nbr, edge) order: ascending edge id)
    en = tree.edge_nodes
    rows = np.nonzero((en[:, 0] == junction) | (en[:, 1] == junction))[0]
    nbrs = [(int(en[e, 1] if en[e, 0] == junction else en[e, 0]), int(e))
            for e in rows if e != keep_edge]
    if tree.is_tip(junction) or len(nbrs) != 2:
        raise TreeError(TREE_ERROR_SPR_INVALID_NODE,
                        f"cannot prune at node {junction}")
    (a, ea), (b, eb) = nbrs
    fused_len = tree.lengths[ea] + tree.lengths[eb]
    tree.edge_nodes[ea] = (a, b)
    tree.lengths[ea] = fused_len
    tree.edge_nodes[eb] = (-1, -1)
    tree.invalidate()
    return eb, ea


def regraft(tree: Tree, junction: int, free_edge: int, target_edge: int):
    """Insert ``junction`` into the middle of ``target_edge``, reusing
    ``free_edge`` as the second half. Each half gets half the length
    (utree_operations.c regraft convention)."""
    x, y = (int(v) for v in tree.edge_nodes[target_edge])
    half = tree.lengths[target_edge] / 2.0
    tree.edge_nodes[target_edge] = (x, junction)
    tree.lengths[target_edge] = half
    tree.edge_nodes[free_edge] = (junction, y)
    tree.lengths[free_edge] = half
    tree.invalidate()


# ---------------------------------------------------------------------------
# SPR (pll_tree.c:159-191)
# ---------------------------------------------------------------------------
def spr(tree: Tree, prune_edge: int, regraft_edge: int,
        junction: int | None = None) -> Rollback:
    """Subtree-prune-regraft: detach the subtree hanging via ``prune_edge``
    at ``junction`` (default: the inner endpoint of prune_edge) and
    reattach it into ``regraft_edge``.

    The regraft edge must not be one of the edges adjacent to the junction
    (a no-op/invalid SPR, reference error INVALID_REARRAGE) and must lie
    outside the pruned subtree."""
    u, v = (int(x) for x in tree.edge_nodes[prune_edge])
    if junction is None:
        junction = u if not tree.is_tip(u) else v
    if tree.is_tip(junction):
        raise TreeError(TREE_ERROR_SPR_INVALID_NODE,
                        f"SPR junction {junction} is a tip")
    adj_edges = {e for _, e in tree.neighbors(junction)}
    if regraft_edge in adj_edges:
        raise TreeError(TREE_ERROR_INVALID_REARRAGE,
                        "regraft edge adjacent to prune point")
    # the pruned subtree is on the far side of prune_edge from the junction
    sub_root = u if junction == v else v
    inside = subtree_nodes(tree, prune_edge, sub_root) | {junction}
    rx, ry = (int(x) for x in tree.edge_nodes[regraft_edge])
    if rx in inside or ry in inside:
        raise TreeError(TREE_ERROR_INVALID_REARRAGE,
                        "regraft edge inside pruned subtree")

    rb = _snapshot(tree, "SPR")
    free_edge, _ = prune(tree, junction, keep_edge=prune_edge)
    regraft(tree, junction, free_edge, regraft_edge)
    return rb


# ---------------------------------------------------------------------------
# NNI (pll_tree.c:205-245)
# ---------------------------------------------------------------------------
def nni(tree: Tree, edge: int, move_type: int) -> Rollback:
    """Nearest-neighbor interchange across internal ``edge``.

    LEFT swaps the first subtree of one side with the first of the other;
    RIGHT swaps with the second (subtrees ordered by edge id for
    determinism — the array analog of the reference's next-pointer order).
    """
    u, v = (int(x) for x in tree.edge_nodes[edge])
    if tree.is_tip(u) or tree.is_tip(v):
        raise TreeError(TREE_ERROR_NNI_INVALID_MOVE,
                        "NNI requires an inner edge")
    if move_type not in (NNI_LEFT, NNI_RIGHT):
        raise TreeError(TREE_ERROR_NNI_INVALID_MOVE,
                        f"invalid NNI move type {move_type}")
    u_edges = sorted(e for _, e in tree.neighbors(u) if e != edge)
    v_edges = sorted(e for _, e in tree.neighbors(v) if e != edge)
    eu = u_edges[0]
    ev = v_edges[0] if move_type == NNI_LEFT else v_edges[1]

    rb = _snapshot(tree, "NNI")
    # swap: reattach eu's far end to v, ev's far end to u
    au = _other_end(tree, eu, u)
    av = _other_end(tree, ev, v)
    tree.edge_nodes[eu] = (v, au)
    tree.edge_nodes[ev] = (u, av)
    tree.invalidate()
    return rb


# ---------------------------------------------------------------------------
# TBR (pll_tree.c:72-143)
# ---------------------------------------------------------------------------
def tbr(tree: Tree, bisect_edge: int, reconn_edge1: int,
        reconn_edge2: int) -> Rollback:
    """Tree-bisection-reconnection.

    Bisect ``bisect_edge`` (must be internal: leaf bisection raises
    TBR_LEAF_BISECTION), dissolve both endpoints, then reconnect by
    inserting a new edge between the midpoints of the two reconnection
    edges, which must lie strictly in different subtrees and not be
    adjacent to the bisected edge (TBR_OVERLAPPED_NODES /
    TBR_SAME_SUBTREE)."""
    u, v = (int(x) for x in tree.edge_nodes[bisect_edge])
    if tree.is_tip(u) or tree.is_tip(v):
        raise TreeError(TREE_ERROR_TBR_LEAF_BISECTION,
                        "TBR cannot bisect a leaf branch")
    u_adj = {e for _, e in tree.neighbors(u)}
    v_adj = {e for _, e in tree.neighbors(v)}
    if reconn_edge1 in u_adj | v_adj or reconn_edge2 in u_adj | v_adj:
        raise TreeError(TREE_ERROR_TBR_OVERLAPPED_NODES,
                        "reconnection edge adjacent to bisection")
    side_u = subtree_nodes(tree, bisect_edge, u)
    r1 = set(int(x) for x in tree.edge_nodes[reconn_edge1])
    r2 = set(int(x) for x in tree.edge_nodes[reconn_edge2])
    r1_in_u = r1 <= side_u
    r2_in_u = r2 <= side_u
    if r1_in_u == r2_in_u:
        raise TreeError(TREE_ERROR_TBR_SAME_SUBTREE,
                        "reconnection edges must lie in different subtrees")
    if not r1_in_u:
        reconn_edge1, reconn_edge2 = reconn_edge2, reconn_edge1

    rb = _snapshot(tree, "TBR")
    # dissolve u and v: each fuses its two remaining edges, freeing 2 slots
    free_u, _ = prune(tree, u, keep_edge=bisect_edge)
    free_v, _ = prune(tree, v, keep_edge=bisect_edge)
    # detach bisect edge entirely; u & v become floating junctions
    tree.edge_nodes[bisect_edge] = (u, v)  # will reconnect u..v
    # insert u into reconn_edge1 (in u-side subtree), v into reconn_edge2
    regraft(tree, u, free_u, reconn_edge1)
    regraft(tree, v, free_v, reconn_edge2)
    tree.invalidate()
    return rb


def rollback(tree: Tree, rb: Rollback) -> None:
    """pllmod_tree_rollback analog."""
    rb.apply(tree)
