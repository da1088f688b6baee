"""Array-encoded unrooted trees + Newick IO + traversal compilation.

Replaces libpll's roundabout ``pll_utree_t``/``pll_unode_t`` (SURVEY.md
§2.9 "Tree infra") with a flat edge-list representation designed for the
TPU compute path:

- node ids: tips ``0..n_tips-1`` (label index), inner ``n_tips..2n_tips-3``
- edge ids are **stable pmatrix indices**: an edge keeps its id across
  SPR/NNI/TBR moves (mirroring how libpll nodes carry ``pmatrix_index``),
  so branch-length arrays indexed by edge id survive topology changes and
  jitted functions never recompile.
- ``traversal_ops`` compiles a (virtual-root) post-order traversal into the
  static int32 ops array consumed by :func:`pllmod_tpu_torch.ops.clv.update_partials`
  — the equivalent of pll_utree_traverse + pll_utree_create_operations.

Topology manipulation is host-side numpy/python: it is O(n) bookkeeping,
negligible next to the O(n · patterns · cats · states) device compute.
"""

from __future__ import annotations

import io

import numpy as np

from pllmod_tpu_torch.common import (TreeError, TREE_ERROR_INVALID_TREE,
                                     TREE_ERROR_INVALID_TREE_SIZE)


class Tree:
    """Unrooted (optionally multifurcating) tree.

    Attributes:
      n_tips: number of leaves
      labels: tip labels; ``labels[i]`` is the label of tip node ``i``
      edge_nodes: int32 [n_edges, 2] — the two node ids of each edge;
                  rows of (-1, -1) are free slots (after collapses)
      lengths: float64 [n_edges] branch lengths
      n_nodes: total allocated node ids
    """

    def __init__(self, n_tips, labels, edge_nodes, lengths, n_nodes=None):
        self.n_tips = int(n_tips)
        self.labels = list(labels)
        self.edge_nodes = np.asarray(edge_nodes, dtype=np.int32).reshape(-1, 2)
        self.lengths = np.asarray(lengths, dtype=np.float64).copy()
        if n_nodes is None:
            n_nodes = int(self.edge_nodes.max()) + 1 if len(self.edge_nodes) else n_tips
        self.n_nodes = int(n_nodes)
        self._adj = None

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(np.sum(self.edge_nodes[:, 0] >= 0))

    @property
    def n_inner(self) -> int:
        return self.n_nodes - self.n_tips

    def copy(self) -> "Tree":
        t = Tree(self.n_tips, self.labels, self.edge_nodes.copy(),
                 self.lengths.copy(), self.n_nodes)
        return t

    def snapshot(self):
        """Cheap topology snapshot for rollback (treeinfo.c:546-719 analog)."""
        return (self.edge_nodes.copy(), self.lengths.copy(), self.n_nodes)

    def restore(self, snap):
        self.edge_nodes, self.lengths, self.n_nodes = \
            snap[0].copy(), snap[1].copy(), snap[2]
        self._adj = None

    # ------------------------------------------------------------------
    def invalidate(self):
        self._adj = None

    def adjacency(self):
        """node id -> list of (neighbor, edge_id)."""
        if self._adj is None:
            adj = [[] for _ in range(self.n_nodes)]
            for e, (u, v) in enumerate(self.edge_nodes):
                if u >= 0:
                    adj[u].append((int(v), e))
                    adj[v].append((int(u), e))
            self._adj = adj
        return self._adj

    def neighbors(self, node):
        return self.adjacency()[node]

    def degree(self, node):
        return len(self.adjacency()[node])

    def is_tip(self, node) -> bool:
        return node < self.n_tips

    def edge_between(self, u, v):
        for nbr, e in self.neighbors(u):
            if nbr == v:
                return e
        return None

    def check_integrity(self):
        """pll_utree_check_integrity analog: connected, degrees consistent."""
        adj = self.adjacency()
        live_nodes = [n for n in range(self.n_nodes) if adj[n]]
        for t in range(self.n_tips):
            if len(adj[t]) != 1:
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"tip {t} has degree {len(adj[t])}")
        for n in live_nodes:
            if n >= self.n_tips and len(adj[n]) < 3:
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"inner node {n} has degree {len(adj[n])}")
        # connectivity
        seen = {live_nodes[0]}
        stack = [live_nodes[0]]
        while stack:
            u = stack.pop()
            for v, _ in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        if len(seen) != len(live_nodes):
            raise TreeError(TREE_ERROR_INVALID_TREE, "tree is disconnected")
        return True

    def is_binary(self) -> bool:
        adj = self.adjacency()
        return all(len(adj[n]) in (0, 3) for n in range(self.n_tips, self.n_nodes))

    # ------------------------------------------------------------------
    # Traversal compilation
    # ------------------------------------------------------------------
    def postorder(self, root_node, avoid_edge=None):
        """Post-order node sequence rooted (virtually) at root_node.

        Returns list of (node, parent, edge_to_parent)."""
        adj = self.adjacency()
        out = []
        stack = [(root_node, -1, -1, False)]
        while stack:
            node, parent, pedge, processed = stack.pop()
            if processed:
                out.append((node, parent, pedge))
                continue
            stack.append((node, parent, pedge, True))
            for nbr, e in adj[node]:
                if nbr != parent and e != avoid_edge:
                    stack.append((nbr, node, e, False))
        return out

    def traversal_ops(self, root_edge=None):
        """Compile a full post-order traversal into CLV ops.

        Args:
          root_edge: edge id to place the virtual root on (default: edge 0's
            live slot). The two endpoint CLVs are oriented toward each other.
        Returns:
          (ops int32 [n_inner, 5], (node_u, node_v, root_edge)) where ops rows
          are (parent_slot, child1_node, child1_edge, child2_node, child2_edge)
          padded with -1 rows up to n_inner; binary trees fill exactly.
        """
        if root_edge is None:
            root_edge = int(np.nonzero(self.edge_nodes[:, 0] >= 0)[0][0])
        u, v = (int(x) for x in self.edge_nodes[root_edge])
        rows = []
        for side in (u, v):
            if self.is_tip(side):
                continue
            for node, parent, pedge in self.postorder(side, avoid_edge=root_edge):
                if self.is_tip(node):
                    continue
                kids = [(nbr, e) for nbr, e in self.neighbors(node)
                        if e != pedge and e != root_edge]
                if len(kids) != 2:
                    raise TreeError(TREE_ERROR_INVALID_TREE,
                                    f"node {node} is multifurcating "
                                    f"({len(kids)+1} neighbors); resolve first")
                rows.append([node - self.n_tips, kids[0][0], kids[0][1],
                             kids[1][0], kids[1][1]])
        ops = np.full((self.n_inner, 5), -1, dtype=np.int32)
        if rows:
            ops[:len(rows)] = rows
        return ops, (u, v, root_edge)

    # ------------------------------------------------------------------
    # Newick IO
    # ------------------------------------------------------------------
    @staticmethod
    def from_newick(newick: str) -> "Tree":
        return parse_newick(newick)

    def to_newick(self, root_node=None, lengths: np.ndarray | None = None,
                  precision: int = 6) -> str:
        """Serialize as Newick, rooted at an inner node (trifurcation at
        root, pll_utree_export_newick convention)."""
        lengths = self.lengths if lengths is None else lengths
        adj = self.adjacency()
        if root_node is None:
            root_node = next(n for n in range(self.n_tips, self.n_nodes)
                             if adj[n])

        def fmt(x):
            return f"{x:.{precision}f}"

        out = io.StringIO()

        def rec(node, parent, pedge):
            if self.is_tip(node):
                out.write(self.labels[node])
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
            if pedge >= 0:
                out.write(":" + fmt(lengths[pedge]))

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * self.n_nodes + 1000))
        try:
            rec(root_node, -1, -1)
        finally:
            sys.setrecursionlimit(old)
        out.write(";")
        return out.getvalue()

    def __repr__(self):
        return (f"Tree(n_tips={self.n_tips}, n_inner={self.n_inner}, "
                f"n_edges={self.n_edges})")


# ---------------------------------------------------------------------------
# Newick parser (pll_utree_parse_newick_string equivalent)
# ---------------------------------------------------------------------------
def _tokenize(s: str):
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in "(),;:":
            yield c
            i += 1
        elif c.isspace():
            i += 1
        elif c in "'\"":
            j = s.index(c, i + 1)
            yield ("LABEL", s[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in "(),;:" and not s[j].isspace():
                j += 1
            yield ("LABEL", s[i:j])
            i = j


def parse_newick(newick: str) -> Tree:
    """Parse a Newick string into an unrooted Tree.

    Rooted (bifurcating-root) inputs are unrooted by fusing the two root
    edges into one (libpll convention when wrapping rtrees as utrees).

    Uses the native C++ one-pass parser when built (pllmod_tpu_torch.native);
    pure-python fallback otherwise."""
    try:
        from pllmod_tpu_torch import native
        if native.available():
            try:
                return _from_native_parse(*native.parse_newick(newick))
            except ValueError as e:
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"malformed newick: {e}") from e
        return _parse_newick_inner(newick)
    except (IndexError, ValueError) as e:
        raise TreeError(TREE_ERROR_INVALID_TREE,
                        f"malformed newick: {e}") from e


def _from_native_parse(n_tips, edges, lengths, labels, root, root_children,
                       n_nodes):
    if n_tips < 3:
        raise TreeError(TREE_ERROR_INVALID_TREE_SIZE,
                        f"need >= 3 taxa, got {n_tips}")
    tree = Tree(n_tips, labels, edges, lengths, n_nodes=n_nodes)
    if root_children == 2:
        # unroot: fuse the two root edges (same convention as the python
        # parser below)
        (a, ea), (b, eb) = tree.neighbors(root)
        fused_len = tree.lengths[ea] + tree.lengths[eb]
        keep = min(ea, eb)
        drop = max(ea, eb)
        tree.edge_nodes[keep] = (a, b)
        tree.lengths[keep] = fused_len
        last = tree.edge_nodes.shape[0] - 1
        if drop != last:
            tree.edge_nodes[drop] = tree.edge_nodes[last]
            tree.lengths[drop] = tree.lengths[last]
        tree.edge_nodes = tree.edge_nodes[:last]
        tree.lengths = tree.lengths[:last]
        tree.edge_nodes = np.where(tree.edge_nodes > root,
                                   tree.edge_nodes - 1, tree.edge_nodes)
        tree.n_nodes -= 1
        tree.invalidate()
    tree.check_integrity()
    return tree


def _parse_newick_inner(newick: str) -> Tree:
    tokens = list(_tokenize(newick))
    pos = 0

    tip_labels: list[str] = []
    children: list[list] = []     # per temp-node: list of (child_tmp, brlen)
    node_is_tip: list[bool] = []

    def new_node(is_tip, label=None):
        children.append([])
        node_is_tip.append(is_tip)
        if is_tip:
            tip_labels.append(label)
        return len(children) - 1

    def parse_clade():
        nonlocal pos
        if tokens[pos] == "(":
            node = new_node(False)
            pos += 1
            while True:
                child, blen = parse_clade()
                children[node].append((child, blen))
                if tokens[pos] == ",":
                    pos += 1
                    continue
                break
            if tokens[pos] != ")":
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"expected ')' near token {pos}")
            pos += 1
            # optional inner label (support value) — skipped
            if pos < len(tokens) and isinstance(tokens[pos], tuple):
                pos += 1
        else:
            tok = tokens[pos]
            if not isinstance(tok, tuple):
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"unexpected token {tok!r}")
            node = new_node(True, tok[1])
            pos += 1
        blen = 0.0
        if pos < len(tokens) and tokens[pos] == ":":
            pos += 1
            blen = float(tokens[pos][1])
            pos += 1
        return node, blen

    root_tmp, _ = parse_clade()
    if pos >= len(tokens) or tokens[pos] != ";":
        raise TreeError(TREE_ERROR_INVALID_TREE, "missing ';'")

    # map temp ids: tips get 0..T-1 in encounter order, inners follow
    n_tips = len(tip_labels)
    if n_tips < 3:
        raise TreeError(TREE_ERROR_INVALID_TREE_SIZE,
                        f"need >= 3 taxa, got {n_tips}")
    tmp2id = {}
    tip_counter = 0
    inner_counter = n_tips
    for tmp in range(len(children)):
        if node_is_tip[tmp]:
            tmp2id[tmp] = tip_counter
            tip_counter += 1
        else:
            tmp2id[tmp] = inner_counter
            inner_counter += 1

    edges = []
    lengths = []

    def walk(tmp):
        for child, blen in children[tmp]:
            edges.append((tmp2id[tmp], tmp2id[child]))
            lengths.append(blen)
            walk(child)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * len(children) + 1000))
    try:
        walk(root_tmp)
    finally:
        sys.setrecursionlimit(old)

    tree = Tree(n_tips, tip_labels, np.array(edges, np.int32),
                np.array(lengths), n_nodes=inner_counter)

    # unroot if the root is a bifurcation: fuse its two edges
    root_id = tmp2id[root_tmp]
    if len(children[root_tmp]) == 2:
        (a, ea), (b, eb) = tree.neighbors(root_id)
        fused_len = tree.lengths[ea] + tree.lengths[eb]
        keep = min(ea, eb)
        drop = max(ea, eb)
        tree.edge_nodes[keep] = (a, b)
        tree.lengths[keep] = fused_len
        # compact: move last edge into the dropped slot
        last = tree.edge_nodes.shape[0] - 1
        if drop != last:
            tree.edge_nodes[drop] = tree.edge_nodes[last]
            tree.lengths[drop] = tree.lengths[last]
        tree.edge_nodes = tree.edge_nodes[:last]
        tree.lengths = tree.lengths[:last]
        # renumber nodes after the removed root id down by one
        tree.edge_nodes = np.where(tree.edge_nodes > root_id,
                                   tree.edge_nodes - 1, tree.edge_nodes)
        tree.n_nodes -= 1
        tree.invalidate()
    tree.check_integrity()
    return tree


def set_tip_order(tree: Tree, labels: list[str]) -> Tree:
    """Reorder tip ids to match a given label order (tip-label consistency
    helper, utree_distances.c:74-195 analog)."""
    remap = {}
    want = {lb: i for i, lb in enumerate(labels)}
    if set(want) != set(tree.labels):
        raise TreeError(TREE_ERROR_INVALID_TREE, "label sets differ")
    for old_id, lb in enumerate(tree.labels):
        remap[old_id] = want[lb]
    en = tree.edge_nodes.copy()
    for old_id, new_id in remap.items():
        en[tree.edge_nodes == old_id] = new_id
    return Tree(tree.n_tips, labels, en, tree.lengths, tree.n_nodes)
