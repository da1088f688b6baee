"""Rooted trees: representation + prune/regraft/SPR.

Host-side port (a copy of the JAX package's module) of
``src/tree/rtree_operations.c`` (344 LoC): rooted trees as parent-array
encodings with the reference's operation set — get sibling, prune (with
parent dissolution), regraft (edge split), rooted SPR with rollback.
``pll_rtree_parse_newick`` maps to :func:`RTree.from_newick`.

A rooted tree with n tips has n−1 inner nodes; the root has exactly two
children. Node ids: tips 0..n−1, inners n..2n−2.
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import (TreeError, TREE_ERROR_SPR_INVALID_NODE,
                                     TREE_ERROR_INVALID_TREE,
                                     TREE_ERROR_INVALID_REARRAGE)


class RTree:
    """Rooted (binary) tree: ``parent[i]`` and per-node branch length to
    its parent (root: parent −1, length 0)."""

    def __init__(self, n_tips, labels, parent, lengths, root):
        self.n_tips = int(n_tips)
        self.labels = list(labels)
        self.parent = np.asarray(parent, np.int32).copy()
        self.lengths = np.asarray(lengths, np.float64).copy()
        self.root = int(root)

    @property
    def n_nodes(self):
        return len(self.parent)

    def children(self, node):
        return [int(c) for c in np.nonzero(self.parent == node)[0]]

    def sibling(self, node):
        """pllmod_rtree_get_sibling."""
        p = int(self.parent[node])
        if p < 0:
            raise TreeError(TREE_ERROR_INVALID_TREE, "root has no sibling")
        kids = self.children(p)
        return kids[0] if kids[1] == node else kids[1]

    def is_tip(self, node):
        return node < self.n_tips

    def subtree(self, node):
        out = {node}
        stack = [node]
        while stack:
            n = stack.pop()
            for c in self.children(n):
                if c not in out:
                    out.add(c)
                    stack.append(c)
        return out

    def check_integrity(self):
        n_root = int((self.parent < 0).sum())
        if n_root != 1 or int(self.parent[self.root]) != -1:
            raise TreeError(TREE_ERROR_INVALID_TREE, "bad root")
        for node in range(self.n_nodes):
            kids = self.children(node)
            if node < self.n_tips:
                if kids:
                    raise TreeError(TREE_ERROR_INVALID_TREE,
                                    f"tip {node} has children")
            elif len(kids) != 2:
                raise TreeError(TREE_ERROR_INVALID_TREE,
                                f"inner {node} has {len(kids)} children")
        return True

    def snapshot(self):
        return (self.parent.copy(), self.lengths.copy(), self.root)

    def restore(self, snap):
        self.parent, self.lengths, self.root = \
            snap[0].copy(), snap[1].copy(), snap[2]

    # ------------------------------------------------------------------
    def prune(self, node):
        """Prune the subtree rooted at ``node``: its parent dissolves
        (sibling inherits the summed branch length) and is returned as
        the floating "orphan" inner node (pllmod_rtree_prune)."""
        p = int(self.parent[node])
        if p < 0 or p == self.root and False:
            raise TreeError(TREE_ERROR_SPR_INVALID_NODE,
                            f"cannot prune node {node}")
        sib = self.sibling(node)
        gp = int(self.parent[p])
        if gp < 0:
            # parent is root: sibling becomes the new root
            self.parent[sib] = -1
            self.lengths[sib] = 0.0
            self.root = sib
        else:
            self.parent[sib] = gp
            self.lengths[sib] = self.lengths[sib] + self.lengths[p]
        self.parent[p] = -2  # floating marker
        return p

    def regraft(self, orphan, edge_child):
        """Insert ``orphan`` (a floating inner node whose remaining child
        is the pruned subtree) into the branch above ``edge_child``,
        splitting its length in half (pllmod_rtree_regraft)."""
        if int(self.parent[orphan]) != -2:
            raise TreeError(TREE_ERROR_INVALID_REARRAGE,
                            f"node {orphan} is not floating")
        gp = int(self.parent[edge_child])
        if gp < 0:
            raise TreeError(TREE_ERROR_INVALID_REARRAGE,
                            "cannot regraft above the root")
        half = self.lengths[edge_child] / 2.0
        self.parent[orphan] = gp
        self.lengths[orphan] = half
        self.parent[edge_child] = orphan
        self.lengths[edge_child] = half

    def spr(self, prune_node, regraft_child):
        """Rooted SPR (pllmod_rtree_spr): prune subtree at ``prune_node``,
        reinsert above ``regraft_child``. Returns a rollback snapshot."""
        if regraft_child in self.subtree(prune_node):
            raise TreeError(TREE_ERROR_INVALID_REARRAGE,
                            "regraft inside pruned subtree")
        snap = self.snapshot()
        orphan = self.prune(prune_node)
        self.regraft(orphan, regraft_child)
        return snap

    def rollback(self, snap):
        self.restore(snap)

    def nodes_at_node_dist(self, node, min_dist: int, max_dist: int):
        """Nodes within UNDIRECTED BFS distance [min_dist, max_dist] of
        ``node`` — the rooted SPR candidate generator
        (pllmod_rtree_get_nodes_at_node_dist, rtree_operations.c:282-344).
        The start node is excluded; floating nodes are skipped."""
        children = {n: [] for n in range(self.n_nodes)}
        for n in range(self.n_nodes):
            p = int(self.parent[n])
            if p >= 0:
                children[p].append(n)

        def nbrs(x):
            out = list(children[x])
            p = int(self.parent[x])
            if p >= 0:
                out.append(p)
            return out

        seen = {node}
        frontier = [(node, 0)]
        hits = []
        while frontier:
            x, d = frontier.pop()
            if d >= max_dist:
                continue
            for nbr in nbrs(x):
                if nbr in seen or int(self.parent[nbr]) == -2:
                    continue
                seen.add(nbr)
                if d + 1 >= min_dist:
                    hits.append(nbr)
                frontier.append((nbr, d + 1))
        return sorted(hits)

    # ------------------------------------------------------------------
    @classmethod
    def from_unrooted(cls, tree, root_edge: int,
                      position: float = 0.5) -> "RTree":
        """Root an unrooted tree on an edge (pllmod_utree_root_inplace /
        outgroup rooting, pll_tree.c:531-701): a new root node splits
        ``root_edge`` at ``position`` of its length."""
        u, v = (int(x) for x in tree.edge_nodes[root_edge])
        n_nodes = tree.n_nodes
        root = n_nodes
        parent = np.full(n_nodes + 1, -1, np.int32)
        lengths = np.zeros(n_nodes + 1)
        # orient everything away from the new root
        for side, frac in ((u, position), (v, 1.0 - position)):
            stack = [(side, root,
                      tree.lengths[root_edge] * frac, root_edge)]
            while stack:
                node, par, blen, pedge = stack.pop()
                parent[node] = par
                lengths[node] = blen
                for nbr, e in tree.neighbors(node):
                    if e == pedge or nbr == par:
                        continue
                    stack.append((nbr, node, tree.lengths[e], e))
        return cls(tree.n_tips, tree.labels, parent, lengths, root)

    @classmethod
    def from_newick(cls, newick: str) -> "RTree":
        """Parse a rooted Newick (root must be a bifurcation)."""
        from pllmod_tpu_torch.tree.topology import _tokenize
        tokens = list(_tokenize(newick))
        pos = 0
        tips, parents, blens, kids = [], [], [], []

        def new_node(label=None):
            parents.append(-1)
            blens.append(0.0)
            kids.append([])
            if label is not None:
                tips.append((len(parents) - 1, label))
            return len(parents) - 1

        def parse():
            nonlocal pos
            if tokens[pos] == "(":
                node = new_node()
                pos += 1
                while True:
                    child, bl = parse()
                    parents[child] = node
                    blens[child] = bl
                    kids[node].append(child)
                    if tokens[pos] == ",":
                        pos += 1
                        continue
                    break
                if tokens[pos] != ")":
                    raise TreeError(TREE_ERROR_INVALID_TREE, "expected )")
                pos += 1
                if pos < len(tokens) and isinstance(tokens[pos], tuple):
                    pos += 1  # inner label
            else:
                node = new_node(tokens[pos][1])
                pos += 1
            bl = 0.0
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                bl = float(tokens[pos][1])
                pos += 1
            return node, bl

        root_tmp, _ = parse()
        if any(len(k) not in (0, 2) for k in kids):
            raise TreeError(TREE_ERROR_INVALID_TREE,
                            "rooted tree must be binary")
        # renumber: tips first (encounter order), then inners
        n_tips = len(tips)
        remap = {}
        for i, (tmp, _lb) in enumerate(tips):
            remap[tmp] = i
        nxt = n_tips
        for tmp in range(len(parents)):
            if tmp not in remap:
                remap[tmp] = nxt
                nxt += 1
        parent = np.full(nxt, -1, np.int32)
        lengths = np.zeros(nxt)
        for tmp in range(len(parents)):
            if parents[tmp] >= 0:
                parent[remap[tmp]] = remap[parents[tmp]]
            lengths[remap[tmp]] = blens[tmp]
        labels = [lb for _, lb in tips]
        return cls(n_tips, labels, parent, lengths, remap[root_tmp])

    def to_newick(self, precision: int = 6) -> str:
        import io as _io
        out = _io.StringIO()

        def rec(node):
            kids = self.children(node)
            if not kids:
                out.write(self.labels[node])
            else:
                out.write("(")
                for i, c in enumerate(kids):
                    if i:
                        out.write(",")
                    rec(c)
                out.write(")")
            if int(self.parent[node]) >= 0:
                out.write(f":{self.lengths[node]:.{precision}f}")

        rec(self.root)
        out.write(";")
        return out.getvalue()

    def to_unrooted(self):
        """Unroot: fuse the root's two child edges (pll utree convention)."""
        from pllmod_tpu_torch.tree.topology import Tree
        edges, lens = [], []
        for node in range(self.n_nodes):
            p = int(self.parent[node])
            if p >= 0:
                edges.append((p, node))
                lens.append(self.lengths[node])
        t = Tree(self.n_tips, self.labels, np.array(edges, np.int32),
                 np.array(lens), n_nodes=self.n_nodes)
        # fuse root edges
        (a, ea), (b, eb) = t.neighbors(self.root)
        keep, drop = min(ea, eb), max(ea, eb)
        t.edge_nodes[keep] = (a, b)
        t.lengths[keep] = t.lengths[ea] + t.lengths[eb]
        last = len(t.edge_nodes) - 1
        if drop != last:
            t.edge_nodes[drop] = t.edge_nodes[last]
            t.lengths[drop] = t.lengths[last]
        t.edge_nodes = t.edge_nodes[:last]
        t.lengths = t.lengths[:last]
        t.invalidate()
        return t
