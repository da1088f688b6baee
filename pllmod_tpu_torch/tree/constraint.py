"""Topological constraints from (possibly multifurcating,
non-comprehensive) constraint trees.

Host-side port (a copy of the JAX package's module) of
``src/tree/utree_constraint.c`` (557 LoC): a constraint tree over a
subset of taxa induces a split set; a candidate topology is compatible
iff every constraint split, restricted to the constraint taxa, is
present-or-compatible with the candidate's restricted splits. The SPR
fast path (``pllmod_utree_constraint_check_spr``,
utree_constraint.c:421-482) checks only the single NEW split an SPR
introduces; ``subtree_affected`` (:542-557) exits early when the pruned
subtree contains at most one constrained taxon. """

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.tree import splits as sp
from pllmod_tpu_torch.tree import moves


class Constraint:
    """Split-based topological constraint (pllmod_utree_constraint)."""

    def __init__(self, cons_tree, full_labels: list[str]):
        """Args:
          cons_tree: constraint Tree (taxa must be a subset of full_labels)
          full_labels: the taxon set of trees that will be checked
        """
        self.full_labels = list(full_labels)
        self.n_full = len(full_labels)
        # map constraint tip ids -> full tree tip ids
        self.cons_taxa = [self.full_labels.index(l) for l in cons_tree.labels]
        self.n_cons = len(self.cons_taxa)
        # constrained-taxon mask in FULL tip space
        self.full_mask = np.zeros(sp.n_words(self.n_full), np.uint64)
        for t in self.cons_taxa:
            self.full_mask[t // 64] |= np.uint64(1) << np.uint64(t % 64)
        # constraint splits in CONSTRAINT tip space (ids 0..n_cons-1)
        self.cons_splits, _ = sp.tree_splits(cons_tree)
        # position of each full tip inside the constraint ordering (or -1)
        self.full_to_cons = np.full(self.n_full, -1, np.int64)
        for ci, ft in enumerate(self.cons_taxa):
            self.full_to_cons[ft] = ci

        # vectorized restriction tables: full-tip word/bit per constraint
        # position (cons order), and the word/shift each lands in
        ct = np.asarray(self.cons_taxa, np.int64)
        self._src_word = ct // 64
        self._src_bit = (ct % 64).astype(np.uint64)
        ci = np.arange(self.n_cons, dtype=np.int64)
        self._dst_word = ci // 64
        self._dst_bit = (ci % 64).astype(np.uint64)
        self._n_cons_words = sp.n_words(self.n_cons)

    # ------------------------------------------------------------------
    def _restrict_many(self, splits_full: np.ndarray) -> np.ndarray:
        """Project full-space splits [N, W] onto constraint taxa —
        vectorized (one numpy gather + scatter-or instead of a python
        loop per split × taxon; the apply-time full check runs this on
        every applied SPR)."""
        splits_full = np.atleast_2d(splits_full)
        bits = (splits_full[:, self._src_word] >> self._src_bit) \
            & np.uint64(1)                                   # [N, n_cons]
        out = np.zeros((len(splits_full), self._n_cons_words), np.uint64)
        shifted = bits << self._dst_bit
        for w in range(self._n_cons_words):
            sel = self._dst_word == w
            out[:, w] = np.bitwise_or.reduce(shifted[:, sel], axis=1)
        return sp.normalize(out, self.n_cons)

    def _restrict(self, split_full: np.ndarray) -> np.ndarray:
        """Project a full-space split onto constraint taxa."""
        return self._restrict_many(split_full[None])[0]

    def _is_trivial(self, split_cons: np.ndarray) -> bool:
        pc = int(np.bitwise_count(split_cons).sum())
        return pc <= 1 or pc >= self.n_cons - 1

    def check_tree(self, tree) -> bool:
        """Full-topology check (pllmod_utree_constraint_check_current,
        utree_constraint.c:485-540): every constraint split must be
        compatible with ALL of the tree's restricted splits. (For binary
        trees compatibility-with-all ⟺ containment, the reference's
        hashtable formulation.) Fully vectorized — one [C, R, W]
        popcount pass instead of the C×R python loop."""
        tree_splits_full, _ = sp.tree_splits(tree)
        if len(tree_splits_full) == 0 or len(self.cons_splits) == 0:
            return True
        r = self._restrict_many(tree_splits_full)
        pc = np.bitwise_count(r).sum(1)
        r = r[(pc > 1) & (pc < self.n_cons - 1)]
        if len(r) == 0:
            return True
        mask = sp.tip_mask(self.n_cons)
        c = self.cons_splits
        A, nA = c[:, None, :], (~c & mask)[:, None, :]
        B, nB = r[None, :, :], (~r & mask)[None, :, :]
        empty = lambda X: ~np.any(X, axis=-1)
        ok = (empty(A & B) | empty(A & nB) | empty(nA & B)
              | empty(nA & nB))
        return bool(ok.all())

    def subtree_affected(self, tree, prune_edge: int, sub_root: int) -> bool:
        """Fast exit: an SPR can only violate the constraint if the pruned
        subtree contains >= 1 constrained taxon AND the remainder contains
        >= 2 (utree_constraint.c:542-557)."""
        sub = moves.subtree_nodes(tree, prune_edge, sub_root)
        k = sum(1 for t in sub if t < tree.n_tips
                and self.full_to_cons[t] >= 0)
        return 1 <= k <= self.n_cons - 2

    def check_spr(self, tree, prune_edge: int, junction: int,
                  regraft_edge: int) -> bool:
        """SPR fast check (utree_constraint.c:421-482): test the new
        attachment splits the SPR would create against every constraint
        split.

        Regrafting subtree S (constrained taxa P) into edge (rx, ry)
        subdivides it, creating BOTH bipartitions {P∪x | y} and
        {P∪y | x} where x/y are the constrained taxa on each side of the
        regraft edge (S excluded); both are tested (the reference checks
        one and descends past constraint-trivial neighbors — testing
        both sides subsumes that descent). Like the reference this is a
        fast HEURISTIC: path-edge splits between the old and new
        location also change, so spr_round backs it with a full
        ``check_tree`` + rollback at apply time (the reference instead
        hard-fails the whole round on its final full check,
        algo_search.c:1458-1468)."""
        u, v = (int(x) for x in tree.edge_nodes[prune_edge])
        sub_root = u if junction == v else v
        if not self.subtree_affected(tree, prune_edge, sub_root):
            return True
        sub = moves.subtree_nodes(tree, prune_edge, sub_root)
        sub_split = np.zeros(sp.n_words(self.n_full), np.uint64)
        for t in sub:
            if t < tree.n_tips:
                sub_split[t // 64] |= np.uint64(1) << np.uint64(t % 64)
        sub_split &= self.full_mask
        rx, _ry = (int(x) for x in tree.edge_nodes[regraft_edge])
        x_nodes = moves.subtree_nodes(tree, regraft_edge, rx) - sub
        x_split = np.zeros_like(sub_split)
        for t in x_nodes:
            if t < tree.n_tips:
                x_split[t // 64] |= np.uint64(1) << np.uint64(t % 64)
        x_split &= self.full_mask
        y_split = self.full_mask & ~sub_split & ~x_split
        for side in (x_split, y_split):
            new_split = sub_split | side
            r = self._restrict(sp.normalize(new_split[None], self.n_full)[0])
            if self._is_trivial(r):
                continue
            if not all(sp.compatible(c, r, self.n_cons)
                       for c in self.cons_splits):
                return False
        return True
