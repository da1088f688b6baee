"""TreeInfo — partitioned likelihood state over one topology; the
counterpart of ``pllmod_tpu.tree.treeinfo`` (``pllmod_treeinfo_t``,
``src/tree/treeinfo.c``).

One tree and N partitions with per-partition model parameters,
branch-length linkage (LINKED / SCALED / UNLINKED,
``pllmod_common.h:25-27``), per-partition ``params_to_optimize`` masks
and total log-likelihood = the sum over partitions. As in the JAX
package, partitions are immutable (setting a parameter swaps the stored
partition) and ``None`` entries mark remote partitions, which every
method skips.

Engines: a float32 partition runs the kernels (launched on CUDA
tensors, their plain versions on CPU ones), a float64 partition the
serial engine. The float32 partitions evaluate together through
:func:`pllmod_tpu_torch.ops.engine.multi_eval`, one launch each and one
host sync for all of them. ``compute_loglh(incremental=True)`` is the reference's
CLV-validity protocol (treeinfo.c:38-61, 872-944): only the op rows
whose branch lengths changed, or that depend on one that did, run again
on the cached buffers — through the fused kernel in place
(``engine.fused_update_eval``) for float32, the serial engine for
float64. ``compute_ancestral`` gives each partition's marginal ancestral
states at its own branch lengths (``algorithm/ancestral.py``).

The ``parallel_reduce_cb`` seam (treeinfo.c:215-227) is the site mesh:
after :func:`pllmod_tpu_torch.parallel.shard_treeinfo` (``mesh`` /
``mesh_axis`` set, every partition a ``ShardedPartition``) each shard
evaluates through its own cached evaluator on its own device
(``engine.shard_evaluators``; float64 shards through the serial
engine), the incremental route keeps each shard's buffers, and the
per-shard sums are reduced (``engine.reduce_shards``);
``compute_loglh_persite`` joins the shards' per-pattern values in
pattern order.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import (BRLEN_LINKED, BRLEN_SCALED,
                                     BRLEN_UNLINKED, PARAM_ALL)
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.ops import fused as fused_mod
from pllmod_tpu_torch.parallel.sharding import (is_sharded, join_patterns,
                                                per_shard, shards_of)
from pllmod_tpu_torch.profile import Counters, timed


class TreeInfo:
    """Partitioned likelihood state (pllmod_treeinfo_* API surface).

    Attributes:
      tree: the shared topology (host object, edge-id-stable)
      partitions: list[Partition | None] — None marks a remote partition
      brlen_linkage: LINKED | SCALED | UNLINKED
      brlens: [n_parts, n_edge_slots] per-partition branch lengths
        (UNLINKED), else None (the tree's lengths are shared)
      brlen_scalers: [n_parts] multipliers (SCALED mode)
      params_to_optimize: [n_parts] bitmasks (PLLMOD_OPT_PARAM_*)
      counters: :class:`~pllmod_tpu_torch.profile.Counters` of the
        evaluations (CLV-op counts: inner rows × unpadded patterns, the
        unit of ``clv_updates_per_s``; host wall time, readbacks
        included)
      mesh / mesh_axis: the site mesh and its axis after
        :func:`pllmod_tpu_torch.parallel.shard_treeinfo`, else None
    """

    def __init__(self, tree, partitions, brlen_linkage: int = BRLEN_LINKED,
                 params_to_optimize=None):
        if not isinstance(partitions, (list, tuple)):
            partitions = [partitions]
        self.tree = tree
        self.partitions = list(partitions)
        self.brlen_linkage = brlen_linkage
        n = len(self.partitions)
        if brlen_linkage == BRLEN_UNLINKED:
            self.brlens = np.tile(tree.lengths, (n, 1))
        else:
            self.brlens = None
        self.brlen_scalers = np.ones(n)
        if params_to_optimize is None:
            params_to_optimize = [PARAM_ALL] * n
        elif isinstance(params_to_optimize, int):
            params_to_optimize = [params_to_optimize] * n
        self.params_to_optimize = list(params_to_optimize)
        # active-partition scoping (treeinfo.c:354-369); -1 = all
        self.active_partition = -1
        self.partition_loglh = np.zeros(n)
        self.counters = Counters()
        self.mesh = None
        self.mesh_axis = None
        # per partition: the compiled evaluator (a list of per-shard
        # evaluators for a sharded partition) and the incremental
        # buffers (each shard's), each keyed on what it was built from
        self._fast_cache: dict = {}
        self._incr_cache: dict = {}
        # per partition: the edge-decomposition tables of
        # algorithm/opt_model.py, keyed on (topology, partition shape)
        self._edge_tables: dict = {}

    def clear_caches(self) -> None:
        """Drop every cached evaluator, incremental buffer and edge table,
        the shards' too (after the state was replaced wholesale, as a
        checkpoint resume or a re-sharding does: the keys track topology
        and alignment identity, not a swap of every partition)."""
        self._fast_cache.clear()
        self._incr_cache.clear()
        self._edge_tables.clear()

    # ------------------------------------------------------------------
    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def local_indices(self):
        ap = self.active_partition
        for i, p in enumerate(self.partitions):
            if p is None:
                continue
            if ap != -1 and i != ap:
                continue
            yield i

    def set_active_partition(self, idx: int) -> None:
        """PLLMOD_TREEINFO_PARTITION_ALL == -1 (treeinfo.c:354-369)."""
        self.active_partition = idx

    # -- branch lengths across linkage modes (treeinfo.c:387-506) ---------
    def partition_brlens(self, idx: int) -> np.ndarray:
        if self.brlen_linkage == BRLEN_UNLINKED:
            return self.brlens[idx]
        if self.brlen_linkage == BRLEN_SCALED:
            return self.tree.lengths * self.brlen_scalers[idx]
        return self.tree.lengths

    def _brlens_tensor(self, idx: int):
        part = self.partitions[idx]
        return torch.as_tensor(np.asarray(self.partition_brlens(idx), float),
                               dtype=part.dtype, device=part.device)

    def set_branch_length(self, edge: int, value: float,
                          partition: int | None = None) -> None:
        if self.brlen_linkage == BRLEN_UNLINKED and partition is not None:
            self.brlens[partition, edge] = value
        else:
            self.tree.lengths[edge] = value
            if self.brlens is not None:
                self.brlens[:, edge] = value

    def set_partition(self, idx: int, partition) -> None:
        self.partitions[idx] = partition

    def scale_branches_all(self, factor: float) -> None:
        """Multiply every branch length (all partitions) by ``factor``
        (pllmod_treeinfo_scale_branches_all, treeinfo.c:1101-1130)."""
        self.tree.lengths *= factor
        if self.brlens is not None:
            self.brlens *= factor

    def scale_branches_partition(self, idx: int, factor: float) -> None:
        """Multiply one partition's branch lengths by ``factor`` —
        UNLINKED mode only, like the reference
        (pllmod_treeinfo_scale_branches_partition)."""
        if self.brlen_linkage != BRLEN_UNLINKED:
            raise ValueError("per-partition branch scaling requires "
                             "BRLEN_UNLINKED linkage")
        self.brlens[idx] *= factor

    # -- topology snapshot/restore (treeinfo.c:546-719) -------------------
    def get_topology(self):
        snap = self.tree.snapshot()
        brlens = None if self.brlens is None else self.brlens.copy()
        return (snap, brlens, self.brlen_scalers.copy())

    def set_topology(self, topo) -> None:
        snap, brlens, scalers = topo
        self.tree.restore(snap)
        self.brlens = None if brlens is None else brlens.copy()
        self.brlen_scalers = scalers.copy()

    # -- likelihood (treeinfo.c:946-1099) ---------------------------------
    def compute_loglh(self, incremental: bool = False) -> float:
        """Total log-likelihood over the local partitions.

        The float32 partitions evaluate through :func:`engine.multi_eval`
        (each through its cached ``engine.compile_fast_eval`` evaluator,
        one launch each, one host sync for all); float64 partitions
        through the serial engine. Under a mesh every partition goes
        through ``multi_eval``, each shard through its own evaluator on
        its own device, the shards' logLs reduced. ``incremental=True``
        recomputes only the op rows whose branch lengths changed or that
        depend on one that did, on the buffers cached by the previous
        incremental call (each shard's); a topology or partition change
        falls back to a full traversal."""
        ops, root_info = self.tree.traversal_ops()
        ri = tuple(int(x) for x in root_info)
        n_inner = int((ops[:, 0] >= 0).sum())
        total = 0.0
        with timed(self.counters):
            multi = [] if incremental else [
                i for i in self.local_indices()
                if engine_mod.use_fast_kernel(self.partitions[i])
                or is_sharded(self.partitions[i])]
            if multi:
                lnls = self._fast_eval_multi(multi, ops, ri)
                for k, i in enumerate(multi):
                    self.partition_loglh[i] = float(lnls[k])
                    total += float(lnls[k])
                    self.counters.add_traversal(
                        n_inner, self.partitions[i].n_patterns)
            for i in self.local_indices():
                if i in multi:
                    continue
                part = self.partitions[i]
                brl = self._brlens_tensor(i)
                if incremental:
                    lnl, n_run = self._loglh_incremental(i, part, ops, ri,
                                                         brl)
                else:
                    lnl = float(engine_mod.loglikelihood(part, ops, brl, ri))
                    n_run = n_inner
                self.counters.add_traversal(n_run, part.n_patterns)
                self.partition_loglh[i] = lnl
                total += lnl
        return total

    def compute_loglh_persite(self):
        """Per-partition per-pattern log-likelihoods
        (pllmod_treeinfo_compute_loglh_persite, treeinfo.c:1081-1099).

        Returns (total_loglh, [per-pattern lnl array | None per
        partition]) — None for remote or out-of-scope partitions. The
        entries are unweighted per-pattern values (times pattern_weights
        they sum to each partition's total). A float32 partition takes
        the fused kernel (the site vector falls out of its fused-root
        epilogue), a float64 one the serial engine; a sharded partition
        runs them on each shard and joins the values in pattern
        order."""
        ops, root_info = self.tree.traversal_ops()
        ri = tuple(int(x) for x in root_info)
        persite = [None] * self.n_partitions
        total = 0.0
        for i in self.local_indices():
            part = self.partitions[i]
            brl = self._brlens_tensor(i)
            shards = shards_of(part)
            tables = None
            if engine_mod.use_fast_kernel(part):
                # one host compile, copied onto each shard's device
                idx8, e1, e2, rinfo, ns = fused_mod.compile_fused(
                    shards[0], self.tree, fuse_root=True)
                tables = per_shard((idx8, e1, e2), shards)
            lnls, sites = [], []
            for k, s in enumerate(shards):
                if tables is not None:
                    i8, a, b = tables[k]
                    lnl, site = fused_mod.loglikelihood_fused(
                        s, i8, brl, a, b, rinfo, ns, persite=True)
                else:
                    lnl, site = engine_mod.loglikelihood_persite(s, ops, brl,
                                                                 ri)
                lnls.append(lnl)
                sites.append(site.cpu().numpy())
            lnl = engine_mod.reduce_shards(lnls, part.device)
            persite[i] = join_patterns(part, sites)
            self.partition_loglh[i] = float(lnl)
            total += float(lnl)
        return total, persite

    def _fast_eval_multi(self, idxs, ops, ri):
        """K float32 partitions through :func:`engine.multi_eval`.
        Returns the K logLs as numpy (one host sync)."""
        parts = [self.partitions[i] for i in idxs]
        lnls = engine_mod.multi_eval(
            parts, [self._brlens_tensor(i) for i in idxs],
            [self._fast_eval(i, p, ops, ri) for i, p in zip(idxs, parts)])
        return lnls.cpu().numpy()

    def _fast_eval(self, i, part, ops, ri):
        """The ``engine.compile_fast_eval`` evaluator of partition ``i``,
        cached on (topology, alignment identity): rebuilt when the
        topology or the alignment changes. For a sharded partition, the
        list of its shards' evaluators (``engine.shard_evaluators``: one
        compile, copied onto each shard's device)."""
        shards = shards_of(part)
        key = (ops.tobytes(), ri, part.n_tips, part.n_cats * part.states,
               tuple(id(s.tip_states) for s in shards))
        ent = self._fast_cache.get(i)
        if ent is None or ent[0] != key:
            ev = (engine_mod.shard_evaluators(part, self.tree)
                  if is_sharded(part)
                  else engine_mod.compile_fast_eval(part, self.tree))
            ent = (key, ev)
            self._fast_cache[i] = ent
        return ent[1]

    @staticmethod
    def _dirty_rows(ops, brl, prev_brl, n_tips):
        """Op rows invalidated by a branch-length change: a row is dirty
        when one of its child edges changed or a child CLV is dirty (the
        reference's clv_valid propagation, treeinfo.c:872-944). Returns
        (rows list, changed-edge set)."""
        changed = set(np.nonzero(brl != prev_brl)[0])
        invalid_slots = set()
        rows = []
        for r in ops:
            if r[0] < 0:
                continue
            dirty = int(r[2]) in changed or int(r[4]) in changed
            for c in (int(r[1]), int(r[3])):
                if c >= n_tips and (c - n_tips) in invalid_slots:
                    dirty = True
            if dirty:
                invalid_slots.add(int(r[0]))
                rows.append(r)
        return rows, changed

    def _loglh_incremental(self, i, part, ops, ri, brl):
        """One partition's partial-traversal evaluation. Returns (logL,
        number of op rows run): the fused kernel on the cached C·S×P
        buffers for float32, the serial engine for float64. Exactly the
        dirty rows run (the JAX package pads them to a power of two for
        its compile cache). A sharded partition keeps each shard's
        buffers on its device, runs the same rows on every shard (their
        table compiled once) and reduces the logLs."""
        fast = engine_mod.use_fast_kernel(part)
        shards = shards_of(part)
        key = (ops.tobytes(), ri, fast)
        cache = self._incr_cache.get(i)
        brl_np = brl.cpu().numpy()
        n_inner = int((ops[:, 0] >= 0).sum())
        if cache is None or cache["key"] != key or cache["part"] is not part:
            lnls, clvs, scalers = [], [], []
            if fast:
                idx8, e1, e2, n_slots = fused_mod.compile_fused_ops(
                    shards[0], ops)
                CS = part.n_cats * part.states
            for s in shards:
                if fast:
                    Ppad = s.n_patterns_padded
                    cl = torch.zeros((n_slots, CS, Ppad), dtype=torch.float32,
                                     device=s.device)
                    sc = torch.zeros((n_slots, 1, Ppad), dtype=torch.int32,
                                     device=s.device)
                    lnl, cl, sc = engine_mod.fused_update_eval(
                        s, self._table(s, idx8, e1, e2), brl, ri, cl, sc)
                else:
                    lnl, (_, cl, sc) = \
                        engine_mod.loglikelihood_with_buffers(s, ops, brl, ri)
                lnls.append(lnl)
                clvs.append(cl)
                scalers.append(sc)
            lnl = float(engine_mod.reduce_shards(lnls, part.device))
            self._incr_cache[i] = dict(key=key, part=part, brl=brl_np.copy(),
                                       clvs=clvs, scalers=scalers, lnl=lnl)
            return lnl, n_inner

        rows, changed = self._dirty_rows(ops, brl_np, cache["brl"],
                                         part.n_tips)
        if not rows and not changed:
            # the cached logL, not partition_loglh: a plain evaluation at
            # other lengths in between may have overwritten the latter
            return cache["lnl"], 0
        sub = np.asarray(rows, ops.dtype).reshape(-1, 5)
        table = None
        if fast and len(sub):
            table = fused_mod.compile_fused_ops(
                shards[0], sub, n_slots_min=cache["clvs"][0].shape[0])[:3]
        lnls = []
        for k, s in enumerate(shards):
            if fast:
                lnl, cl, sc = engine_mod.fused_update_eval(
                    s, None if table is None else self._table(s, *table),
                    brl, ri, cache["clvs"][k], cache["scalers"][k])
            else:
                lnl, cl, sc = engine_mod.loglikelihood_update(
                    s, sub, brl, ri, cache["clvs"][k], cache["scalers"][k])
            lnls.append(lnl)
            cache["clvs"][k], cache["scalers"][k] = cl, sc
        lnl = float(engine_mod.reduce_shards(lnls, part.device))
        cache.update(brl=brl_np.copy(), lnl=lnl)
        return lnl, len(rows)

    @staticmethod
    def _table(part, idx8, e1, e2):
        dev = part.device
        return (torch.as_tensor(idx8, device=dev),
                torch.as_tensor(e1, device=dev).long(),
                torch.as_tensor(e2, device=dev).long())

    # -- ancestral states (treeinfo.c:1558-1718) --------------------------
    def compute_ancestral(self, nodes=None):
        """Marginal ancestral state probabilities per partition
        (pllmod_treeinfo_compute_ancestral), each at that partition's
        branch lengths (a sharded partition's shards joined in pattern
        order). Returns a list of (nodes, probs [n_nodes, patterns,
        states]) per local partition."""
        from pllmod_tpu_torch.algorithm.ancestral import \
            ancestral_probabilities
        out = []
        for i in self.local_indices():
            t = self.tree.copy()
            t.lengths = np.asarray(self.partition_brlens(i))
            per = [ancestral_probabilities(s, t, nodes=nodes)
                   for s in shards_of(self.partitions[i])]
            out.append((per[0][0], join_patterns(
                self.partitions[i], [p for _, p in per], axis=1)))
        return out

    # -- brlen-scaler normalization (treeinfo.c:1101-1197) ----------------
    def normalize_brlen_scalers(self) -> None:
        """Rescale so that the pattern-weight-weighted mean scaler is 1,
        pushing the factor into the shared branch lengths (SCALED
        mode)."""
        if self.brlen_linkage != BRLEN_SCALED:
            return
        wsum = np.array([sum(float(s.pattern_weights.sum())
                             for s in shards_of(p)) if p is not None
                         else 0.0 for p in self.partitions])
        mean = float((self.brlen_scalers * wsum).sum() / wsum.sum())
        if mean <= 0:
            return
        self.brlen_scalers /= mean
        self.tree.lengths *= mean
