"""Branch-length optimization of all edges at once from directed CLVs —
PyTorch counterpart of ``pllmod_tpu.optimize.blo``.

The reference's iterative BLO (``pllmod_opt_optimize_branch_lengths_
local`` + ``recomp_iterative``, pll_optimize.c:1395-1951) walks the tree
edge by edge with a serial Newton per edge. Here, as in the JAX
package:

1. **Directed CLVs in O(n)**: one post-order and one pre-order pass give,
   for every edge (u, v), the two CLVs facing each other across it
   (:class:`DirectedTraversal`).
2. **Batched sumtables** of the edges a sub-sweep updates.
3. **Batched bracketed Newton**: those edges optimize at once, each
   against its own sumtable (the others held at their incoming
   lengths). Edge colors (:func:`_edge_colors`) make every sub-sweep a
   block Gauss-Seidel step; the smoothing driver keeps the best iterate
   and damps on overshoot.

Routing of a sweep (:func:`_blo_sweep`):

- float32 partition — the kernel pipeline: ``fused.pair_pmats``
  (``root_row=False``) → ``fused.fused_walk`` over the directed table →
  sumtables (kernel 8, :func:`pllmod_tpu_torch.ops.deriv.edge_sumtables`)
  of the sub-sweep's edges → the per-edge Newton (kernel 10) or, with
  ``fused_newton=False``, :func:`minimize_newton_multi` over kernel 9;
  kernel 9 also serves ``safe=True`` and :func:`_lnl_at`. On CUDA
  tensors a shape a kernel does not take raises; on CPU tensors the
  wrappers run their plain versions.
- float64 partition — the plain path: the serial engine
  (``clv.update_partials``) over the directed ops, ``derivatives``
  sumtables and :func:`minimize_newton_multi`.

Only the sub-sweep's own edges get sumtables and Newton steps (the JAX
package computes every edge and masks); the results of those edges are
the same. The driver (:func:`optimize_branch_lengths`) is the JAX
package's host loop; its one host sync a sweep is reading the sweep's
start logL.

Partitioned analyses (:func:`optimize_branch_lengths_treeinfo`, over a
:class:`~pllmod_tpu_torch.tree.treeinfo.TreeInfo`): UNLINKED runs the
single-partition driver per partition; LINKED and SCALED run Jacobi
sweeps over the shared lengths (:func:`_blo_sweep_multi`), each
partition's directed walk and sumtables at b·s_k, then one Newton over
all partitions: kernel 10 for K partitions when they are all float32
and their coefficient rows fit a block's shared memory
(``deriv.newton_fits``), else :func:`minimize_newton_multi` over the
summed per-partition derivatives with the chain rule df·s, ddf·s²
(pll_optimize.c:1249-1267). The JAX package's device-program drivers
(``_blo_run``, ``_blo_run_multi``) exist for the TPU's dispatch cost;
the port runs their host loops.

Under a site mesh (a sharded partition,
:mod:`pllmod_tpu_torch.parallel`; the JAX package's ``_blo_run_sharded``
/ ``_blo_run_multi_sharded``, blo.py:734-830) the same host loops run:
each shard builds its directed CLVs and sumtables on its own device
from tables compiled once (:func:`tables_for`), and every Newton
iteration sums the shards' derivatives (kernel 9 for float32) with
``engine.reduce_shards``, the reference's per-iteration reduce
(pll_optimize.c:1270-1286). Kernel 10 runs a whole Newton inside one
launch and cannot reduce across shards, so it is off under a mesh
(blo.py:741-742); so is the memory-bounded sweep, as in the JAX
package.

The chunked, memory-bounded BLO (:func:`optimize_branch_lengths_chunked`,
``blo.py:1059-1240`` in the JAX package) needs no directed buffer: one
bounded-slot edge-rooted traversal per edge
(:func:`compile_chunked_blo`), W of them stacked into one table a
window (:func:`_window_tables`, each traversal in its own slot range, as
SPR stacks its candidates' remainder trees), run through the same
engine switch (``edge_grad.directed_clvs``: kernel 2 for float32, the
serial engine for float64) and the same sumtable, Newton and SAFE steps
as a sweep (:func:`_blo_window`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pllmod_tpu_torch import profile
from pllmod_tpu_torch.common import (BRLEN_SCALED, BRLEN_UNLINKED,
                                     MAX_BRANCH_LEN, MIN_BRANCH_LEN,
                                     TOL_BRANCH_LEN)
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import deriv as kern
from pllmod_tpu_torch.ops import derivatives as deriv_mod
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.ops import fused as fused_mod
from pllmod_tpu_torch.ops.engine import reduce_shards, tables_on
from pllmod_tpu_torch.optimize.newton import minimize_newton_multi
from pllmod_tpu_torch.parallel.sharding import (SITES_AXIS, is_sharded,
                                                shard_partition)

MAX_NEWTON_ITERS = 10
N_POLISH = 4
# device-memory budget for the full-buffer BLO's working set (directed
# CLVs 3(n−2) slots + per-edge sumtables ~2n rows); past it, whole-tree
# smoothing routes to the O(n log n) bounded sweep (the JAX package's
# budget, so that routing matches it)
BLO_MEM_BUDGET = 8 << 30


class DirectedTraversal:
    """Compiled directed-CLV schedule for a tree (host-side, O(n)).

    Attributes:
      ops: int32 [3*(n_tips-2), 5] — schedule rows for every (inner node,
        direction) CLV. Node references encode tips as ``t < n_tips`` and
        directed slots as ``n_tips + slot``.
      edge_ref: int32 [n_edge_slots, 2] — per edge id, the references of
        the two CLVs facing each other across the edge (masked rows (0,0)).
      edge_mask: bool [n_edge_slots] — live edges.
    """

    def __init__(self, tree, root_tip: int = 0):
        n_tips = tree.n_tips
        self.n_tips = n_tips
        from pllmod_tpu_torch import native
        if native.available():
            out = native.directed_traversal(tree.edge_nodes, n_tips,
                                            tree.n_nodes, root_tip)
            if out is not None:
                # native fast path (identical slot numbering)
                ops, slot_de = out
                en = tree.edge_nodes
                live = en[:, 0] >= 0
                tip0 = en[:, 0] < n_tips
                tip1 = en[:, 1] < n_tips
                ref0 = np.where(tip0, en[:, 0], n_tips + slot_de[:, 0])
                ref1 = np.where(tip1, en[:, 1], n_tips + slot_de[:, 1])
                ok = (live & (tip0 | (slot_de[:, 0] >= 0))
                      & (tip1 | (slot_de[:, 1] >= 0)))
                edge_ref = np.zeros((len(en), 2), np.int32)
                edge_ref[ok, 0] = ref0[ok]
                edge_ref[ok, 1] = ref1[ok]
                self.ops = np.ascontiguousarray(ops)
                self.edge_ref = edge_ref
                self.edge_mask = np.asarray(ok)
                self._slot_de = slot_de
                self._en = en.copy()
                self._slot_of = None
                return
        adj = tree.adjacency()
        # root at root_tip's neighbor
        (r, _e0), = adj[root_tip]
        slot_of: dict[tuple[int, int], int] = {}
        rows: list[list[int]] = []

        def ref(node, toward):
            return node if node < n_tips else n_tips + slot_of[(node, toward)]

        # --- post-order: slot (u -> parent) for every inner u -------------
        post = tree.postorder(r, avoid_edge=_e0)
        for node, parent, pedge in post:
            if node < n_tips:
                continue
            par = parent if parent != -1 else root_tip
            kids = [(nbr, e) for nbr, e in adj[node]
                    if nbr != par and e != (pedge if parent != -1 else _e0)]
            assert len(kids) == 2, "tree must be binary for BLO"
            slot = len(rows)
            slot_of[(node, par)] = slot
            rows.append([slot, ref(kids[0][0], node), kids[0][1],
                         ref(kids[1][0], node), kids[1][1]])

        # --- pre-order: slots (u -> child) ---------------------------------
        stack = [(r, root_tip, _e0)]  # (node, parent, edge_to_parent)
        while stack:
            u, par, pe = stack.pop()
            if u < n_tips:
                continue
            kids = [(nbr, e) for nbr, e in adj[u] if e != pe]
            (c1, e1), (c2, e2) = kids
            for (c, ec), (o, eo) in (((c1, e1), (c2, e2)),
                                     ((c2, e2), (c1, e1))):
                slot = len(rows)
                slot_of[(u, c)] = slot
                rows.append([slot, ref(par, u), pe, ref(o, u), eo])
            stack.append((c1, u, e1))
            stack.append((c2, u, e2))

        edge_ref = np.zeros((len(tree.edge_nodes), 2), np.int32)
        edge_mask = np.zeros(len(tree.edge_nodes), bool)
        for e, (u, v) in enumerate(tree.edge_nodes):
            u, v = int(u), int(v)
            if u < 0:
                continue
            try:
                edge_ref[e] = (ref(u, v), ref(v, u))
                edge_mask[e] = True
            except KeyError:
                pass  # edge outside the traversed component
        self.ops = np.asarray(rows, np.int32).reshape(-1, 5)
        self.edge_ref = edge_ref
        self.edge_mask = edge_mask
        self._slot_of = slot_of

    @property
    def slot_of(self) -> dict:
        """(node, toward-neighbor) -> directed slot (built lazily on the
        native path)."""
        if self._slot_of is None:
            so = {}
            en, sd = self._en, self._slot_de
            for e in range(len(en)):
                u, v = int(en[e, 0]), int(en[e, 1])
                if u < 0:
                    continue
                if sd[e, 0] >= 0:
                    so[(u, v)] = int(sd[e, 0])
                if sd[e, 1] >= 0:
                    so[(v, u)] = int(sd[e, 1])
            self._slot_of = so
        return self._slot_of


def _host(value, to=float):
    """``to(value)``: a readback of a device value, which the host waits
    for; the span ``pllmod.blo.wait``."""
    with profile.span("pllmod.blo.wait"):
        return to(value)


def _host_lengths(brlens) -> np.ndarray:
    """The lengths ``brlens`` as a float64 numpy array on the host (a
    readback: :func:`_host`)."""
    return _host(brlens, lambda b: b.detach().cpu().double().numpy().copy())


def _edge_colors(tree, edge_mask=None):
    """Greedy proper edge coloring (host): no two same-color edges share
    a node, so a same-color batched Newton step is a true block
    Gauss-Seidel step. Trees have max degree 3, so greedy uses ≤ 3-4
    colors. Returns a list of bool [n_edge_slots] masks."""
    adj = tree.adjacency()
    n_edges = len(tree.edge_nodes)
    colors: dict[int, int] = {}
    for e, (u, v) in enumerate(tree.edge_nodes):
        u, v = int(u), int(v)
        if u < 0 or (edge_mask is not None and not edge_mask[e]):
            continue
        used = {colors.get(int(ee)) for n in (u, v) for _, ee in adj[n]
                if int(ee) != e}
        c = 0
        while c in used:
            c += 1
        colors[e] = c
    ncol = max(colors.values()) + 1 if colors else 1
    masks = [np.zeros(n_edges, bool) for _ in range(ncol)]
    for e, c in colors.items():
        masks[c][e] = True
    return masks


def _edge_sumtables(partition, clvs, scalers, edge_ref, eigen):
    """Plain-path sumtables of the edges whose facing-CLV references are
    ``edge_ref`` [K, 2], from serial-engine buffers. Returns
    (st [K, P, C, S], sc [K, P])."""
    clv_p, s_p = clv_mod.gather_node_clvs(partition, clvs, scalers,
                                          edge_ref[:, 0])
    clv_c, s_c = clv_mod.gather_node_clvs(partition, clvs, scalers,
                                          edge_ref[:, 1])
    return deriv_mod.sumtable(partition, clv_p, clv_c, eigen), s_p + s_c


def _safe_accept(t0, t_opt, l_old, l_new):
    """Per-edge eval-and-revert of the reference's SAFE mode
    (PLLMOD_OPT_BLO_NEWTON_SAFE, pll_optimize.c:1587-1632): an edge's
    proposed length is kept only if the tree logL with ONLY that edge
    changed (``l_new``, through the edge's own sumtable) does not drop
    below ``l_old``. The tolerance absorbs the dtype's rounding at the
    logL scale (the reference compares exactly, in double)."""
    dtype = t0.dtype
    l_old = l_old.to(dtype)
    eps = 32.0 * torch.finfo(dtype).eps * (1.0 + l_old.abs())
    return torch.where(l_new.to(dtype) >= l_old - eps, t_opt, t0)


@dataclasses.dataclass
class _Tables:
    """The per-call tables of a directed traversal on the partition's
    device: ``ops`` / ``edge_ref`` for the plain path; the fused-walk
    table and the derivative kernels' constants for the kernel path.
    For a sharded partition, ``shards[k]`` are shard k's tables (on its
    device) and the rest holds only ``kernel``, ``ops`` and
    ``n_slots``."""
    kernel: bool
    ops: np.ndarray
    edge_ref: torch.Tensor | None = None   # long [E, 2]
    idx8: torch.Tensor | None = None
    e1: torch.Tensor | None = None
    e2: torch.Tensor | None = None
    n_slots: int = 0
    eref6: torch.Tensor | None = None      # int32 [E, 6]
    codetab: torch.Tensor | None = None
    basis: torch.Tensor | None = None
    lw: torch.Tensor | None = None
    lnB: torch.Tensor | None = None
    shards: list | None = None


def tables_for(tabs: _Tables, partition) -> _Tables:
    """``tabs``, compiled for a partition of the same tree and dtype,
    made ``partition``'s: the op tables copied onto its device (never
    compiled again), its own code table and, where ``tabs`` has them,
    its own sumtable basis, weight rows and p-inv plane (a shard's
    patterns, another partition's model)."""
    dev = partition.device
    out = dataclasses.replace(tabs, **{
        f: tables_on(getattr(tabs, f), dev)
        for f in ("edge_ref", "idx8", "e1", "e2", "eref6")})
    if tabs.kernel:
        out.codetab = fused_mod.code_table(partition)
    if tabs.basis is not None:
        out.basis = kern.sumtable_basis(partition)
        out.lw = kern._lam_weight_rows(partition)
        out.lnB = kern.invar_log_plane(partition)
    return out


def _sharded_tables(partition, compile_one) -> _Tables:
    """A sharded partition's tables: ``compile_one(shard 0)`` once, made
    every other shard's by :func:`tables_for`."""
    first = compile_one(partition.shards[0])
    return _Tables(kernel=first.kernel, ops=first.ops,
                   n_slots=first.n_slots,
                   shards=[first] + [tables_for(first, s)
                                     for s in partition.shards[1:]])


def walk_tables(partition, ops, n_slots_min: int | None = None,
                serial: bool = False) -> _Tables:
    """The directed walk's tables of the op rows ``ops`` (rows with out
    slot −1 skipped) for ``partition``: kernel 2's table for float32, the
    rows alone for the serial engine. ``n_slots_min`` fixes the CLV
    buffer from below, for either engine (a table of several trees whose
    references reach past its last written slot). ``serial=True`` keeps
    the rows' order in kernel 2's table, as slot-recycled rows need
    (``fused.compile_fused_ops(serial=True)``); the serial engine runs
    rows in order either way."""
    if is_sharded(partition):
        return _sharded_tables(
            partition, lambda s: walk_tables(s, ops, n_slots_min, serial))
    tabs = _Tables(kernel=partition.dtype == torch.float32, ops=ops,
                   n_slots=n_slots_min or 0)
    if tabs.kernel:
        dev = partition.device
        idx8, e1, e2, n_slots = fused_mod.compile_fused_ops(
            partition, ops, n_slots_min=n_slots_min, serial=serial)
        tabs.idx8 = torch.as_tensor(idx8, device=dev)
        tabs.e1 = torch.as_tensor(e1, device=dev).long()
        tabs.e2 = torch.as_tensor(e2, device=dev).long()
        tabs.n_slots = n_slots
        tabs.codetab = fused_mod.code_table(partition)
    return tabs


def _compile_tables(partition, trav, derivs: bool = True) -> _Tables:
    """The tables of ``trav`` for ``partition``; ``derivs=False`` leaves
    out the derivative kernels' constants (the directed walk alone, as
    ``optimize/edge_grad.directed_clvs`` runs it)."""
    if is_sharded(partition):
        return _sharded_tables(
            partition, lambda s: _compile_tables(s, trav, derivs))
    dev = partition.device
    tabs = walk_tables(partition, trav.ops)
    tabs.edge_ref = torch.as_tensor(trav.edge_ref, device=dev).long()
    if tabs.kernel and derivs:
        tabs.eref6 = kern.compile_edge_refs(trav.edge_ref, trav.edge_mask,
                                            partition.n_tips, dev)
        tabs.basis = kern.sumtable_basis(partition)
        tabs.lw = kern._lam_weight_rows(partition)
        tabs.lnB = kern.invar_log_plane(partition)
    return tabs


def _directed_clvs(partition, tabs, brlens, P=None):
    """The kernel path's directed CLVs: the fused walk over the directed
    table (no root row) at ``brlens``, or at the P-matrices ``P``
    [E, C, S, S] of every edge when the caller has them."""
    if P is None:
        P5 = fused_mod.pair_pmats(partition, brlens, tabs.e1, tabs.e2,
                                  root_row=False)
    else:
        P5 = fused_mod.gather_pairs(P, tabs.e1, tabs.e2)
    return fused_mod.fused_walk(tabs.idx8, P5, partition.tip_states,
                                tabs.codetab, tabs.n_slots)


def _edge_evaluator(partition, tabs, brlens, edges):
    """Sumtables of the edge ids ``edges`` (long [K]) at ``brlens`` and
    their evaluator ``t [K] -> (logL, d/dt, d²/dt²)``, each edge through
    its own sumtable: the fused walk, kernel 8 and kernel 9 on the
    kernel path, the serial engine and the float64 formulation on the
    plain path. Returns (evaluator, (st, sc)). A sharded partition:
    every shard's sumtables on its own device, the evaluator reducing
    the shards' (logL, d/dt, d²/dt²) on the partition's device; (st,
    sc) is None."""
    if tabs.shards is not None:
        shards = partition.shards
        evs = [_edge_evaluator(s, t, brlens, edges.to(s.device))[0]
               for s, t in zip(shards, tabs.shards)]

        def reduced(t):
            per = [ev(t.to(s.device)) for ev, s in zip(evs, shards)]
            return tuple(reduce_shards(list(v), partition.device)
                         for v in zip(*per))
        return reduced, None
    from pllmod_tpu_torch.optimize.edge_grad import directed_clvs
    clvs, scalers, _ = directed_clvs(partition, tabs, brlens)
    if tabs.kernel:
        with profile.span("pllmod.blo.sumtables"):
            st, sc = kern.edge_sumtables(partition, clvs, scalers,
                                         tabs.eref6[edges], tabs.basis)

        def derivs(t):
            return kern.edge_derivatives_k(partition, st, sc, t, tabs.lw,
                                           tabs.lnB)
    else:
        eigen = partition.eigen()
        with profile.span("pllmod.blo.sumtables"):
            st, sc = _edge_sumtables(partition, clvs, scalers,
                                     tabs.edge_ref[edges], eigen)

        def derivs(t):
            return deriv_mod.edge_derivatives_batch(partition, st, sc, t,
                                                    eigen)
    return derivs, (st, sc)


@profile.spanned("pllmod.blo.newton")
def _newton_edges(partition, derivs, st, sc, t0, min_brlen, max_brlen,
                  tol, fused_newton: bool, lw=None, lnB=None, stats=None):
    """The bracketed Newton of every edge from ``t0`` against its own
    sumtable: kernel 10 with ``fused_newton`` (float32 sumtables ``st``,
    ``sc``), else :func:`minimize_newton_multi` over ``derivs``. Returns
    (t_opt, logL of each edge at ``t0``)."""
    if fused_newton:
        t_opt, lnl0, iters = kern.newton_edges(
            partition, st, sc, t0, min_brlen, max_brlen, tol,
            MAX_NEWTON_ITERS, lw, lnB)
        if stats is not None:
            stats["newton_iters"] += iters.sum()
            stats["newton_edges"] += len(t0)
        return t_opt.to(t0.dtype), lnl0

    def deriv_fn(t):
        _, df, ddf = derivs(t)
        return df.to(t.dtype), ddf.to(t.dtype)

    t_opt = minimize_newton_multi(deriv_fn, t0, min_brlen, max_brlen,
                                  tol=tol, max_iters=MAX_NEWTON_ITERS)
    return t_opt, derivs(t0)[0]


@profile.spanned("pllmod.blo.subsweep")
def _blo_sweep(partition, tabs, edges, brlens, min_brlen, max_brlen, tol,
               fused_newton: bool = True, safe: bool = False, stats=None):
    """One batched BLO (sub-)sweep over the edge ids ``edges`` (long
    [K], ascending; an edge-color class or every selected edge).
    Returns (new brlens, logL at the incoming brlens as a 0-dim tensor,
    read through ``edges[0]``'s sumtable)."""
    t0 = brlens[edges]
    derivs, sums = _edge_evaluator(partition, tabs, brlens, edges)
    st, sc = sums or (None, None)
    fused_newton = fused_newton and tabs.kernel and tabs.shards is None
    t_opt, lnl0_all = _newton_edges(partition, derivs, st, sc, t0,
                                    min_brlen, max_brlen, tol, fused_newton,
                                    tabs.lw, tabs.lnB, stats)
    if safe:
        # after the Newton kernel, the baseline comes through the same
        # evaluator as l_new, so that their rounding noise is symmetric
        l_old = derivs(t0)[0] if fused_newton else lnl0_all
        t_opt = _safe_accept(t0, t_opt, l_old, derivs(t_opt)[0])
    new = brlens.clone()
    new[edges] = t_opt.to(brlens.dtype)
    return new, lnl0_all[0].to(brlens.dtype)


def _blo_sweep_multi(parts, scalers, tabs_list, lws, edges, brlens,
                     min_brlen, max_brlen, tol, fused_newton: bool = True,
                     safe: bool = False, stats=None):
    """One Jacobi BLO sweep over branch lengths shared by the partitions
    ``parts`` (``blo._blo_sweep_multi``), over the edge ids ``edges``.

    Partition k sees lengths ``brlens · scalers[k]`` (SCALED linkage;
    scalers are 1.0 otherwise); its sumtables come from its own directed
    walk at those lengths (``tabs_list[k]``, :func:`_compile_tables`).
    The per-edge Newton runs over the sum of the partitions' derivatives
    in the shared length: kernel 10 for K partitions (``lws[k]``, the
    λr rows with the scaler folded in) when ``fused_newton`` and every
    partition is float32 and fits (``deriv.newton_fits``); else
    :func:`minimize_newton_multi` over kernel 9 / the float64
    formulation with the chain rule df·s, ddf·s² (always for sharded
    partitions, their derivatives reduced over the shards). ``stats``
    counts the edges of each route (``newton_edges``,
    ``iterative_edges``). Returns
    (new brlens, logL at the incoming brlens, summed over the
    partitions)."""
    t0 = brlens[edges]
    evals = [_edge_evaluator(part, tabs, brlens * s, edges)
             for part, s, tabs in zip(parts, scalers, tabs_list)]

    def summed(t):
        """Per edge, Σ_k (logL, s_k·d/dt, s_k²·d²/dt²) at t·s_k: the
        tree logL with only that edge at t and its derivatives in the
        shared length."""
        tot = None
        for (derivs, _), s in zip(evals, scalers):
            lnl, df, ddf = (v.to(t.dtype) for v in derivs(t * s))
            v = (lnl, df * s, ddf * (s * s))
            tot = v if tot is None else tuple(a + b for a, b in zip(tot, v))
        return tot

    kernel10 = (fused_newton
                and all(tabs.kernel and tabs.shards is None
                        for tabs in tabs_list)
                and kern.newton_fits(*parts))
    with profile.span("pllmod.blo.newton"):
        if kernel10:
            t_opt, lnl0_all, iters = kern.newton_edges_multi(
                parts, [st for _, (st, _) in evals],
                [sc for _, (_, sc) in evals], t0, scalers, min_brlen,
                max_brlen, tol, MAX_NEWTON_ITERS, lws,
                [tabs.lnB for tabs in tabs_list])
            t_opt = t_opt.to(t0.dtype)
            if stats is not None:
                stats["newton_iters"] += iters.sum()
                stats["newton_edges"] += len(t0)
        else:
            def deriv_fn(t):
                return summed(t)[1:]

            t_opt = minimize_newton_multi(deriv_fn, t0, min_brlen,
                                          max_brlen, tol=tol,
                                          max_iters=MAX_NEWTON_ITERS)
            lnl0_all = summed(t0)[0]
            if stats is not None:
                stats["iterative_edges"] += len(t0)
    if safe:
        l_old = summed(t0)[0] if kernel10 else lnl0_all
        t_opt = _safe_accept(t0, t_opt, l_old, summed(t_opt)[0])
    new = brlens.clone()
    new[edges] = t_opt.to(brlens.dtype)
    return new, lnl0_all[0].to(brlens.dtype)


@profile.spanned("pllmod.blo.final")
def _lnl_at(partition, tabs, brlens, edge: int):
    """Tree logL at ``brlens`` (0-dim tensor) through the sumtable of the
    live edge ``edge`` (kernel 9 on the kernel path)."""
    sel = torch.as_tensor([edge], device=brlens.device)
    derivs, _ = _edge_evaluator(partition, tabs, brlens, sel)
    return derivs(brlens[sel])[0][0].to(brlens.dtype)


def smooth(sweep, polish, brlens, max_sweeps: int, tolerance: float):
    """The smoothing loop of ``pllmod_opt_optimize_branch_lengths_local``
    (pll_optimize.c:1849-1919) over ``sweep(brlens) -> (new brlens,
    logL at the incoming brlens)``: sweeps until the logL gain drops
    below ``tolerance`` or ``max_sweeps`` is hit; a sweep that worsens
    logL is retried from a half step toward the best iterate; then
    :data:`N_POLISH` damped half-step ``polish`` sweeps from where it
    ended settle the oscillation that simultaneous updates can leave
    around the joint optimum. Each sweep and polish sweep is the span
    ``pllmod.blo.sweep``. Returns (best brlens, best logL, the last
    iterate, which no sweep has scored)."""
    best_brlens, best_lnl = brlens, -np.inf
    lnl_prev = None
    for _ in range(max_sweeps):
        with profile.span("pllmod.blo.sweep"):
            new_brlens, lnl_here = sweep(brlens)
        if lnl_here > best_lnl:
            best_lnl, best_brlens = lnl_here, brlens
        if lnl_prev is not None and lnl_here < lnl_prev - 1e-9:
            # overshoot: damp toward the best iterate and retry
            brlens = 0.5 * (best_brlens + new_brlens)
            lnl_prev = None
            continue
        brlens = new_brlens
        if lnl_prev is not None and abs(lnl_here - lnl_prev) < tolerance:
            break
        lnl_prev = lnl_here
    for _ in range(N_POLISH):
        with profile.span("pllmod.blo.sweep"):
            new_brlens, lnl_here = polish(brlens)
        if lnl_here > best_lnl:
            best_lnl, best_brlens = lnl_here, brlens
        brlens = 0.5 * (brlens + new_brlens)
    return best_brlens, best_lnl, brlens


def _bounded_blo_auto(partition, tree, mem_budget: int) -> bool:
    """True when whole-tree smoothing should run the memory-bounded
    sweep: a kernel-path (float32) partition whose full directed-CLV
    buffer + sumtable working set exceeds ``mem_budget`` bytes (e.g.
    ≥ ~800 taxa at 100k patterns)."""
    if partition.dtype != torch.float32 or tree.n_tips < 8:
        return False
    n = tree.n_tips
    cs = partition.n_cats * partition.states
    est = (3 * (n - 2) + 2 * (2 * n - 3)) * cs \
        * partition.n_patterns_padded * 4
    return est > mem_budget


def _edges_within_radius(tree, edge: int, radius: int):
    """Edge ids within BFS distance ``radius`` of ``edge``'s endpoints
    (the reference's local-BLO neighborhood, pll_optimize.c:1646-1682)."""
    adj = tree.adjacency()
    u, v = (int(x) for x in tree.edge_nodes[edge])
    seen_edges = {edge}
    frontier = [(u, 0), (v, 0)]
    visited = {u, v}
    while frontier:
        node, d = frontier.pop()
        if d >= radius:
            continue
        for nbr, e in adj[node]:
            seen_edges.add(int(e))
            if nbr not in visited:
                visited.add(nbr)
                frontier.append((nbr, d + 1))
    return sorted(seen_edges)


@profile.spanned("pllmod.blo")
def optimize_branch_lengths(partition, tree, max_sweeps: int = 32,
                            tolerance: float = 1e-4,
                            min_brlen: float = MIN_BRANCH_LEN,
                            max_brlen: float = MAX_BRANCH_LEN,
                            newton_tol: float = TOL_BRANCH_LEN,
                            write_back: bool = True,
                            edges=None, radius: int | None = None,
                            around_edge: int | None = None,
                            colored: bool = True, safe: bool = False,
                            fused_newton: bool = True,
                            mem_budget: int = BLO_MEM_BUDGET,
                            stats: dict | None = None,
                            mesh=None, mesh_axis: str | None = None):
    """Optimize the branch lengths of ``tree`` under ``partition``, on
    the partition's device.

    Driver semantics mirror ``pllmod_opt_optimize_branch_lengths_local``
    (smoothing loop, acceptance threshold, SAFE fallback): sweeps repeat
    until the logL gain drops below ``tolerance`` or ``max_sweeps`` is
    hit; a sweep that worsens logL is retried with half steps toward the
    best iterate; a few damped half-step polish sweeps follow, and the
    best iterate always wins.

    - ``colored=True``: each sweep runs as 3-4 edge-color sub-sweeps
      (block Gauss-Seidel); ``False``: plain Jacobi sweeps.
    - ``safe=True``: the reference's per-edge SAFE revert inside every
      sweep (:func:`_safe_accept`).
    - ``edges`` (edge ids) or ``around_edge`` + ``radius``: the
      reference's LOCAL mode; only that subset moves.
    - ``fused_newton``: float32 partitions run the per-edge Newton
      kernel (kernel 10); ``False`` runs :func:`minimize_newton_multi`
      over the derivative kernel (kernel 9).
    - ``mem_budget``: bytes; whole-tree smoothing of a float32 partition
      whose directed buffers would exceed it runs
      :func:`~pllmod_tpu_torch.optimize.blo_bounded.optimize_branch_lengths_bounded`.
    - ``stats``: optional dict, filled with ``route`` (``"directed"``, or
      ``"bounded"`` for the memory-bounded sweep), ``sweeps``,
      ``sub_sweeps`` and (kernel 10) ``newton_iters`` / ``newton_edges``.
    - ``mesh`` / ``mesh_axis``: site-sharded execution (a partition not
      yet sharded is sharded over the mesh; a sharded partition runs on
      its own mesh): every shard's sumtables, the derivatives reduced
      each Newton iteration; kernel 10 and the bounded sweep are off.

    Each call is the span ``pllmod.blo``; its children name the driver's
    steps (``pllmod.blo.prep``, ``.sweep``, ``.subsweep``, ``.walk``,
    ``.sumtables``, ``.newton``, ``.final`` and ``.wait``, the host's
    readbacks).

    Returns (brlens [n_edge_slots] tensor, logL float) and writes the
    lengths back into ``tree`` unless ``write_back=False``.
    """
    if mesh is not None:
        partition = shard_partition(partition, mesh, mesh_axis or SITES_AXIS)
    sharded = is_sharded(partition)
    fused_newton = fused_newton and not sharded
    if partition.eigen_lam is None:
        partition = partition.cache_eigen()
    if (edges is None and around_edge is None and not sharded
            and _bounded_blo_auto(partition, tree, mem_budget)):
        from pllmod_tpu_torch.optimize.blo_bounded import \
            optimize_branch_lengths_bounded
        return optimize_branch_lengths_bounded(
            partition, tree, max_sweeps=max_sweeps, tolerance=tolerance,
            min_brlen=min_brlen, max_brlen=max_brlen,
            newton_tol=newton_tol, write_back=write_back,
            colored=colored, fused_newton=fused_newton, stats=stats)
    dev = partition.device

    def ids(mask):
        return torch.as_tensor(np.nonzero(mask)[0], device=dev)

    with profile.span("pllmod.blo.prep"):
        trav = DirectedTraversal(tree)
        tabs = _compile_tables(partition, trav)
        mask_np = trav.edge_mask.copy()
        if around_edge is not None:
            edges = _edges_within_radius(
                tree, around_edge, radius if radius is not None else 1)
        if edges is not None:
            sel = np.zeros_like(mask_np)
            sel[np.asarray(list(edges), int)] = True
            mask_np &= sel
        # color classes emptied by an edge subset are dropped
        masks = ([cm for m in _edge_colors(tree, mask_np)
                  if (cm := m & mask_np).any()] if colored else []) \
            or [mask_np]
        sweep_sets = [ids(m) for m in masks]
        all_edges = ids(mask_np)
        first_edge = int(np.nonzero(mask_np)[0][0])
        brlens = torch.as_tensor(np.clip(tree.lengths, min_brlen,
                                         max_brlen),
                                 dtype=partition.dtype, device=dev)
        if stats is not None:
            stats.update(route="directed", sweeps=0, sub_sweeps=0,
                         newton_edges=0,
                         newton_iters=torch.zeros((), dtype=torch.int64,
                                                  device=dev))

    def sub_sweep(brl, sel):
        if stats is not None:
            stats["sub_sweeps"] += 1
        return _blo_sweep(partition, tabs, sel, brl, min_brlen, max_brlen,
                          newton_tol, fused_newton=fused_newton, safe=safe,
                          stats=stats)

    def sweep(brl):
        if stats is not None:
            stats["sweeps"] += 1
        lnl_start = None
        for sel in sweep_sets:
            brl, lnl_sub = sub_sweep(brl, sel)
            if lnl_start is None:
                lnl_start = _host(lnl_sub)   # logL at sweep-START brl
        return brl, lnl_start

    def polish(brl):
        new, lnl = sub_sweep(brl, all_edges)
        return new, _host(lnl)

    best_brlens, best_lnl, brlens = smooth(sweep, polish, brlens,
                                           max_sweeps, tolerance)
    final_lnl = _host(_lnl_at(partition, tabs, brlens, first_edge))
    if final_lnl >= best_lnl:
        best_lnl, best_brlens = final_lnl, brlens
    if stats is not None:
        stats["newton_iters"] = _host(stats["newton_iters"], int)
    if write_back:
        tree.lengths = _host_lengths(best_brlens)
    return best_brlens, best_lnl


def compile_chunked_blo(partition, tree, window: int):
    """Host-side schedule of :func:`optimize_branch_lengths_chunked`
    (``blo.compile_chunked_blo``): one bounded-slot edge-rooted traversal
    (:func:`~pllmod_tpu_torch.ops.clv.bounded_slot_ops` with the root
    edge's endpoints pinned) per live edge, stacked into windows of
    ``window`` edges. Windows never mix edge colors
    (:func:`_edge_colors`), so each window is a true block Gauss-Seidel
    step; each color class is padded to a multiple of ``window`` with
    masked rows (a copy of the first live edge's traversal).

    Returns numpy (ops_w [nWin, W, n_ops, 5], refs_w [nWin, W, 2],
    edge_ids [nWin, W], masks [nWin, W], n_slots), the JAX package's
    arrays."""
    n_tips = tree.n_tips
    live = []                      # edge id per row; -1 = padding row
    for cmask in _edge_colors(tree):
        cls = [int(e) for e in np.nonzero(cmask)[0]]
        live.extend(cls + [-1] * ((-len(cls)) % window))
    row_live = np.asarray([e >= 0 for e in live])
    pad_src = next(e for e in live if e >= 0)
    live = [pad_src if e < 0 else e for e in live]
    cache: dict[int, tuple] = {}
    n_slots = 0
    for e in live:
        if e in cache:
            continue
        ops, (u, v, _e) = tree.traversal_ops(root_edge=e)
        ops_b, ns, slot_map = clv_mod.bounded_slot_ops(
            np.asarray(ops), n_tips, root_refs=(int(u), int(v)))

        def remap(x):
            x = int(x)
            return x if x < n_tips else n_tips + int(slot_map[x - n_tips])

        cache[e] = (np.asarray(ops_b, np.int32), (remap(u), remap(v)))
        n_slots = max(n_slots, ns)
    n_win = len(live) // window
    ops_w = np.stack([cache[e][0] for e in live])
    refs_w = np.asarray([cache[e][1] for e in live], np.int32)
    shape = (n_win, window)
    return (ops_w.reshape(*shape, *ops_w.shape[1:]),
            refs_w.reshape(*shape, 2),
            np.asarray(live, np.int32).reshape(shape),
            row_live.reshape(shape), n_slots)


def _window_tables(partition, ops_w, refs_w, n_slots: int,
                   consts=None) -> _Tables:
    """One window's tables: its W bounded traversals stacked into one
    table, traversal k in slots [k·n_slots, (k+1)·n_slots) (only the
    slots are offset: the edge ids are the tree's, shared by all W), in
    the rows' own order (:func:`walk_tables`, ``serial=True``: kernel 2
    for float32, the serial engine for float64); ``edge_ref`` / ``eref6``
    hold the W facing-CLV pairs. ``consts``: the partition's (basis, lw,
    lnB) for the derivative kernels, computed once by the caller; without
    them the tables serve the walk alone."""
    W = ops_w.shape[0]
    n_tips = partition.n_tips
    off = (np.arange(W, dtype=np.int64) * n_slots)[:, None]
    ops = ops_w.astype(np.int64)
    ops[..., 0] += off
    for col in (1, 3):
        ops[..., col] += np.where(ops[..., col] >= n_tips, off, 0)
    refs = refs_w.astype(np.int64)
    refs += np.where(refs >= n_tips, off, 0)
    tabs = walk_tables(partition, ops.reshape(-1, 5), W * n_slots,
                       serial=True)
    dev = partition.device
    tabs.edge_ref = torch.as_tensor(refs, device=dev)
    if tabs.kernel:
        tabs.eref6 = kern.compile_edge_refs(refs, np.ones(W, bool), n_tips,
                                            dev)
        if consts is not None:
            tabs.basis, tabs.lw, tabs.lnB = consts
    return tabs


@profile.spanned("pllmod.blo.subsweep")
def _blo_window(partition, tabs, edge_ids, win_mask, brlens, min_brlen,
                max_brlen, tol, safe: bool = False):
    """One Gauss-Seidel WINDOW step of the memory-bounded BLO
    (``blo._blo_window``): the window's stacked traversals give the two
    CLVs facing each of its W edges, their sumtables (kernel 8 for
    float32) and one batched Newton (Jacobi within the window, every
    edge against its own sumtable at the incoming lengths:
    :func:`_newton_edges`, kernel 10 where ``deriv.newton_fits``, else
    :func:`minimize_newton_multi` over kernel 9 or the float64
    formulation). ``safe``: the per-edge SAFE revert (:func:`_safe_accept`).
    The masked write-back goes through a scratch row: padding rows all
    land on it, never on a live edge.

    Args:
      tabs: :func:`_window_tables`; edge_ids: long [W] edge ids into
        ``brlens``; win_mask: bool [W] live rows
    Returns (new brlens, logL at the incoming brlens as a 0-dim tensor,
    through the window's first row)."""
    rows = torch.arange(len(edge_ids), device=brlens.device)
    t_w = brlens[edge_ids]
    derivs, sums = _edge_evaluator(partition, tabs, brlens, rows)
    fused_newton = tabs.kernel and kern.newton_fits(partition)
    t_opt, lnl0_all = _newton_edges(partition, derivs, *sums, t_w, min_brlen,
                                    max_brlen, tol, fused_newton, tabs.lw,
                                    tabs.lnB)
    if safe:
        l_old = derivs(t_w)[0] if fused_newton else lnl0_all
        t_opt = _safe_accept(t_w, t_opt, l_old, derivs(t_opt)[0])
    E = brlens.shape[0]
    b_ext = torch.cat([brlens, brlens.new_zeros(1)])
    b_ext[torch.where(win_mask, edge_ids, E)] = t_opt.to(brlens.dtype)
    return b_ext[:E], lnl0_all[0].to(brlens.dtype)


@profile.spanned("pllmod.blo")
def optimize_branch_lengths_chunked(partition, tree, window: int = 16,
                                    max_sweeps: int = 32,
                                    tolerance: float = 1e-4,
                                    min_brlen: float = MIN_BRANCH_LEN,
                                    max_brlen: float = MAX_BRANCH_LEN,
                                    newton_tol: float = TOL_BRANCH_LEN,
                                    write_back: bool = True,
                                    safe: bool = False,
                                    stats: dict | None = None):
    """Memory-bounded branch-length optimization by windows of edges
    (``blo.optimize_branch_lengths_chunked``), on the partition's device.

    Sweeps run the windows of :func:`compile_chunked_blo` Gauss-Seidel
    style, each window a batched Jacobi step (:func:`_blo_window`), so
    that the live CLV memory is W × the bounded slot count (O((W + log
    n)·P·C·S) in the JAX package's words), never the 3(n−2) directed
    buffer. Every edge costs one O(n) bounded traversal a sweep. Sweeps
    stop when the logL at sweep start changes by less than
    ``tolerance``; the best sweep-start lengths are kept and the final
    iterate is scored (``engine.loglikelihood_bounded_fused``, kernel 2,
    for float32; ``engine.loglikelihood_bounded`` for float64).
    ``stats``: optional dict, filled with ``sweeps`` and ``windows``.

    Returns (brlens [n_edge_slots] tensor, logL float) and writes the
    lengths back into ``tree`` unless ``write_back=False``.
    """
    if partition.eigen_lam is None:
        partition = partition.cache_eigen()
    dev = partition.device
    with profile.span("pllmod.blo.prep"):
        ops_w, refs_w, edge_ids, masks, n_slots = compile_chunked_blo(
            partition, tree, window)
        consts = None
        if partition.dtype == torch.float32:
            consts = (kern.sumtable_basis(partition),
                      kern._lam_weight_rows(partition),
                      kern.invar_log_plane(partition))
        windows = [(_window_tables(partition, o, r, n_slots, consts),
                    torch.as_tensor(e, device=dev).long(),
                    torch.as_tensor(m, device=dev))
                   for o, r, e, m in zip(ops_w, refs_w, edge_ids, masks)]
        brlens = torch.as_tensor(np.clip(tree.lengths, min_brlen,
                                         max_brlen),
                                 dtype=partition.dtype, device=dev)
    if stats is not None:
        stats.update(sweeps=0, windows=len(windows))
    best_brlens, best_lnl = brlens, -np.inf
    lnl_prev = None
    for _ in range(max_sweeps):
        if stats is not None:
            stats["sweeps"] += 1
        brlens_start = brlens
        lnl_sweep = None
        with profile.span("pllmod.blo.sweep"):
            for tabs, eids, mask in windows:
                brlens, lnl0 = _blo_window(partition, tabs, eids, mask,
                                           brlens, min_brlen, max_brlen,
                                           newton_tol, safe=safe)
                if lnl_sweep is None:
                    lnl_sweep = _host(lnl0)   # logL at sweep-START brlens
        if lnl_sweep > best_lnl:
            best_lnl, best_brlens = lnl_sweep, brlens_start
        if lnl_prev is not None and abs(lnl_sweep - lnl_prev) < tolerance:
            break
        lnl_prev = lnl_sweep
    final = (engine_mod.loglikelihood_bounded_fused
             if partition.dtype == torch.float32
             else engine_mod.loglikelihood_bounded)
    with profile.span("pllmod.blo.final"):
        final_lnl = final(partition, tree, brlens=brlens)[0]
    final_lnl = _host(final_lnl)
    if final_lnl >= best_lnl:
        best_lnl, best_brlens = final_lnl, brlens
    if write_back:
        tree.lengths = _host_lengths(best_brlens)
    return best_brlens, best_lnl


def optimize_branch_lengths_treeinfo(treeinfo, max_sweeps: int = 32,
                                     tolerance: float = 1e-4,
                                     min_brlen: float = MIN_BRANCH_LEN,
                                     max_brlen: float = MAX_BRANCH_LEN,
                                     newton_tol: float = TOL_BRANCH_LEN,
                                     safe: bool = False,
                                     fused_newton: bool = True,
                                     stats: dict | None = None):
    """Multi-partition BLO across branch-length linkage modes
    (``blo.optimize_branch_lengths_treeinfo``;
    pllmod_opt_optimize_branch_lengths_local_multi, pll_optimize.c:
    1739-1951):

    - LINKED: one shared length set; per-edge derivatives summed over
      the partitions;
    - SCALED: shared lengths × per-partition scalers (held fixed here);
    - UNLINKED: each partition optimizes its own lengths with
      :func:`optimize_branch_lengths`.

    Under a mesh (``treeinfo.mesh``, sharded partitions) each partition's
    derivatives are reduced over its shards every Newton iteration, and
    kernel 10 is off. LINKED and SCALED run the JAX package's host loop over
    :func:`_blo_sweep_multi` (plain Jacobi sweeps, the best iterate
    kept, a worsening sweep retried from a half step toward it).
    ``stats``: optional dict, filled with ``sweeps`` and the Newton
    routes' counts (``newton_edges`` / ``newton_iters`` for kernel 10,
    ``iterative_edges`` for :func:`minimize_newton_multi`). Returns the
    total logL; the treeinfo's lengths (the tree's, or ``brlens`` in
    UNLINKED mode) are updated. A LINKED or SCALED call is the span
    ``pllmod.blo``; an UNLINKED one is its partitions' calls.
    """
    tree = treeinfo.tree
    if treeinfo.brlen_linkage == BRLEN_UNLINKED:
        total = 0.0
        for i in treeinfo.local_indices():
            t = tree.copy()
            t.lengths = treeinfo.brlens[i].copy()
            _, lnl = optimize_branch_lengths(
                treeinfo.partitions[i], t, max_sweeps=max_sweeps,
                tolerance=tolerance, min_brlen=min_brlen,
                max_brlen=max_brlen, newton_tol=newton_tol, safe=safe,
                fused_newton=fused_newton)
            treeinfo.brlens[i] = t.lengths
            treeinfo.partition_loglh[i] = lnl
            total += lnl
        return total

    with profile.span("pllmod.blo"):
        return _blo_shared(treeinfo, max_sweeps, tolerance, min_brlen,
                           max_brlen, newton_tol, safe, fused_newton, stats)


def _blo_shared(treeinfo, max_sweeps, tolerance, min_brlen, max_brlen,
                newton_tol, safe, fused_newton, stats):
    """LINKED and SCALED :func:`optimize_branch_lengths_treeinfo`: the
    Jacobi sweeps over the shared lengths (the arguments as there)."""
    tree = treeinfo.tree
    idxs = list(treeinfo.local_indices())
    for i in idxs:
        if treeinfo.partitions[i].eigen_lam is None:
            treeinfo.partitions[i] = treeinfo.partitions[i].cache_eigen()
    parts = tuple(treeinfo.partitions[i] for i in idxs)
    if treeinfo.brlen_linkage == BRLEN_SCALED:
        scalers = tuple(float(treeinfo.brlen_scalers[i]) for i in idxs)
    else:
        scalers = tuple(1.0 for _ in idxs)
    dtype, dev = parts[0].dtype, parts[0].device
    with profile.span("pllmod.blo.prep"):
        trav = DirectedTraversal(tree)
        tabs_list = [_compile_tables(p, trav) for p in parts]
        lws = [kern._lam_weight_rows(p, scale=s)
               for p, s in zip(parts, scalers)]
        live = np.nonzero(trav.edge_mask)[0]
        edges = torch.as_tensor(live, device=dev)
        first_edge = int(live[0])
        brlens = torch.as_tensor(np.clip(tree.lengths, min_brlen,
                                         max_brlen),
                                 dtype=dtype, device=dev)
    if stats is not None:
        stats.update(sweeps=0, newton_edges=0, iterative_edges=0,
                     newton_iters=torch.zeros((), dtype=torch.int64,
                                              device=dev))

    best_brlens, best_lnl = brlens, -np.inf
    lnl_prev = None
    for _ in range(max_sweeps):
        if stats is not None:
            stats["sweeps"] += 1
        with profile.span("pllmod.blo.sweep"):
            with profile.span("pllmod.blo.subsweep"):
                new_brlens, lnl_here = _blo_sweep_multi(
                    parts, scalers, tabs_list, lws, edges, brlens,
                    min_brlen, max_brlen, newton_tol,
                    fused_newton=fused_newton, safe=safe, stats=stats)
            lnl_here = _host(lnl_here)
        if lnl_here > best_lnl:
            best_lnl, best_brlens = lnl_here, brlens
        if lnl_prev is not None:
            if lnl_here < lnl_prev - 1e-9:
                brlens = 0.5 * (best_brlens + new_brlens)
                lnl_prev = None
                continue
            if abs(lnl_here - lnl_prev) < tolerance:
                brlens = new_brlens
                break
        lnl_prev = lnl_here
        brlens = new_brlens

    # the final iterate's logL, summed over the partitions
    final = sum(_host(_lnl_at(part, tabs, brlens * s, first_edge))
                for part, s, tabs in zip(parts, scalers, tabs_list))
    if final >= best_lnl:
        best_lnl, best_brlens = final, brlens
    if stats is not None:
        stats["newton_iters"] = _host(stats["newton_iters"], int)
    tree.lengths = _host_lengths(best_brlens)
    return best_lnl
