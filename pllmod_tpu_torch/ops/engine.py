"""Single-partition end-to-end likelihood evaluation — the counterpart of
``pllmod_tpu.ops.engine``: P-matrices → pruning → edge log-likelihood.

Schedules:

- ``"resident"``: the shared-memory-resident CUDA kernel
  (:mod:`pllmod_tpu_torch.ops.resident`) — logL only;
- ``"fused"``: the CUDA kernel that leaves every CLV in device memory
  (:mod:`pllmod_tpu_torch.ops.fused`);
- ``"pallas"``: the per-level CUDA kernels (:mod:`pllmod_tpu_torch.ops.
  levels`: kernel 3 then kernel 4 on every level of the
  :class:`~pllmod_tpu_torch.ops.clv.LevelSchedule`; the JAX package's
  name, kept so that callers port unchanged) — float32;
- ``"levels"``: the level-batched engine in plain torch
  (:func:`loglikelihood_levels`), any dtype;
- ``"scan"``: the serial reference engine (:func:`loglikelihood`), any
  dtype — the float64 path;
- ``"repeats"``: the host numpy float64 site-repeats engine
  (:mod:`pllmod_tpu_torch.ops.repeats`); returns a Python float;
- ``"auto"``: the rule of :func:`auto_schedule`.

The kernels' wrappers run their plain torch versions on CPU tensors, so
every schedule also runs on ``device="cpu"``.

For the partitioned layer (:mod:`pllmod_tpu_torch.tree.treeinfo`): the
per-site and buffer-returning evaluations, the partial traversal on
cached buffers (:func:`loglikelihood_update` on the serial engine,
:func:`fused_update_eval` on the fused kernel) and the K-partition
evaluation :func:`multi_eval`.

For a site mesh (:mod:`pllmod_tpu_torch.parallel`): :func:`reduce_shards`,
the one reduce every sharded driver uses (each shard's partial sums
moved to the mesh's first device and added there in shard order), and
the per-shard evaluators of :func:`shard_evaluators` (one table compile,
copied onto each shard's device by :func:`evaluator_on`), which
:func:`multi_eval` runs and reduces.
"""

from __future__ import annotations

import torch

from pllmod_tpu_torch import profile
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import fused as fused_mod
from pllmod_tpu_torch.ops import levels as levels_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops import repeats as repeats_mod
from pllmod_tpu_torch.ops import resident as resident_mod

SCHEDULES = ("auto", "resident", "fused", "pallas", "levels", "scan",
             "repeats")


def loglikelihood(partition, ops, brlens, root_info):
    """Full-traversal log-likelihood on the serial reference engine.

    Args:
      ops: int [n_inner, 5] from Tree.traversal_ops
      brlens: [n_edges] branch lengths (indexed by edge id)
      root_info: (node_u, node_v, root_edge) from Tree.traversal_ops
    """
    P = partition.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials(partition, P, ops)
    u, v, e = (int(x) for x in root_info)
    return lk_mod.edge_loglikelihood(partition, clvs, scalers, u, v, P[e])


def loglikelihood_persite(partition, ops, brlens, root_info):
    """(total, per-pattern logL [n_patterns_padded]) on the serial engine
    — the reference's ``persite`` out-array of
    pll_compute_edge_loglikelihood. The per-pattern entries are
    unweighted; total = Σ lnl · pattern_weights."""
    P = partition.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials(partition, P, ops)
    u, v, e = (int(x) for x in root_info)
    return lk_mod.edge_loglikelihood(partition, clvs, scalers, u, v, P[e],
                                     persite=True)


def loglikelihood_persite_fast(partition, tree, brlens=None,
                               root_edge=None):
    """(total, per-pattern logL) through the fused kernel with the root
    pseudo-node row: the site vector falls out of the fused-root epilogue
    (``fused.root_from_prod_slot``), one launch as a plain fused
    evaluation (float32 partitions)."""
    if brlens is None:
        brlens = tree.lengths
    idx8, e1, e2, ri, n_slots = fused_mod.compile_fused(
        partition, tree, root_edge, fuse_root=True)
    return fused_mod.loglikelihood_fused(partition, idx8, brlens, e1, e2, ri,
                                         n_slots, persite=True)


def loglikelihood_asc(partition, asc_partition, ops, brlens, root_info):
    """Log-likelihood with Lewis-type ascertainment-bias correction
    (libpll PLL_ATTRIB_AB_FLAG) on the serial engine:

        lnL = Σ_p w_p ln L_p − (Σ_p w_p) · ln(1 − Σ_j L_const_j)

    where ``asc_partition`` = :func:`pllmod_tpu_torch.ops.partition.
    make_asc_partition` holds the S constant-site patterns."""
    total, _ = loglikelihood_persite(partition, ops, brlens, root_info)
    _, lnl_const = loglikelihood_persite(asc_partition, ops, brlens,
                                         root_info)
    p_const = torch.sum(torch.exp(lnl_const) * asc_partition.pattern_weights)
    W = torch.sum(partition.pattern_weights)
    return total - W * torch.log1p(-p_const)


def loglikelihood_with_buffers(partition, ops, brlens, root_info):
    """As :func:`loglikelihood` but also returns (P, clvs, scalers) for
    incremental reuse."""
    P = partition.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials(partition, P, ops)
    u, v, e = (int(x) for x in root_info)
    lnl = lk_mod.edge_loglikelihood(partition, clvs, scalers, u, v, P[e])
    return lnl, (P, clvs, scalers)


def loglikelihood_update(partition, ops, brlens, root_info, init_clvs,
                         init_scalers):
    """Partial-traversal evaluation on the serial engine: only the given
    op rows, on top of cached buffers (the reference's CLV-validity
    protocol, treeinfo.c:38-61, 872-944). The cached buffers are copied,
    not modified. Returns (logL, clvs, scalers)."""
    P = partition.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials(partition, P, ops, init_clvs,
                                            init_scalers)
    u, v, e = (int(x) for x in root_info)
    lnl = lk_mod.edge_loglikelihood(partition, clvs, scalers, u, v, P[e])
    return lnl, clvs, scalers


def fused_update_eval(partition, table, brlens, root_info, clvs, scalers):
    """Partial-traversal evaluation on the fused kernel: only the dirty
    op rows on top of cached buffers (the CLV-validity protocol,
    treeinfo.c:872-944).

    ``table`` is a ``fused.compile_fused_ops`` table (idx8, e1, e2) of
    the dirty rows as tensors on the partition's device, or None when no
    row is dirty (then only the root-edge term is recomputed).
    ``clvs [n_slots, C·S, Ppad]`` / ``scalers [n_slots, 1, Ppad]`` are
    the prior buffers; the kernel writes the dirty slots into them in
    place (``fused.fused_walk(out=...)``) and clean slots are never
    touched. This is the port's counterpart of the JAX package's donated
    buffers: the caller keeps only the returned ones. ``root_info`` =
    (u, v, root_edge) in the table's slot numbering. Returns (logL, clvs,
    scalers)."""
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    if table is not None:
        idx8, e1, e2 = table
        P5 = fused_mod.pair_pmats(partition, brlens, e1, e2, root_row=False)
        clvs, scalers = fused_mod.fused_walk(
            idx8, P5, partition.tip_states, fused_mod.code_table(partition),
            clvs.shape[0], out=(clvs, scalers))
    u, v, e = (int(x) for x in root_info)
    P_root = partition.prob_matrices(brlens[e:e + 1])[0]
    lnl = levels_mod.root_loglikelihood_csp(partition, clvs, scalers, u, v,
                                            P_root)
    return lnl, clvs, scalers


def compile_schedule(partition, tree, root_edge=None):
    """Host-side: compile a tree into the level schedule and the remapped
    root info (``pllmod_tpu.ops.engine.compile_schedule``). Returns
    (levels tuple of int32 numpy [W_l, 5], offsets tuple, root_info,
    n_slots)."""
    ops, root_info = tree.traversal_ops(root_edge)
    sched = clv_mod.LevelSchedule(ops, partition.n_tips)
    u, v, e = (int(x) for x in root_info)
    ri = (sched.remap_node(u), sched.remap_node(v), e)
    return tuple(sched.levels), tuple(sched.offsets), ri, sched.n_slots


def loglikelihood_levels(partition, levels, brlens, offsets, root_info,
                         n_slots: int):
    """Level-batched log-likelihood: every node of a level in one batched
    product, with contiguous block writes (:func:`clv.
    update_partials_sched`), any dtype.

    Args:
      levels, offsets, n_slots: from :func:`compile_schedule` (the op
        arrays as numpy or as tensors on the partition's device)
      root_info: (u, v, e) with u/v remapped through the LevelSchedule
    """
    P = partition.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials_sched(partition, P, levels,
                                                  offsets, n_slots)
    u, v, e = root_info
    return lk_mod.edge_loglikelihood(partition, clvs, scalers, u, v, P[e])


def loglikelihood_bounded(partition, tree, brlens=None, root_edge=None):
    """Memory-bounded full-tree logL: the serial engine over the
    Sethi-Ullman slot-recycled schedule (pll_tree.c:1509-1573), so the
    CLV buffer holds only the O(log n) concurrently live slots.
    Returns (logL, n_slots)."""
    if brlens is None:
        brlens = tree.lengths
    ops, root_info = tree.traversal_ops(root_edge)
    u, v, e = (int(x) for x in root_info)
    n_tips = partition.n_tips
    ops_b, n_slots, slot_map = clv_mod.bounded_slot_ops(
        ops, n_tips, root_refs=(u, v))
    P = partition.prob_matrices(brlens)
    init = torch.zeros((n_slots, partition.n_patterns_padded,
                        partition.n_cats, partition.states),
                       dtype=partition.dtype, device=partition.device)
    clvs, scalers = clv_mod.update_partials(partition, P, ops_b, init)

    def remap(x):
        return x if x < n_tips else n_tips + slot_map[x - n_tips]

    lnl = lk_mod.edge_loglikelihood(partition, clvs, scalers, remap(u),
                                    remap(v), P[e])
    return lnl, n_slots


def loglikelihood_bounded_fused(partition, tree, brlens=None,
                                root_edge=None):
    """Memory-bounded full-tree logL on the fused kernel: the
    Sethi-Ullman slot-recycled schedule (:func:`clv.bounded_slot_ops`,
    O(log n) live slots) compiled in its original order
    (``fused.compile_fused_ops(serial=True)``) with the root pseudo-node
    row appended; a float32 partition. Returns (logL, n_slots)."""
    if brlens is None:
        brlens = tree.lengths
    ops, root_info = tree.traversal_ops(root_edge)
    u, v, e = (int(x) for x in root_info)
    n_tips = partition.n_tips
    ops_b, _, slot_map = clv_mod.bounded_slot_ops(ops, n_tips,
                                                  root_refs=(u, v))

    def remap(x):
        return x if x < n_tips else n_tips + int(slot_map[x - n_tips])

    idx8, e1, e2, n_slots = fused_mod.compile_fused_ops(partition, ops_b,
                                                        serial=True)
    idx8, e1, e2, root_slot = fused_mod.append_root_row(
        idx8, e1, e2, n_tips, remap(u), remap(v), e, n_slots)
    dev = partition.device
    lnl = fused_mod.loglikelihood_fused(
        partition, torch.as_tensor(idx8, device=dev), brlens,
        torch.as_tensor(e1, device=dev).long(),
        torch.as_tensor(e2, device=dev).long(),
        (u, v, e, root_slot), n_slots)
    return lnl, n_slots


RESIDENT_MIN_WARPS = 4     # an SM's warp schedulers


def fast_eval_schedule(partition, n_slots: int) -> str:
    """The evaluation kernel for this partition's shape on the H100.

    Rule: ``"resident"`` where the resident kernel's ``n_slots`` live
    slots (the compiled tree's own count,
    :func:`resident.compile_resident`) and a ring of four rows' tables
    fit a block's shared memory at its pattern tile (the tile, split or
    thread kind of ``_build.resident_config`` at
    ``_build.resident_tile``) and its grid either runs in one wave (every
    CTA resident at once) or keeps at least RESIDENT_MIN_WARPS warps that
    compute on each SM; ``"fused"`` otherwise. The split kind's producer
    warp does no arithmetic and is not counted, so at 17 to 20 states the
    rule routes every shape as it did the tile kind's C·T threads, where
    it was measured.
    Each resident thread carries one pattern column through every row,
    a chain of dependent rows: in one wave the walk takes one chain,
    whatever its warps; over several waves an SM runs one chain a wave,
    and with fewer warps than its four schedulers nothing hides the
    chain's latency. Measured with both kernels forced
    (``chip_smoke.py``'s routing sweep, device ms a launch, NVIDIA H100
    80GB HBM3 at 700 W; PERF.md), the rule picks the faster walk at
    every swept shape: resident at C·S 4 to 128 at 128 × 16384 and 64 ×
    4096 (DNA 0.115 against 0.181 ms; 32 states at 128 × 16384, four
    waves of 4 warps, 1.81 against 1.92) and at 512 × 4096 for 16 and 20
    states up to the 12-slot bound of 512 taxa (20 states 1.07 against
    2.27), fused for 32 states +Γ4 beyond 5 slots (tile 16: two waves of
    2 warps, 3.41 against 3.22; tile 8: 7.23 against 3.22; 2048 taxa,
    7 slots, 13.61 against 12.86), resident for 64 states +Γ1 in one
    wave of 1 warp (4.25 against 4.95), fused beyond (8.03 against
    4.95), and fused where only the global kind fits (64 states +Γ4, a
    few slots, tables read from device memory). The rule depends on the
    shape and ``n_slots`` only; the TPU's CS % 8 gate and its VMEM
    crossover are facts of Mosaic and do not apply here."""
    C, S, n_codes = (partition.n_cats, partition.states,
                     partition.code_clv.shape[0])
    Ppad = partition.n_patterns_padded
    T = _build.resident_tile(C, S, n_codes, n_slots, Ppad)
    cf = None if T is None else _build.resident_config(C, S, n_codes,
                                                       n_slots, T)
    if cf is None or cf["kind"] == "global":
        return "fused"
    k = _build.ctas_per_sm(cf["threads"], cf["smem"])
    one_wave = -(-Ppad // T) <= _build.SMS * k
    compute = cf["threads"] - (_build.WARP if cf["kind"] == "split" else 0)
    warps = -(-compute // 32) * k
    return ("resident" if one_wave or warps >= RESIDENT_MIN_WARPS
            else "fused")


def auto_schedule(partition, n_slots: int | None) -> str:
    """``schedule="auto"``: the kernel of :func:`fast_eval_schedule` for a
    float32 partition, the serial engine for float64 (the kernels'
    rescale is float32-exponent based; float64 runs ``"scan"``, as in the
    JAX package, and ``n_slots`` may be None). The kernels take every
    alphabet the registries define (up to 64 states) and up to 256 rate
    categories; a float32 partition beyond that raises in the kernel's
    wrapper, it is not rerouted."""
    if partition.dtype == torch.float32:
        return fast_eval_schedule(partition, n_slots)
    return "scan"


def use_fast_kernel(partition) -> bool:
    """True when the kernels are the partition's engine: float32 (the
    kernels' rescale is float32-exponent based). They launch on CUDA
    tensors and run their plain versions on CPU ones; float64 runs the
    serial engine. The JAX package's ``cs % 8`` gate is a fact of the
    TPU's tiling and does not apply here."""
    return partition.dtype == torch.float32


def reduce_shards(values, device):
    """The sum of the shards' partial values (tensors of one shape, each
    on its shard's device) on ``device``, added in shard order, so the
    result does not depend on which device finished first. float32
    partials are added in float64 and the sum rounded once. Autograd
    runs back through the cross-device copies. The port's counterpart of
    the JAX package's ``psum`` over the site axis (the reference's
    ``parallel_reduce_cb``, treeinfo.c:1061-1067)."""
    first = values[0]
    if len(values) == 1:
        return first.to(device)
    acc_dtype = (torch.float64 if first.dtype == torch.float32
                 else first.dtype)
    total = first.to(device, acc_dtype)
    for v in values[1:]:
        total = total + v.to(device, acc_dtype)
    return total.to(first.dtype)


def shard_evaluator(evs):
    """One evaluator ``ev(part, brlens) -> logL`` over the shards of a
    sharded partition: ``evs[k]`` (from :func:`shard_evaluators`) runs on
    ``part.shards[k]``, on that shard's device, and the logLs are
    reduced on the partition's first device (:func:`reduce_shards`)."""
    def ev(part, brl):
        return reduce_shards([e(p, brl) for e, p in zip(evs, part.shards)],
                             part.device)
    ev.schedule = evs[0].schedule
    ev.shards = evs
    return ev


def multi_eval(parts, brls, evs):
    """Evaluate K float32 partitions through their kernels: one
    evaluation each, issued back to back on the stream, and the K logLs
    stacked into one tensor [K] on the device, so that the caller syncs
    once for all of them. The JAX package compiles the K lanes into one
    program (``fast_lane_args`` / ``lane_ev`` build its lanes) because of
    the TPU's dispatch cost; here the lanes are ``evs``, each partition's
    :func:`compile_fast_eval` evaluator (the kernel of ``auto``).

    A sharded partition's entry of ``evs`` is the list of its shards'
    evaluators (:func:`shard_evaluators`): each shard evaluates on its
    own device and the shards' logLs are reduced (:func:`reduce_shards`)
    on the partition's first device, where every lane of a mesh then
    lies. The JAX package runs its lane program under ``shard_map`` with
    a ``psum`` (``engine.multi_eval(..., mesh)``).

    Args:
      parts: K partitions; brls: their branch lengths; evs: their
        evaluators ``ev(part, brlens) -> logL``, or lists of them
    """
    return torch.stack([
        (shard_evaluator(ev) if isinstance(ev, (list, tuple)) else ev)(
            p, brl) for p, brl, ev in zip(parts, brls, evs)])


def tables_on(obj, device):
    """``obj`` with every tensor inside its tuples, lists and dicts
    copied onto ``device`` (a tensor already there is kept): a host
    compile's device tables for a shard on another device."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tables_on(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: tables_on(v, device) for k, v in obj.items()}
    return obj


def _bound(schedule, run, tables):
    """The evaluator ``ev(part, brlens) = run(part, brlens, *tables)``,
    carrying its schedule, its function and its device tables; each call
    is the span ``pllmod.eval``."""
    def ev(part, brl):
        with profile.span("pllmod.eval"):
            return run(part, brl, *tables)
    ev.schedule, ev.run, ev.tables = schedule, run, tables
    return ev


def evaluator_on(ev, device):
    """The evaluator ``ev`` (of :func:`compile_fast_eval`) with its device
    tables copied onto ``device``: the same host compile serves a shard
    on another device. ``ev`` itself where its tables lie there."""
    tables = tables_on(ev.tables, torch.device(device))
    if all(a is b for a, b in zip(tables, ev.tables)):
        return ev
    return _bound(ev.schedule, ev.run, tables)


def shard_evaluators(partition, tree, root_edge=None, schedule="auto"):
    """The per-shard evaluators of a sharded partition
    (:class:`~pllmod_tpu_torch.parallel.sharding.ShardedPartition`): the
    tables of ``schedule`` compiled once, from shard 0 (every shard has
    the same shape), and copied onto each shard's device. Shards on one
    device share one evaluator."""
    shards = partition.shards
    first = compile_fast_eval(shards[0], tree, root_edge, schedule)
    by_dev = {shards[0].device: first}
    out = []
    for s in shards:
        if s.device not in by_dev:
            by_dev[s.device] = evaluator_on(first, s.device)
        out.append(by_dev[s.device])
    return out


def compile_fast_eval(partition, tree, root_edge=None, schedule="auto"):
    """Compile the host-side tables of ``schedule`` for this (partition
    shape, topology) once; returns ``ev(part, brlens) -> logL`` (a 0-dim
    tensor on the partition's device; a float for "repeats", which keeps
    no tables), with the schedule it runs as
    ``ev.schedule`` and its device tables as ``ev.tables``
    (:func:`evaluator_on` copies them onto another device). ``auto``
    decides on this tree's own resident slot count. ``part`` may differ
    from ``partition`` in model parameters, not in data or shape."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    table = None
    if schedule == "auto":
        if partition.dtype == torch.float32:
            table = resident_mod.compile_resident(partition, tree, root_edge)
        schedule = auto_schedule(partition,
                                 table[3] if table is not None else None)
    if schedule == "resident":
        idx8, e1, e2, n_slots = table or resident_mod.compile_resident(
            partition, tree, root_edge)

        def run(part, brl, idx8, e1, e2):
            return resident_mod.loglikelihood_resident(
                part, idx8, brl, (e1, e2), n_slots)
        tables = (idx8, e1, e2)
    elif schedule == "fused":
        idx8, e1, e2, ri, n_slots = fused_mod.compile_fused(
            partition, tree, root_edge, fuse_root=True)

        def run(part, brl, idx8, e1, e2):
            return fused_mod.loglikelihood_fused(part, idx8, brl, e1, e2,
                                                 ri, n_slots)
        tables = (idx8, e1, e2)
    elif schedule in ("pallas", "levels"):
        levels, offsets, ri, n_slots = compile_schedule(partition, tree,
                                                        root_edge)
        if schedule == "pallas":
            def run(part, brl, tabs):
                return levels_mod.loglikelihood_pallas(
                    part, levels, brl, offsets, ri, n_slots, tables=tabs)
            tables = (levels_mod.level_tables(partition, levels),)
        else:
            def run(part, brl, lvls):
                return loglikelihood_levels(part, lvls, brl, offsets, ri,
                                            n_slots)
            tables = (tuple(torch.as_tensor(lv, dtype=torch.int64,
                                            device=partition.device)
                            for lv in levels),)
    elif schedule == "repeats":

        def run(part, brl):
            return repeats_mod.loglikelihood_repeats(part, tree, brl,
                                                     root_edge)
        tables = ()
    else:
        ops, root_info = tree.traversal_ops(root_edge)

        def run(part, brl):
            return loglikelihood(part, ops, brl, root_info)
        tables = ()
    return _bound(schedule, run, tables)


def tree_loglikelihood(partition, tree, brlens=None, root_edge=None,
                       schedule: str = "auto"):
    """Compile the traversal of ``tree`` and evaluate its logL on the
    partition's device. ``schedule`` is one of :data:`SCHEDULES` (module
    docstring); a kernel schedule ("resident", "fused", "pallas") forced
    on a float64 partition raises. "repeats" returns a Python float, the
    others a 0-dim tensor."""
    if brlens is None:
        brlens = tree.lengths
    ev = compile_fast_eval(partition, tree, root_edge, schedule)
    return ev(partition, brlens)
