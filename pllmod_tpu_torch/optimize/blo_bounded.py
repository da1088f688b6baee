"""Memory-bounded O(n log n) whole-tree branch-length optimization —
PyTorch counterpart of ``pllmod_tpu.optimize.blo_bounded``.

The full-buffer sweep (:mod:`.blo`) holds 3(n−2) directed CLV slots.
This module walks the tree instead as a HEAVY-PATH EULER WALK, one
serial-order schedule for the fused kernel that

1. recomputes each *outer* (pre-order) CLV once per sweep while
   descending, holding only the root-to-current-node path of outer CLVs
   live (slot-recycled),
2. computes the *inner* (post-order) CLV of the SMALLER child subtree
   on the way down (a Sethi-Ullman bounded prepass, O(log n) transient
   slots), so that the larger child's outer CLV can be formed before
   descending into it, and
3. emits, for every edge, the pair of directed CLVs facing each other
   across it the moment both are live; each emit becomes a sumtable
   row and a bracketed Newton update (the reference's recomp_iterative
   regime, pll_optimize.c:778-926).

Recursing into the larger subtree first bounds the work per sweep by
n·log2(n) + O(n) CLV updates with ~2·depth + log2 n live slots.

The schedule is cut into SEGMENTS (``seg_rows`` walk rows, at most
``seg_emits`` emits each). :func:`_bounded_sweep` is a Python loop over
segments: the fused walk advances the carried slot buffer in place
(``fused.fused_walk(out=...)``: slots a segment does not write keep
their values), the segment's emits get sumtables (kernel 8) and the
per-edge Newton (kernel 10, or ``minimize_newton_multi`` over kernel 9),
and the optimized lengths go back into the carried lengths. The walk
needs float32 (the fused kernel); CPU tensors run the kernels' plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch import profile
from pllmod_tpu_torch.common import (ERROR_UNSUPPORTED, MAX_BRANCH_LEN,
                                     MIN_BRANCH_LEN, TOL_BRANCH_LEN,
                                     PllModError)
from pllmod_tpu_torch.ops import deriv as kern
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.ops import fused as fused_mod
from pllmod_tpu_torch.optimize.blo import (_edge_colors, _host,
                                          _host_lengths, _newton_edges,
                                          smooth)


# ---------------------------------------------------------------------------
# host-side schedule builder
# ---------------------------------------------------------------------------
class _SlotAlloc:
    """Free-list slot allocator with per-segment deferred frees: a slot
    referenced by a pending emit of the OPEN segment must survive until
    the segment's sumtable kernel has read it (emits execute against the
    buffer state at segment END), so its free is deferred to the segment
    boundary."""

    def __init__(self):
        self.free_list: list[int] = []
        self.next_slot = 0
        self.protected: set[int] = set()
        self.deferred: list[int] = []

    def alloc(self) -> int:
        if self.free_list:
            return self.free_list.pop()
        s = self.next_slot
        self.next_slot += 1
        return s

    def free(self, slot: int):
        if slot in self.protected:
            self.deferred.append(slot)
        else:
            self.free_list.append(slot)

    def protect(self, slot: int):
        self.protected.add(slot)

    def flush_segment(self):
        self.free_list.extend(self.deferred)
        self.deferred.clear()
        self.protected.clear()


class BoundedSweepSchedule:
    """Compiled segmented heavy-path Euler-walk BLO schedule (host-side).

    Attributes (all numpy, segment-major):
      seg_ops:   int32 [n_seg, R, 5] raw op rows (-1-padded)
      seg_edges: int32 [n_seg, W]    edge ids (0-padded)
      seg_refs:  int32 [n_seg, W, 2] facing-CLV refs (tip or n_tips+slot)
      seg_mask:  bool  [n_seg, W]    live emits
      n_slots:   peak live slots (excludes the kernel's scratch slot)
      n_rows / n_emits: live totals (schedule-size accounting)
    """

    def __init__(self, tree, seg_rows: int = 256, seg_emits: int = 64,
                 root_tip: int = 0):
        n_tips = tree.n_tips
        if n_tips < 4:
            raise ValueError("bounded BLO sweep needs >= 4 taxa")
        adj = tree.adjacency()
        (r, e0), = adj[root_tip]

        # rooted structure at root_tip's neighbor: children, subtree
        # sizes, Sethi-Ullman register need — one O(n) postorder pass
        post = tree.postorder(r, avoid_edge=e0)
        kids: dict[int, list[tuple[int, int]]] = {}
        size = {}
        need = {}
        parent_of = {}
        for node, par, pe in post:
            par = par if par != -1 else root_tip
            parent_of[node] = par
            if node < n_tips:
                size[node] = 1
                need[node] = 0
                continue
            pe_eff = pe if node != r else e0
            ks = [(nbr, e) for nbr, e in adj[node]
                  if not (nbr == par and e == pe_eff)]
            assert len(ks) == 2, "tree must be binary"
            kids[node] = ks
            (c1, _), (c2, _) = ks
            size[node] = 1 + size[c1] + size[c2]
            n1, n2 = need[c1], need[c2]
            need[node] = (n1 + 1) if n1 == n2 else max(n1, n2, 1)

        alloc = _SlotAlloc()
        segs: list[tuple[list, list]] = []
        rows_cur: list[list[int]] = []
        emits_cur: list[tuple[int, int, int]] = []

        def close_segment():
            if rows_cur or emits_cur:
                segs.append((rows_cur.copy(), emits_cur.copy()))
                rows_cur.clear()
                emits_cur.clear()
                alloc.flush_segment()

        def add_row(out_slot, r1, e1, r2, e2):
            rows_cur.append([out_slot, r1, e1, r2, e2])
            if len(rows_cur) >= seg_rows:
                close_segment()

        def add_emit(edge, ref1, ref2):
            emits_cur.append((edge, ref1, ref2))
            for rf in (ref1, ref2):
                if rf >= n_tips:
                    alloc.protect(rf - n_tips)
            if len(emits_cur) >= seg_emits:
                close_segment()

        def ref(slot):
            return n_tips + slot

        def prepass(node) -> int:
            """Inner (post-order) CLV of ``node`` toward its parent via
            a Sethi-Ullman bounded traversal; returns the slot (caller
            frees)."""
            res: dict[int, int] = {}
            stack = [(node, False)]
            while stack:
                v, done = stack.pop()
                if done:
                    (c1, ee1), (c2, ee2) = kids[v]
                    r1 = c1 if c1 < n_tips else ref(res[c1])
                    r2 = c2 if c2 < n_tips else ref(res[c2])
                    for c in (c1, c2):
                        if c >= n_tips:
                            alloc.free(res.pop(c))
                    s = alloc.alloc()
                    res[v] = s
                    add_row(s, r1, ee1, r2, ee2)
                else:
                    stack.append((v, True))
                    ks = sorted((c for c, _ in kids[v] if c >= n_tips),
                                key=lambda k: need[k])
                    stack.extend((k, False) for k in ks)
            return res[node]

        # --- heavy-path Euler walk (iterative state machine) -----------
        # frames: ("enter", v, pe, outer_ref) |
        #   ("resume1"/"resume2", v, pe, outer_ref, locals dict)
        ret: int | None = None          # last subtree's inner-CLV ref
        stack2: list[tuple] = [("enter", r, e0, root_tip)]
        while stack2:
            frame = stack2.pop()
            tag = frame[0]
            if tag == "enter":
                _, v, pe, outer_ref = frame
                (c1, ee1), (c2, ee2) = kids[v]
                # recurse into the LARGER subtree first: the prepass
                # (full postorder) always runs on the smaller child
                if size[c1] >= size[c2]:
                    a, e_a, b, e_b = c1, ee1, c2, ee2
                else:
                    a, e_a, b, e_b = c2, ee2, c1, ee1
                if b < n_tips:
                    ib0_ref = b
                    ib0_slot = None
                else:
                    ib0_slot = prepass(b)
                    ib0_ref = ref(ib0_slot)
                if ib0_slot is not None:
                    alloc.free(ib0_slot)       # read-before-write in-row
                sa = alloc.alloc()
                add_row(sa, outer_ref, pe, ib0_ref, e_b)
                loc = dict(a=a, e_a=e_a, b=b, e_b=e_b, sa=sa)
                stack2.append(("resume1", v, pe, outer_ref, loc))
                if a < n_tips:
                    ret = a
                else:
                    stack2.append(("enter", a, e_a, ref(sa)))
            elif tag == "resume1":
                _, v, pe, outer_ref, loc = frame
                inner_a = ret
                add_emit(loc["e_a"], ref(loc["sa"]), inner_a)
                alloc.free(loc["sa"])
                sb = alloc.alloc()
                add_row(sb, outer_ref, pe, inner_a, loc["e_a"])
                loc["sb"] = sb
                loc["inner_a"] = inner_a
                stack2.append(("resume2", v, pe, outer_ref, loc))
                if loc["b"] < n_tips:
                    ret = loc["b"]
                else:
                    stack2.append(("enter", loc["b"], loc["e_b"],
                                   ref(sb)))
            else:                                        # resume2
                _, v, pe, outer_ref, loc = frame
                inner_b = ret
                add_emit(loc["e_b"], ref(loc["sb"]), inner_b)
                alloc.free(loc["sb"])
                inner_a = loc["inner_a"]
                for rf in (inner_a, inner_b):
                    if rf >= n_tips:
                        alloc.free(rf - n_tips)
                sv = alloc.alloc()
                add_row(sv, inner_a, loc["e_a"], inner_b, loc["e_b"])
                ret = ref(sv)

        add_emit(e0, root_tip, ret)                     # the root edge
        close_segment()

        n_seg = len(segs)
        seg_ops = np.full((n_seg, seg_rows, 5), -1, np.int32)
        seg_edges = np.zeros((n_seg, seg_emits), np.int32)
        seg_refs = np.zeros((n_seg, seg_emits, 2), np.int32)
        seg_mask = np.zeros((n_seg, seg_emits), bool)
        n_rows = n_emits = 0
        for i, (rws, ems) in enumerate(segs):
            if rws:
                seg_ops[i, :len(rws)] = rws
            for j, (e, r1, r2) in enumerate(ems):
                seg_edges[i, j] = e
                seg_refs[i, j] = (r1, r2)
                seg_mask[i, j] = True
            n_rows += len(rws)
            n_emits += len(ems)
        self.n_tips = n_tips
        self.seg_rows = seg_rows
        self.seg_emits = seg_emits
        self.seg_ops = seg_ops
        self.seg_edges = seg_edges
        self.seg_refs = seg_refs
        self.seg_mask = seg_mask
        self.n_slots = alloc.next_slot
        self.n_rows = n_rows
        self.n_emits = n_emits

    # ------------------------------------------------------------------
    def compile_tables(self, partition):
        """Fused-walk tables of the sweep (numpy, as the JAX package's).
        Returns (idx8 [n_seg, R, 8], e1 [n_seg, R], e2 [n_seg, R],
        eref6 [n_seg, W, 6], edge_ids, emask, n_slots_kernel)."""
        n_slots_k = self.n_slots + 1                  # + kernel scratch
        R = self.seg_rows
        dummy8 = np.zeros((R, 8), np.int32)
        dummy8[:, 2] = dummy8[:, 3] = 1               # tip/tip children
        dummy8[:, 6] = n_slots_k - 1                  # scratch slot
        zeroR = np.zeros(R, np.int32)
        idx8s, e1s, e2s, erefs = [], [], [], []
        for i in range(self.seg_ops.shape[0]):
            # within-segment reorder (same writes, same last write per
            # slot: the segment-end buffer the emits read is unchanged)
            seg = _reorder_segment_rows(self.seg_ops[i], self.n_tips)
            if not (seg[:, 0] >= 0).any():
                idx8, e1, e2 = dummy8, zeroR, zeroR
            else:
                idx8, e1, e2, ns = fused_mod.compile_fused_ops(
                    partition, seg, serial=True, pad_to=R,
                    n_slots_min=n_slots_k)
                assert ns == n_slots_k, (ns, n_slots_k)
            idx8s.append(idx8)
            e1s.append(np.asarray(e1, np.int32))
            e2s.append(np.asarray(e2, np.int32))
            erefs.append(kern.compile_edge_refs_np(
                self.seg_refs[i], self.seg_mask[i], self.n_tips))
        return (np.stack(idx8s), np.stack(e1s), np.stack(e2s),
                np.stack(erefs), self.seg_edges.copy(), self.seg_mask.copy(),
                n_slots_k)


def _reorder_segment_rows(rows: np.ndarray, n_tips: int,
                          min_dist: int = 3) -> np.ndarray:
    """Reorder one segment's op rows so producers sit ≥ ``min_dist``
    rows ahead of their consumers where the dependency DAG allows
    (bounded-lookahead list scheduling over exact RAW/WAR/WAW edges on
    slot ids). Semantics-preserving: same writes, same
    last-write-per-slot, so the segment-end buffer state the emits read
    is unchanged. The JAX package reorders to cut its TPU kernel's fence
    count; the CUDA walk needs no fences, and the port keeps the
    reorder so that its tables equal the JAX package's row for row."""
    import bisect
    live_idx = np.nonzero(rows[:, 0] >= 0)[0]
    n = len(live_idx)
    if n <= 2:
        return rows
    lv = [list(map(int, rows[i])) for i in live_idx]
    preds: list[set] = [set() for _ in range(n)]
    last_writer: dict[int, int] = {}
    readers: dict[int, list] = {}
    for i, (o, r1, _e1, r2, _e2) in enumerate(lv):
        for r in (r1, r2):
            s = r - n_tips
            if r >= n_tips and s in last_writer:
                preds[i].add(last_writer[s])          # RAW
        if o in last_writer:
            preds[i].add(last_writer[o])              # WAW
        for j in readers.get(o, ()):                  # WAR
            if j != i:
                preds[i].add(j)
        readers[o] = []
        last_writer[o] = i
        for r in (r1, r2):
            if r >= n_tips:
                readers.setdefault(r - n_tips, []).append(i)
    succs_left = [0] * n
    children_of: list[list] = [[] for _ in range(n)]
    for i in range(n):
        for p in preds[i]:
            children_of[p].append(i)
    indeg = [len(preds[i]) for i in range(n)]
    ready = [i for i in range(n) if indeg[i] == 0]
    pos_of = [0] * n
    order = []
    raw_preds = []
    for i, (o, r1, _e1, r2, _e2) in enumerate(lv):
        rp = set()
        for r in (r1, r2):
            s = r - n_tips
            if r >= n_tips:
                # RAW producers only (fence condition)
                for p in preds[i]:
                    if lv[p][0] == s:
                        rp.add(p)
        raw_preds.append(rp)
    emitted = [False] * n
    while ready:
        pos = len(order)
        pick = None
        # prefer the EARLIEST-original ready row that is fence-free;
        # ready is kept in ascending original order (insertion sorted)
        for k, i in enumerate(ready[:16]):
            if all(pos - pos_of[p] >= min_dist for p in raw_preds[i]
                   if emitted[p]) and all(emitted[p]
                                          for p in raw_preds[i]):
                pick = k
                break
        if pick is None:
            pick = 0
        i = ready.pop(pick)
        pos_of[i] = pos
        emitted[i] = True
        order.append(i)
        for c in children_of[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                # keep ascending original order (stable tie-break)
                bisect.insort(ready, c)
    out = rows.copy()
    out[live_idx] = np.asarray([lv[i] for i in order], rows.dtype)
    return out


def validate_schedule(sched: BoundedSweepSchedule, tree) -> None:
    """Structural replay check (host): every emitted pair must be the two
    directed CLVs facing each other across its edge — i.e. their tip sets
    are the edge's bipartition. Raises AssertionError on any violation.
    Used by the test suite; O(n·depth) sets, small trees only."""
    n_tips = sched.n_tips
    all_tips = frozenset(range(n_tips))
    # edge splits
    adj = tree.adjacency()

    def side_tips(start, avoid_edge):
        seen = {start}
        out = set()
        stk = [start]
        while stk:
            u = stk.pop()
            if u < n_tips:
                out.add(u)
            for nbr, e in adj[u]:
                if e != avoid_edge and nbr not in seen:
                    seen.add(nbr)
                    stk.append(nbr)
        return frozenset(out)

    content: dict[int, frozenset] = {}
    for i in range(sched.seg_ops.shape[0]):
        for row in sched.seg_ops[i]:
            out_slot, r1, e1, r2, e2 = (int(x) for x in row)
            if out_slot < 0:
                continue

            def get(rf):
                return (frozenset([rf]) if rf < n_tips
                        else content[rf - n_tips])

            s1, s2 = get(r1), get(r2)
            assert not (s1 & s2), f"overlapping children at row {row}"
            content[out_slot] = s1 | s2
        for j in range(sched.seg_emits):
            if not sched.seg_mask[i, j]:
                continue
            e = int(sched.seg_edges[i, j])
            r1, r2 = (int(x) for x in sched.seg_refs[i, j])

            def get(rf):
                return (frozenset([rf]) if rf < n_tips
                        else content[rf - n_tips])

            s1, s2 = get(r1), get(r2)
            assert s1 | s2 == all_tips and not (s1 & s2), \
                f"emit {e}: not a bipartition"
            u, v = (int(x) for x in tree.edge_nodes[e])
            su = side_tips(u, e)
            assert s1 in (su, all_tips - su), \
                f"emit {e}: wrong split"


# ---------------------------------------------------------------------------
# device sweep
# ---------------------------------------------------------------------------
def _pass_plan(partition, sched, tables, cmask, gauss_seidel: bool):
    """Per segment, the device tables of one pass: (idx8, e1, e2 of its
    live rows or None, and the eref6 rows and edge ids of the emits this
    pass updates, or None). ``cmask``: bool [n_edge_slots], the pass's
    edge class (ignored with ``gauss_seidel``)."""
    idx8_s, e1_s, e2_s, eref_s, eids_s, em_s, _ = tables
    dev = partition.device
    plan = []
    for i in range(idx8_s.shape[0]):
        n_rows = int((sched.seg_ops[i, :, 0] >= 0).sum())
        walk = None
        if n_rows:
            walk = (torch.as_tensor(idx8_s[i, :n_rows], device=dev),
                    torch.as_tensor(e1_s[i, :n_rows], device=dev).long(),
                    torch.as_tensor(e2_s[i, :n_rows], device=dev).long())
        sel = em_s[i] if gauss_seidel else em_s[i] & cmask[eids_s[i]]
        js = np.nonzero(sel)[0]
        emits = None
        if len(js):
            emits = (torch.as_tensor(eref_s[i, js], device=dev),
                     torch.as_tensor(eids_s[i, js], device=dev).long())
        plan.append((walk, emits))
    return plan


@profile.spanned("pllmod.blo.subsweep")
def _bounded_sweep(partition, plan, n_slots: int, brlens, min_brlen,
                   max_brlen, tol, fused_newton: bool, gauss_seidel: bool,
                   basis, lw, lnB):
    """One bounded pass over the schedule (see the module docstring).

    ``gauss_seidel=False``: the walk's P matrices come from the INCOMING
    ``brlens`` for the whole pass (every CLV and sumtable mutually
    consistent) and only the plan's edge class updates — a block
    Gauss-Seidel sub-sweep like the full-buffer driver's color sweeps.
    ``gauss_seidel=True``: P matrices refresh per segment from the
    carried lengths (the cheaper single-pass mode).

    Returns (new_brlens, logL at pass-start brlens as a 0-dim tensor)."""
    C, S = partition.n_cats, partition.states
    Ppad = partition.n_patterns_padded
    dev = partition.device
    codetab = fused_mod.code_table(partition)
    bufs = (torch.zeros((n_slots, C * S, Ppad), dtype=torch.float32,
                        device=dev),
            torch.zeros((n_slots, 1, Ppad), dtype=torch.int32, device=dev))
    brl_frozen = brlens
    brl = brlens
    lnl0 = None
    for walk, emits in plan:
        if walk is not None:
            idx8, e1, e2 = walk
            with profile.span("pllmod.blo.walk"):
                P5 = fused_mod.pair_pmats(
                    partition, brl if gauss_seidel else brl_frozen, e1, e2,
                    root_row=False)
                fused_mod.fused_walk(idx8, P5, partition.tip_states,
                                     codetab, n_slots, out=bufs)
        if emits is None:
            continue
        eref, eids = emits
        with profile.span("pllmod.blo.sumtables"):
            st, sc = kern.edge_sumtables(partition, *bufs, eref, basis)
        t_new, lnl0_all = _newton_edges(
            partition,
            lambda t: kern.edge_derivatives_k(partition, st, sc, t, lw, lnB),
            st, sc, brl[eids], min_brlen, max_brlen, tol, fused_newton, lw,
            lnB)
        if lnl0 is None:
            lnl0 = lnl0_all[0].to(brl.dtype)
        brl = brl.clone()
        brl[eids] = torch.clamp(t_new.to(brl.dtype), min_brlen, max_brlen)
    return brl, lnl0


def optimize_branch_lengths_bounded(partition, tree, seg_rows: int = 256,
                                    seg_emits: int = 64,
                                    max_sweeps: int = 32,
                                    tolerance: float = 1e-4,
                                    min_brlen: float = MIN_BRANCH_LEN,
                                    max_brlen: float = MAX_BRANCH_LEN,
                                    newton_tol: float = TOL_BRANCH_LEN,
                                    write_back: bool = True,
                                    colored: bool = True,
                                    fused_newton: bool = True,
                                    stats: dict | None = None):
    """Memory-bounded whole-tree BLO at O(n log n) work per sweep, on the
    partition's device (a float32 partition: the fused walk).

    Driver semantics mirror the smoothing loop of
    ``pllmod_opt_optimize_branch_lengths_local`` (pll_optimize.c:
    1849-1919), as in :func:`.blo.optimize_branch_lengths`: sweeps until
    the logL gain at sweep start drops below ``tolerance``, damped retry
    on a worsening sweep, four damped polish sweeps, best iterate kept,
    final exact evaluation on the bounded fused engine.

    ``colored=True`` (default): each sweep runs as 3-4 edge-color passes
    with mutually consistent CLVs (block Gauss-Seidel); ``False`` runs
    the cheaper single-pass per-segment Gauss-Seidel. ``stats``: optional
    dict, filled with ``route`` (``"bounded"``), ``sweeps`` (polish
    sweeps included), ``passes`` and the schedule's ``n_slots``,
    ``n_rows`` and ``n_emits``.

    Returns (brlens [n_edge_slots] tensor, logL float); writes back into
    ``tree`` unless ``write_back=False``.
    """
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the bounded BLO runs the fused kernel: float32 "
                          f"partitions only (got {partition.dtype})")
    if partition.eigen_lam is None:
        partition = partition.cache_eigen()
    dev = partition.device
    with profile.span("pllmod.blo.prep"):
        sched = BoundedSweepSchedule(tree, seg_rows=seg_rows,
                                     seg_emits=seg_emits)
        tables = sched.compile_tables(partition)
        n_slots_k = tables[-1]
        brlens = torch.as_tensor(
            np.clip(np.asarray(tree.lengths, np.float64), min_brlen,
                    max_brlen), dtype=partition.dtype, device=dev)
        E = len(tree.edge_nodes)
        if colored:
            cmasks = [m for m in _edge_colors(tree) if m.any()]
        else:
            cmasks = [np.ones(E, bool)]
        plans = [_pass_plan(partition, sched, tables, cm, not colored)
                 for cm in cmasks]
        consts = dict(basis=kern.sumtable_basis(partition),
                      lw=kern._lam_weight_rows(partition),
                      lnB=kern.invar_log_plane(partition))
    if stats is not None:
        stats.update(route="bounded", sweeps=0, passes=len(plans),
                     n_slots=sched.n_slots, n_rows=sched.n_rows,
                     n_emits=sched.n_emits)

    def sweep(brl):
        if stats is not None:
            stats["sweeps"] += 1
        lnl_first = None
        for plan in plans:
            brl, lnl0 = _bounded_sweep(
                partition, plan, n_slots_k, brl, min_brlen, max_brlen,
                newton_tol, fused_newton=fused_newton,
                gauss_seidel=not colored, **consts)
            if lnl_first is None:
                lnl_first = _host(lnl0)
        return brl, lnl_first          # logL at sweep-START brl

    best_brlens, best_lnl, brlens = smooth(sweep, sweep, brlens, max_sweeps,
                                           tolerance)
    # the final iterate was optimized but never scored: exact bounded
    # evaluation (the same O(log n)-slot memory regime)
    with profile.span("pllmod.blo.final"):
        final_lnl, _ = engine_mod.loglikelihood_bounded_fused(
            partition, tree, brlens=brlens)
    final_lnl = _host(final_lnl)
    if final_lnl >= best_lnl:
        best_lnl, best_brlens = final_lnl, brlens
    if write_back:
        tree.lengths = _host_lengths(best_brlens)
    return best_brlens, best_lnl
