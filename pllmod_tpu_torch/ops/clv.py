"""Felsenstein-pruning CLV update engine — PyTorch counterpart of
``pllmod_tpu.ops.clv`` (libpll's ``pll_update_partials``).

What lives here:

- the **serial reference engine** (:func:`update_partials`): a Python loop
  over op rows ``(parent_slot, child1_node, child1_edge, child2_node,
  child2_edge)`` in the standard ``[slots, patterns, C, S]`` layout, with
  the exact frexp power-of-two rescale. It runs in any dtype and is the
  float64 path of ``schedule="scan"``;
- the **level-batched engine** (:func:`update_partials_sched`), every op
  of a :class:`LevelSchedule` level in one batched product, plain torch
  in any dtype (``schedule="levels"``);
- the **host schedulers** copied from the JAX package
  (:class:`LevelSchedule`, :func:`bounded_slot_ops`,
  :func:`_su_emission_order`), and the row arithmetic shared by the CUDA
  kernels' plain versions (:func:`apply_pmat`, :func:`rescale_bits`,
  :func:`walk_rows_plain`).

Node refs: ``node < n_tips`` is a tip (CLV gathered from the per-code
lookup table — the PATTERN_TIP analog), otherwise inner slot
``node - n_tips``. ``parent_slot == -1`` marks a masked (skipped) row.
"""

from __future__ import annotations

import numpy as np
import torch

LN2 = 0.6931471805599453


def tip_clv(partition, node: int):
    """A tip's CLV [patterns, S] from the code lookup table."""
    return partition.code_clv[partition.tip_states[node].long()]


def get_node_clv(partition, clvs, scalers, node: int):
    """CLV + scaler of any node (tip or inner):
    ([patterns, C, S], [patterns] int32)."""
    if node < partition.n_tips:
        clv = tip_clv(partition, node)
        C = partition.n_cats
        clv = clv[:, None, :].expand(clv.shape[0], C, clv.shape[1])
        return clv, torch.zeros(clv.shape[0], dtype=torch.int32,
                                device=clv.device)
    slot = node - partition.n_tips
    return clvs[slot], scalers[slot]


def gather_node_clvs(partition, clvs, scalers, nodes):
    """Batched CLV gather for a vector of node references (tips through
    the code lookup table, inner nodes from the slot buffer).

    nodes int [W]; clvs [n_buf, P, C, S], scalers [n_buf, P]. Returns
    ([W, P, C, S], [W, P])."""
    nodes = torch.as_tensor(nodes, device=clvs.device).long()
    n_tips = partition.n_tips
    C = clvs.shape[2]
    is_tip = nodes < n_tips
    codes = partition.tip_states[torch.where(is_tip, nodes, 0)].long()
    tclv = partition.code_clv[codes].to(clvs.dtype)           # [W, P, S]
    tclv = tclv[:, :, None, :].expand(-1, -1, C, -1)
    slot = torch.where(is_tip, 0, nodes - n_tips)
    clv = torch.where(is_tip[:, None, None, None], tclv, clvs[slot])
    sc = torch.where(is_tip[:, None], 0, scalers[slot])
    return clv.to(partition.dtype), sc


def update_partials_sched(partition, P, levels, offsets, n_slots: int,
                          init_clvs=None, init_scalers=None):
    """Level-batched pruning over a :class:`LevelSchedule`: every op of a
    level in one batched product, the level's block written into its
    contiguous slots, frexp rescale (``pllmod_tpu.ops.clv.
    update_partials_sched``; plain torch, as the JAX engine is XLA).

    Args:
      P: [edges, C, S, S] transition matrices
      levels: int [W_l, 5] op arrays of the schedule (renumbered; numpy
        or tensors on the partition's device)
      offsets: starting slot of each level
      init_clvs/init_scalers: optional starting buffers, updated in place
    Returns:
      (clvs [n_slots, patterns, C, S], scalers [n_slots, patterns])
    """
    Ppad, C, S = (partition.n_patterns_padded, partition.n_cats,
                  partition.states)
    dev, dtype = partition.device, partition.dtype
    clvs = init_clvs if init_clvs is not None else \
        torch.zeros((n_slots, Ppad, C, S), dtype=dtype, device=dev)
    scalers = init_scalers if init_scalers is not None else \
        torch.zeros((n_slots, Ppad), dtype=torch.int32, device=dev)
    for ops_lvl, off in zip(levels, offsets):
        ops_lvl = torch.as_tensor(ops_lvl, device=dev).long()
        c1, s1 = gather_node_clvs(partition, clvs, scalers, ops_lvl[:, 1])
        c2, s2 = gather_node_clvs(partition, clvs, scalers, ops_lvl[:, 3])
        left = torch.einsum("wpcj,wcij->wpci", c1, P[ops_lvl[:, 2]])
        right = torch.einsum("wpcj,wcij->wpci", c2, P[ops_lvl[:, 4]])
        clv, e = rescale(left * right, (2, 3))
        W = ops_lvl.shape[0]
        clvs[off:off + W] = clv
        scalers[off:off + W] = s1 + s2 + e[:, :, 0, 0]
    return clvs, scalers


def clv_op_compute(c1, c2, P1, P2):
    """One pruning op: clv_p[p,c,i] = (Σ_j P1[c,i,j] c1[p,c,j]) ·
    (Σ_j P2[c,i,j] c2[p,c,j]). Shapes: c* [P,C,S], P* [C,S,S]."""
    left = torch.einsum("pcj,cij->pci", c1, P1)
    right = torch.einsum("pcj,cij->pci", c2, P2)
    return left * right


def rescale(clv, dims):
    """Exact power-of-two per-site rescaling of the engines in torch
    (``jnp.frexp`` / ``jnp.ldexp``, unclipped): e = frexp exponent of the
    maximum over ``dims`` (kept, size 1; 0 where the maximum is ≤ 0).
    Returns (clv · 2^-e, e int32). The power of two is built from its
    float64 bits and the product rounded once, so a subnormal site
    maximum (2^-e beyond the float32 range) rescales as ldexp does."""
    m = clv.amax(dim=dims, keepdim=True)
    _, e = torch.frexp(m)
    e = torch.where(m > 0, e, torch.zeros_like(e)).to(torch.int32)
    pow2 = ((1023 - e.to(torch.int64)) << 52).view(torch.float64)
    return (clv.to(torch.float64) * pow2).to(clv.dtype), e


def update_partials(partition, P, ops, init_clvs=None, init_scalers=None):
    """Run the op rows in sequence (post-order), returning the CLV buffer.

    Args:
      partition: Partition
      P: [edges, C, S, S] transition matrices
      ops: int [n_ops, 5] (numpy or tensor); rows with parent_slot == -1
        are skipped
      init_clvs/init_scalers: optional starting buffers [n_buf, patterns,
        C, S] / [n_buf, patterns] (literal CLVs; slot-recycled schedules
        pass their n_slots rows); they are copied, not modified
    Returns:
      clvs [n_buf, patterns, C, S], scalers [n_buf, patterns] with
      n_buf = n_ops + 1 when no starting buffer is given (the JAX
      engine's layout: one row per op plus a scratch row)
    """
    rows = np.asarray(ops.cpu() if isinstance(ops, torch.Tensor) else ops)
    Ppad, C, S = (partition.n_patterns_padded, partition.n_cats,
                  partition.states)
    dev, dtype = partition.device, partition.dtype
    if init_clvs is None:
        clvs = torch.zeros((rows.shape[0] + 1, Ppad, C, S), dtype=dtype,
                           device=dev)
    else:
        clvs = init_clvs.to(dev, dtype).clone()
    if init_scalers is None:
        scalers = torch.zeros((clvs.shape[0], Ppad), dtype=torch.int32,
                              device=dev)
    else:
        scalers = init_scalers.to(dev, torch.int32).clone()
    for out, c1, e1, c2, e2 in rows.tolist():
        if out < 0:
            continue
        x1, s1 = get_node_clv(partition, clvs, scalers, c1)
        x2, s2 = get_node_clv(partition, clvs, scalers, c2)
        clv, e = rescale(clv_op_compute(x1, x2, P[e1], P[e2]), (1, 2))
        clvs[out] = clv
        scalers[out] = s1 + s2 + e[:, 0, 0]
    return clvs, scalers


# ---------------------------------------------------------------------------
# Row arithmetic of the CUDA pruning kernels (csrc/pruning.cu), in their
# CS×P layout. The kernels' plain versions (ops/resident.py, ops/fused.py)
# run this walk; every float operation is the kernel's, in the kernel's
# order — a rounded product, then a rounded sum, child state j = 0..S-1 —
# so kernel and plain version agree bit for bit.
# ---------------------------------------------------------------------------
def apply_pmat(Pk, x):
    """Σ_j Pk[...,c,i,j] · x[...,c,j,p] for Pk [..., C,S,S] and x
    [..., C,S,P] (leading dimensions broadcast: one matrix set for a
    batch of CLVs, or one a row), summed over j = 0..S-1 in order with
    separately rounded products and sums."""
    acc = Pk[..., 0, None] * x[..., None, 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + Pk[..., j, None] * x[..., None, j, :]
    return acc


def rescale_bits(prod):
    """The kernels' exact power-of-two rescale of a float32 [..., C, S, P]
    product: e = exponent field of the per-site max over (C, S) − 126 (0
    where the max is ≤ 0), clipped to [−125, 127], scale 2^−e built from
    its bits (pallas_resident.py:469-477). Agrees with frexp for normal
    maxima. Returns (scaled product, e [..., P])."""
    m = prod.amax(dim=(-3, -2))
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 126
    e = torch.where(m > 0, e, torch.zeros_like(e)).clamp(-125, 127)
    scale = ((127 - e) << 23).view(torch.float32)
    return prod * scale[..., None, None, :], e



def walk_rows_plain(idx8, P5, tip_codes, codetab, n_slots: int,
                    out=None):
    """The kernels' row walk in plain torch.

    Args:
      idx8: int [nW, 8] rows (slot1, slot2, is_tip1, is_tip2, tip1, tip2,
        out_slot, flag)
      P5: float32 [nW, 2, C, S, S] the two child matrices of each row
      tip_codes: int [n_tips, Ppad]; codetab: float32 [n_codes, S]
      out: optional prior (clvs, scalers) of the shapes below, written
        in place (slots no row writes keep their values)
    Returns:
      (clvs [n_slots, C·S, Ppad] float32, scalers [n_slots, 1, Ppad] int32)
      with every row's rescaled product and cumulative scaler stored in
      its out slot (slots no row writes stay zero, or as in ``out``).
    """
    _, _, C, S, _ = P5.shape
    Ppad = tip_codes.shape[1]
    dev = P5.device
    if out is None:
        out = (torch.zeros((n_slots, C * S, Ppad), dtype=torch.float32,
                           device=dev),
               torch.zeros((n_slots, 1, Ppad), dtype=torch.int32,
                           device=dev))
    slots = out[0].view(n_slots, C, S, Ppad)
    ssc = out[1].view(n_slots, Ppad)
    zero_sc = torch.zeros(Ppad, dtype=torch.int32, device=dev)

    def child(row, k):
        if row[2 + k]:
            x = codetab[tip_codes[row[4 + k]].long()].T        # [S, Ppad]
            return x[None].expand(C, S, Ppad), zero_sc
        return slots[row[k]], ssc[row[k]]

    rows = idx8.tolist() if isinstance(idx8, torch.Tensor) else idx8
    for w, row in enumerate(rows):
        x1, s1 = child(row, 0)
        x2, s2 = child(row, 1)
        prod = apply_pmat(P5[w, 0], x1) * apply_pmat(P5[w, 1], x2)
        scaled, e = rescale_bits(prod)
        slots[row[6]] = scaled
        ssc[row[6]] = s1 + s2 + e
    return out


# ---------------------------------------------------------------------------
# Host schedulers (numpy; copies of the JAX package's)
# ---------------------------------------------------------------------------
class LevelSchedule:
    """Dependency-leveled pruning schedule with CONTIGUOUS slot ranges.

    All ops in a level depend only on tips and earlier levels. Slots are
    renumbered level-by-level so every level writes a contiguous block.

    Attributes:
      levels: list of int32 [W_l, 5] arrays (parent_slot renumbered,
        child refs renumbered: < n_tips tip, else n_tips + new_slot)
      n_slots: total slot count
      offsets: per-level starting slot
      remap: int64 [n_slots] old slot -> new slot
    """

    def __init__(self, ops, n_tips: int):
        ops = np.asarray(ops)
        self.n_tips = n_tips
        level_of_slot: dict[int, int] = {}
        rows_by_level: dict[int, list] = {}
        for row in ops:
            slot = int(row[0])
            if slot < 0:
                continue
            deps = [level_of_slot[int(c) - n_tips]
                    for c in (row[1], row[3]) if int(c) >= n_tips]
            lvl = (max(deps) + 1) if deps else 0
            level_of_slot[slot] = lvl
            rows_by_level.setdefault(lvl, []).append(row.copy())

        n_old = max(level_of_slot, default=-1) + 1
        self.remap = np.full(max(n_old, 1), -1, np.int64)
        new = 0
        self.offsets = []
        ordered_levels = []
        for lvl in sorted(rows_by_level):
            self.offsets.append(new)
            rows = rows_by_level[lvl]
            for r in rows:
                self.remap[int(r[0])] = new
                new += 1
            ordered_levels.append(rows)
        self.n_slots = new
        # renumber child refs (children always live in earlier levels)
        self.levels = []
        for rows in ordered_levels:
            arr = np.stack(rows).astype(np.int32)
            arr[:, 0] = self.remap[arr[:, 0]]
            for col in (1, 3):
                inner = arr[:, col] >= n_tips
                arr[inner, col] = (n_tips +
                                   self.remap[arr[inner, col] - n_tips])
            self.levels.append(arr)

    def remap_node(self, node: int) -> int:
        """Translate an old node reference (tip or n_tips+old_slot)."""
        if node < self.n_tips:
            return int(node)
        return int(self.n_tips + self.remap[node - self.n_tips])

    @property
    def n_levels(self):
        return len(self.levels)


def _su_emission_order(live, n_tips: int):
    """Original-slot emission order of :func:`bounded_slot_ops` (the
    needier-child-first Sethi-Ullman postorder), without slot ids."""
    children = {int(r[0]): ((int(r[1]), int(r[2])),
                            (int(r[3]), int(r[4]))) for r in live}
    need = {}

    def compute_need(slot):
        stack = [(slot, False)]
        while stack:
            s2, done = stack.pop()
            if s2 in need:
                continue
            kids = [c - n_tips for (c, _e) in children[s2] if c >= n_tips]
            if done or not kids:
                n1 = need.get(kids[0], 0) if len(kids) > 0 else 0
                n2 = need.get(kids[1], 0) if len(kids) > 1 else 0
                if not kids:
                    need[s2] = 1
                elif len(kids) == 1:
                    need[s2] = max(n1, 1)
                else:
                    need[s2] = (n1 + 1) if n1 == n2 else max(n1, n2)
            else:
                stack.append((s2, True))
                for k in kids:
                    stack.append((k, False))

    roots = set(children) - {int(c) - n_tips for r in live
                             for c in (r[1], r[3]) if int(c) >= n_tips}
    order = []
    for r in sorted(roots):
        compute_need(r)
        stack = [(r, False)]
        while stack:
            s2, done = stack.pop()
            if done:
                order.append(s2)
            else:
                stack.append((s2, True))
                kids = [(c - n_tips) for (c, _e) in children[s2]
                        if c >= n_tips]
                kids.sort(key=lambda k: need[k])
                for k in kids:
                    stack.append((k, False))
    return order


def bounded_slot_ops(ops, n_tips: int, root_refs=None):
    """Reorder a pruning op table into a slot-recycling serial schedule
    (pll_tree.c:1509-1573 reusable CLV slots).

    Args:
      ops: int32 [n_inner, 5] from Tree.traversal_ops (masked rows
        dropped)
      n_tips: tip count
      root_refs: optional (u, v) node refs that must stay LIVE at the end
        (the virtual-root endpoints); their slots are never recycled.
    Returns:
      (ops_bounded [n_live, 5], n_slots, slot_map) — child refs remapped
      to the recycled slot space; ``slot_map[old_slot] = bounded slot``
      valid for slots alive at the END of the schedule (root endpoints).
    """
    ops = np.asarray(ops)
    live = ops[ops[:, 0] >= 0]
    children = {int(r[0]): ((int(r[1]), int(r[2])), (int(r[3]), int(r[4])))
                for r in live}

    # register need (Strahler-style): tips cost 0; evaluating the needier
    # child first bounds concurrent live slots by need(root) <= log2(n)+1
    need = {}

    def compute_need(slot):
        stack = [(slot, False)]
        while stack:
            s, done = stack.pop()
            if s in need:
                continue
            kids = [c - n_tips for (c, _e) in children[s] if c >= n_tips]
            if done or not kids:
                n1 = need.get(kids[0], 0) if len(kids) > 0 else 0
                n2 = need.get(kids[1], 0) if len(kids) > 1 else 0
                if not kids:
                    need[s] = 1
                elif len(kids) == 1:
                    need[s] = max(n1, 1)
                else:
                    need[s] = (n1 + 1) if n1 == n2 else max(n1, n2)
            else:
                stack.append((s, True))
                for k in kids:
                    stack.append((k, False))

    roots = set(children) - {int(c) - n_tips for r in live
                             for c in (r[1], r[3]) if int(c) >= n_tips}
    for r in sorted(roots):
        compute_need(r)

    out_rows = []
    slot_map = {}
    free = []
    next_slot = [0]
    pinned = set()
    if root_refs is not None:
        pinned = {int(x) - n_tips for x in root_refs if int(x) >= n_tips}

    def alloc():
        if free:
            return free.pop()
        s = next_slot[0]
        next_slot[0] += 1
        return s

    def emit(slot):
        # iterative post-order, needier child first
        stack = [(slot, False)]
        while stack:
            s, done = stack.pop()
            if done:
                (c1, e1), (c2, e2) = children[s]

                def ref(c):
                    return c if c < n_tips else n_tips + slot_map[c - n_tips]

                r1, r2 = ref(c1), ref(c2)
                # consume (free) child slots BEFORE allocating the parent
                for c in (c1, c2):
                    cs = c - n_tips
                    if c >= n_tips and cs not in pinned:
                        free.append(slot_map[cs])
                slot_map[s] = alloc()
                out_rows.append([slot_map[s], r1, e1, r2, e2])
            else:
                stack.append((s, True))
                kids = [(c - n_tips) for (c, _e) in children[s]
                        if c >= n_tips]
                kids.sort(key=lambda k: need[k])   # needier LAST = popped first
                for k in kids:
                    stack.append((k, False))
    for r in sorted(roots):
        emit(r)
    return (np.asarray(out_rows, np.int32), next_slot[0], slot_map)
