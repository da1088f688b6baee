"""Grouped whole-traversal pruning with consumer-targeted writes — the
counterpart of ``pllmod_tpu.ops.pallas_grouped``.

:class:`GroupedSchedule` (host numpy, copied) list-schedules the inner
nodes of a single-consumer traversal into groups of G independent
members, every child produced in a strictly earlier group. Each group
owns an input buffer of Q = 2·G child positions (side-major: child
``k`` of member ``m`` at ``q = k·G + m``), and every member writes its
result straight into the position its consumer reads: ``dst_meta[g, m] =
(dst_group, dst_q)``. The two root-edge endpoints land in buffer ``nG``
at ``q = 0`` and ``1``; dummy members (tip/tip children of tip 0, edge
0) fill short groups and write rotating trash positions of that buffer.

:func:`grouped_walk` (kernel 7, ``pllmod_grouped_walk``,
``csrc/grouped.cu``, the group-window walk of ``csrc/group_walk.cuh``)
runs the whole schedule in one launch, the members in the level order of
their dependencies (:func:`walk_order`; the schedule's own group order
chains nearly every group to the one before) and R members of a window
at a time: buffers
``[nG + 1, Q, C·S, Ppad]`` float32 and ``[nG + 1, Q, Ppad]`` int32, each
member's product rescaled by the bit formula with its cumulative
scaler. Tip children are expanded from their codes and never stored, so
the tip positions of the buffers hold nothing; only the positions that
members write are defined. Matrices are per child, ``[nG, Q, C, S, S]``
(:func:`grouped_pmats`; the JAX package's block-diagonal ``[2GM, 2GM]``
packs only feed the TPU's matrix unit). On a CPU tensor the wrapper runs
:func:`grouped_walk_plain`, the same arithmetic in plain torch; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import ERROR_UNSUPPORTED, PllModError
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops.fused import code_table
from pllmod_tpu_torch.ops.levels import root_loglikelihood_csp
from pllmod_tpu_torch.ops.packed import window_offsets


def walk_order(side_meta, dst_meta):
    """The group-window walk's member order and windows of a grouped
    schedule's tables (numpy or tensors): (order int32 [nG·G], windows
    int32 [n_windows + 1]). A member's level is one more than the highest
    level of the members that write its inner children's positions (0
    where it has none: tips only, and the dummies); ``order`` lists the
    members ``g·G + m`` by level (in schedule order within one), walk row
    ``i`` being member ``order[i]``, and ``windows`` are that walk's row
    offsets cut by :func:`~pllmod_tpu_torch.ops.packed.window_offsets`:
    a level's rows read only rows of lower levels. (Windows of whole
    groups in the schedule's own order would hold one group each: it
    schedules the tallest ready node first, so nearly every group reads
    the one before.)"""
    side = np.asarray(side_meta.cpu() if torch.is_tensor(side_meta)
                      else side_meta)
    dst = np.asarray(dst_meta.cpu() if torch.is_tensor(dst_meta)
                     else dst_meta)
    nG, Q, _ = side.shape
    G = Q // 2
    writer = {}                                # (g, q) -> member id
    for g in range(nG):
        for m in range(G):
            writer[(int(dst[g, m, 0]), int(dst[g, m, 1]))] = g * G + m

    def producers(mid):
        g, m = divmod(mid, G)
        return [writer[(g, k * G + m)] if side[g, k * G + m, 0] == 0
                else -1 for k in range(2)]
    level = np.zeros(nG * G, np.int64)
    for mid in range(nG * G):                  # writers come earlier
        level[mid] = max((level[w] + 1 for w in producers(mid) if w >= 0),
                         default=0)
    order = np.argsort(level, kind="stable")
    rank = np.empty(nG * G, np.int64)
    rank[order] = np.arange(nG * G)
    reads = np.asarray([[rank[w] if w >= 0 else -1 for w in producers(mid)]
                        for mid in order], np.int64).reshape(-1, 2)
    return order.astype(np.int32), window_offsets(reads)


def pick_group(CS: int) -> int:
    """Members per group: the JAX package's rule (2·G·CS rows fill the
    TPU's 128-wide matrix unit), kept so that both schedules agree."""
    return max(1, 128 // (2 * CS))


class GroupedSchedule:
    """Host-compiled consumer-targeted group schedule
    (``pallas_grouped.GroupedSchedule``).

    Attributes:
      G, nG, Q (= 2G children a group), CS, GM (= G·CS)
      side_meta: int32 [nG, Q, 2] — (is_tip, tip_id) per child position
      dst_meta:  int32 [nG, G, 2] — (dst_group, dst_q) per member
      grp_meta:  int32 [nG, 2]    — (any tip on side 0, on side 1)
      e_sides:   int64 [nG, Q]    — child edge ids (dummies: 0);
        ``e_sides_np`` the same in numpy
      root_info: (ref_u, ref_v, root_edge) with inner refs n_tips + q
        pointing into the landing buffer (group nG)
      order, windows: int32 [nG·G], [n_windows + 1] — the group-window
        walk's member order and windows (:func:`walk_order`)
    The tables are tensors on the partition's device.
    """

    def __init__(self, partition, tree, root_edge=None, group: int = 0):
        ops, root_info = tree.traversal_ops(root_edge)
        ops = np.asarray(ops)
        n_tips = partition.n_tips
        CS = partition.n_cats * partition.states
        G = group or pick_group(CS)
        self.G, self.CS = G, CS
        self.GM = G * CS
        self.Q = 2 * G
        live = ops[ops[:, 0] >= 0]
        nR = live.shape[0]

        # node height (critical-path priority: schedule tall nodes first)
        height = {}
        for row in live:                       # ops are in topological order
            hs = [height.get(int(c) - n_tips, 0) + 1
                  for c in (row[1], row[3]) if int(c) >= n_tips]
            height[int(row[0])] = max(hs) if hs else 0

        # d>=1 list scheduling: a row is ready in group g iff every inner
        # child was scheduled in a group <= g-1
        group_of: dict[int, int] = {}          # out slot -> group
        remaining = sorted(range(nR),
                           key=lambda r: -height[int(live[r, 0])])
        groups: list[list[int]] = []
        while remaining:
            g = len(groups)
            members, rest = [], []
            for r in remaining:
                ok = all(group_of.get(int(c) - n_tips, g) < g
                         for c in (live[r, 1], live[r, 3])
                         if int(c) >= n_tips)
                if ok and len(members) < G:
                    members.append(r)
                else:
                    rest.append(r)
            if not members:
                raise RuntimeError("grouped schedule stalled (cycle?)")
            for r in members:
                group_of[int(live[r, 0])] = g
            groups.append(members)
            remaining = rest
        nG = len(groups)
        self.nG = nG

        # position of each row within its group
        pos_of: dict[int, tuple[int, int]] = {}    # out slot -> (g, m)
        for g, members in enumerate(groups):
            for m, r in enumerate(members):
                pos_of[int(live[r, 0])] = (g, m)

        side_meta = np.zeros((nG, self.Q, 2), np.int64)
        dst_meta = np.zeros((nG, G, 2), np.int64)
        grp_meta = np.zeros((nG, 2), np.int64)
        e_sides = np.zeros((nG, self.Q), np.int64)
        # default dst for dummy members: landing-buffer trash rows, a
        # rotating q so that two dummies of one group never write the
        # same rows
        u, v, e = (int(x) for x in root_info)
        trash_cycle = [q for q in range(self.Q) if q not in (0, 1)] or [0]
        for g, members in enumerate(groups):
            ti = 0
            for m in range(G):
                if m < len(members):
                    row = live[members[m]]
                    for k, (ccol, ecol) in enumerate(((1, 2), (3, 4))):
                        c = int(row[ccol])
                        q = k * G + m
                        e_sides[g, q] = int(row[ecol])
                        if c < n_tips:
                            side_meta[g, q] = (1, c)
                            grp_meta[g, k] = 1
                        else:
                            side_meta[g, q] = (0, 0)
                else:
                    # dummy member: tip/tip children of tip 0, edge 0 (a
                    # dummy marked inner would read undefined buffer rows)
                    for k in range(2):
                        side_meta[g, k * G + m] = (1, 0)
                        grp_meta[g, k] = 1
                    dst_meta[g, m] = (nG, trash_cycle[ti % len(trash_cycle)])
                    ti += 1

        # consumer-targeted dst assignment: each inner child is consumed
        # by exactly one (group, member, side); root endpoints land in
        # buffer nG at q=0 (u) / q=1 (v)
        consumed = set()
        for g, members in enumerate(groups):
            for m, r in enumerate(members):
                row = live[r]
                for k, ccol in enumerate((1, 3)):
                    c = int(row[ccol])
                    if c >= n_tips:
                        slot = c - n_tips
                        if slot in consumed:
                            raise ValueError(
                                "grouped kernel requires single-consumer "
                                f"traversals (slot {slot} consumed twice)")
                        consumed.add(slot)
                        pg, pm = pos_of[slot]
                        dst_meta[pg, pm] = (g, k * G + m)
        for ref, q in ((u, 0), (v, 1)):
            if ref >= n_tips:
                pg, pm = pos_of[ref - n_tips]
                dst_meta[pg, pm] = (nG, q)
        dev = partition.device
        self.side_meta = torch.as_tensor(side_meta.astype(np.int32),
                                         device=dev)
        self.dst_meta = torch.as_tensor(dst_meta.astype(np.int32), device=dev)
        self.grp_meta = torch.as_tensor(grp_meta.astype(np.int32), device=dev)
        self.e_sides_np = e_sides
        order, windows = walk_order(side_meta, dst_meta)
        self.order = torch.as_tensor(order, device=dev)
        self.windows = torch.as_tensor(windows, device=dev)
        self.e_sides = torch.as_tensor(e_sides, device=dev)
        ref_u = u if u < n_tips else n_tips + 0
        ref_v = v if v < n_tips else n_tips + 1
        self.root_info = (ref_u, ref_v, e)
        self.n_tips = n_tips


def grouped_pmats(partition, brlens, e_sides):
    """Per-child matrices [nG, Q, C, S, S] float32: P(t_e) for every
    child position's edge, one batched build (the counterpart of
    ``pallas_grouped.grouped_pq`` and ``_pq_from_pmats``; the cached
    eigendecomposition is used when the partition has one)."""
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    P = partition.prob_matrices(brlens[e_sides.reshape(-1)])
    return P.reshape(*e_sides.shape, *P.shape[1:]).to(
        torch.float32).contiguous()


def grouped_walk(side_meta, dst_meta, PQ, tip_codes, codetab, order=None,
                 windows=None, tile: int | None = None,
                 lanes: int | None = None):
    """Run a grouped schedule's whole traversal.

    Args:
      side_meta: int32 [nG, Q, 2]; dst_meta: int32 [nG, G, 2]
        (:class:`GroupedSchedule`)
      PQ: float32 [nG, Q, C, S, S] per-child matrices
      tip_codes: int32 [n_tips, Ppad]; codetab: float32 [n_codes, S]
      order, windows: int32 [nG·G], [n_windows + 1] — the walk's member
        order and windows (the schedule's; by default derived from the
        tables on the host, :func:`walk_order`)
      tile, lanes: force the kernel's pattern tile and row lanes (by
        default ``_build.group_walk_tile``'s)
    Returns:
      (bufs float32 [nG + 1, Q, C·S, Ppad], sbufs int32 [nG + 1, Q, Ppad]):
      every member's rescaled product and cumulative scaler at its
      (dst_group, dst_q); the positions no member writes are undefined
      (zero in the plain version). CUDA tensors launch the kernel; CPU
      tensors run the plain version.
    """
    if PQ.device.type == "cpu":
        return grouped_walk_plain(side_meta, dst_meta, PQ, tip_codes, codetab)
    nG, Q, C, S, _ = PQ.shape
    G = dst_meta.shape[1]
    n_tips, Ppad = tip_codes.shape
    n_codes = codetab.shape[0]
    name = "pllmod_grouped_walk"
    _build.check_tensors(name, [
        (PQ, torch.float32, (nG, Q, C, S, S)),
        (side_meta, torch.int32, (nG, Q, 2)),
        (dst_meta, torch.int32, (nG, Q // 2, 2)),
        (tip_codes, torch.int32, (n_tips, Ppad)),
        (codetab, torch.float32, (n_codes, S))])
    if order is None or windows is None:
        order, windows = (torch.as_tensor(t, device=PQ.device)
                          for t in walk_order(side_meta, dst_meta))
    _build.check_tensors(name, [(PQ, torch.float32, None),
                                (order, torch.int32, (nG * G,)),
                                (windows, torch.int32, None)])
    bufs = torch.empty((nG + 1, Q, C * S, Ppad), dtype=torch.float32,
                       device=PQ.device)
    sbufs = torch.empty((nG + 1, Q, Ppad), dtype=torch.int32,
                        device=PQ.device)
    _build.launch_group_walk(
        name, PQ.device, nG * Q, nG * G, C, S, n_codes, Ppad, tile, lanes,
        (side_meta.data_ptr(), dst_meta.data_ptr(), nG, G, PQ.data_ptr(),
         tip_codes.data_ptr(), n_tips, codetab.data_ptr(), n_codes,
         bufs.data_ptr(), sbufs.data_ptr()),
        (order.data_ptr(), windows.data_ptr(), windows.shape[0] - 1))
    return bufs, sbufs


def grouped_walk_plain(side_meta, dst_meta, PQ, tip_codes, codetab):
    """Plain torch version of :func:`grouped_walk`: group by group, both
    children of every member times their matrices (products and sums
    rounded separately in state order), the product, the bit-formula
    rescale, and the writes to each member's (dst_group, dst_q)."""
    nG, Q, C, S, _ = PQ.shape
    G = Q // 2
    Ppad = tip_codes.shape[1]
    dev = PQ.device
    bufs = torch.zeros((nG + 1, Q, C, S, Ppad), dtype=torch.float32,
                       device=dev)
    sbufs = torch.zeros((nG + 1, Q, Ppad), dtype=torch.int32, device=dev)
    for g in range(nG):
        is_tip = side_meta[g, :, 0] != 0
        tips = codetab[tip_codes[side_meta[g, :, 1].long()].long()]
        tips = tips.transpose(1, 2)[:, None].expand(Q, C, S, Ppad)
        x = torch.where(is_tip[:, None, None, None], tips, bufs[g])
        s = torch.where(is_tip[:, None], 0, sbufs[g])
        lr = clv_mod.apply_pmat(PQ[g], x)                    # [Q, C, S, Ppad]
        scaled, e = clv_mod.rescale_bits(lr[:G] * lr[G:])
        dg, dq = dst_meta[g, :, 0].long(), dst_meta[g, :, 1].long()
        bufs[dg, dq] = scaled
        sbufs[dg, dq] = s[:G] + s[G:] + e
    return bufs.view(nG + 1, Q, C * S, Ppad), sbufs


def update_partials_grouped(partition, sched: GroupedSchedule, PQ):
    """Whole-traversal pruning on the grouped kernel: (bufs, sbufs) of
    :func:`grouped_walk`; the landing buffer ``bufs[nG]`` holds the two
    root-facing CLVs at positions 0 and 1."""
    return grouped_walk(sched.side_meta, sched.dst_meta, PQ,
                        partition.tip_states, code_table(partition),
                        sched.order, sched.windows)


def loglikelihood_grouped(partition, brlens, sched: GroupedSchedule):
    """Full-tree logL through the grouped kernel (float32 partitions)."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the grouped kernel runs float32 partitions only "
                          f"(got {partition.dtype}); use schedule='scan'")
    u, v, e = sched.root_info
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    PQ = grouped_pmats(partition, brlens, sched.e_sides)
    P_root = partition.prob_matrices(brlens[e:e + 1])[0]
    bufs, sbufs = update_partials_grouped(partition, sched, PQ)
    return root_loglikelihood_csp(partition, bufs[sched.nG],
                                  sbufs[sched.nG][:, None], u, v, P_root)
