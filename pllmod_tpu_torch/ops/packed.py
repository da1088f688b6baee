"""Node-packed whole-traversal pruning — the counterpart of the packed
megakernel of ``pllmod_tpu.ops.pallas_clv`` (``_make_packed_kernel``,
``PackedSchedule``, ``update_partials_packed``, ``loglikelihood_packed``).

:class:`PackedSchedule` (host numpy, copied) orders every level of a
:class:`~pllmod_tpu_torch.ops.clv.LevelSchedule` by its consumers and pads
it to a multiple of G = ``max(1, 128 // C·S)`` rows with dummy rows (tip 0
on both sides, edge 0). Row ``r`` of the padded order writes slot ``r``:
CLVs ``[n_slots_pad, C·S, Ppad]`` float32 and scalers ``[n_slots_pad, 1,
Ppad]`` int32, the layout of the port's other walks, so
:func:`~pllmod_tpu_torch.ops.levels.root_loglikelihood_csp` reads the
root-edge term at ``root_info``.

:func:`packed_walk` (kernel 6, ``pllmod_packed_walk``,
``csrc/packed.cu``, the group-window walk of ``csrc/group_walk.cuh``)
runs every row in one launch, each with its two child matrices picked
from ``P [edges, C, S, S]`` by ``e1`` / ``e2``, over the schedule's
windows (:func:`window_offsets`: runs of rows none of which reads
another's slot, here the padded levels), R rows of a window at a time. The
JAX kernel's block-diagonal ``[G·C·S, G·C·S]`` packs, its
``kron(I_G, codetab)`` tip table and its DMA machinery only feed the
TPU's matrix unit and have no counterpart; the group structure stays in
the tables (``idxg``), which the tests hold against the JAX package's.
On a CPU tensor the wrapper runs :func:`packed_walk_plain`, the same
arithmetic in plain torch; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import ERROR_UNSUPPORTED, PllModError
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops.fused import code_table
from pllmod_tpu_torch.ops.levels import (level_combined_plain,
                                         root_loglikelihood_csp)


def window_offsets(reads) -> np.ndarray:
    """Row offsets [n_windows + 1] (int32) of a walk's rows cut into
    windows: the greedy runs of consecutive rows none of which reads the
    output of a row of its own run. ``reads`` [n_rows, 2]: the row whose
    output each child is (negative for a tip child); every such row
    comes earlier."""
    reads = np.asarray(reads).reshape(-1, 2)
    starts = [0]
    for r, row in enumerate(reads.max(axis=1)):
        if row >= r:
            raise ValueError(f"row {r} reads row {row}, not an earlier one")
        if row >= starts[-1]:
            starts.append(r)
    return np.asarray(starts + [len(reads)], np.int32)


def packed_reads(idxm) -> np.ndarray:
    """[n_rows, 2]: the slot (= row) each child of a packed table reads,
    −1 for a tip child."""
    m = np.asarray(idxm)
    return np.where(m[:, [1, 3]] != 0, -1, m[:, [0, 2]])


class PackedSchedule:
    """Host-compiled G-packed level schedule (``pallas_clv.
    PackedSchedule``).

    Attributes: G, nG, idxm [nG·G, 6] (slot1, is_tip1, slot2, is_tip2,
    tip1, tip2), idxg [nG, 8] (out_base_slot, fence, any_tip1, any_tip2,
    contig1, start_slot1, contig2, start_slot2), e1/e2 [nG·G] child edge
    ids (dummies -> edge 0), n_slots_pad, contig_frac, root_info (refs
    remapped to the padded slots), windows [n_windows + 1] (the walk's
    row offsets, :func:`window_offsets`: the padded levels). The tables
    are int32 tensors on the partition's device. The kernel reads
    ``idxm``, ``e1``, ``e2`` and ``windows``; ``idxg``'s fence and
    contiguous-gather columns drive the TPU kernel's DMAs and are kept
    for parity with the JAX package.
    """

    def __init__(self, partition, tree, root_edge=None, group: int = 0):
        ops, root_info = tree.traversal_ops(root_edge)
        sched = clv_mod.LevelSchedule(ops, partition.n_tips)
        n_tips = partition.n_tips
        CS = partition.n_cats * partition.states
        G = group or max(1, 128 // CS)
        self.G = G
        n_levels = len(sched.levels)
        self.n_slots = sched.n_slots

        # --- consumer-driven level reordering: each inner node has
        # exactly one consumer (its parent's op); sorting every level by
        # (consumer level, consumer group, side, consumer member) makes a
        # consumer group's side-k children a consecutive slot run
        consumer = {}
        for li, arr in enumerate(sched.levels):
            for r, row in enumerate(arr):
                for side, col in enumerate((1, 3)):
                    c = int(row[col])
                    if c >= n_tips:
                        consumer[c - n_tips] = (li, r, side)
        orders = [None] * n_levels
        pos_in_level = {}               # (level, row) -> new row index
        for li in reversed(range(n_levels)):
            off = sched.offsets[li]
            W = sched.levels[li].shape[0]
            if li == n_levels - 1:
                order = list(range(W))
            else:
                def key(r):
                    # root-edge endpoints have no consumer: sorted last
                    cl, crow, side = consumer.get(off + r, (n_levels, r, 0))
                    cpos = pos_in_level.get((cl, crow), crow)
                    return (cl, cpos // G, side, cpos % G)
                order = sorted(range(W), key=key)
            orders[li] = order
            for newpos, r in enumerate(order):
                pos_in_level[(li, r)] = newpos
        new_levels = [sched.levels[li][orders[li]] for li in range(n_levels)]

        # padded slot numbering over the new order
        pad_remap = np.full(sched.n_slots, -1, np.int64)
        pad_off = 0
        pad_offsets = []
        for li, arr in enumerate(new_levels):
            off = sched.offsets[li]
            pad_offsets.append(pad_off)
            for newpos, r in enumerate(orders[li]):
                pad_remap[off + r] = pad_off + newpos
            pad_off += -(-arr.shape[0] // G) * G
        self.n_slots_pad = pad_off

        idxm, idxg, e1s, e2s = [], [], [], []
        for li, arr in enumerate(new_levels):
            W = arr.shape[0]
            Wp = -(-W // G) * G
            pad = np.zeros(Wp - W, np.int64)
            c1 = np.concatenate([arr[:, 1], pad])
            c2 = np.concatenate([arr[:, 3], pad])
            it1 = (c1 < n_tips).astype(np.int64)
            it2 = (c2 < n_tips).astype(np.int64)
            slot1 = np.where(it1 == 1, 0, pad_remap[np.where(
                it1 == 1, 0, c1 - n_tips)])
            slot2 = np.where(it2 == 1, 0, pad_remap[np.where(
                it2 == 1, 0, c2 - n_tips)])
            idxm.append(np.stack([
                slot1, it1, slot2, it2,
                np.where(it1 == 1, c1, 0), np.where(it2 == 1, c2, 0),
            ], axis=1))
            e1s.append(np.concatenate([arr[:, 2], pad]))
            e2s.append(np.concatenate([arr[:, 4], pad]))
            for gi in range(Wp // G):
                sl = slice(gi * G, (gi + 1) * G)
                row = [pad_offsets[li] + gi * G,
                       1 if (li > 0 and gi == 0) else 0,
                       1 if it1[sl].any() else 0,
                       1 if it2[sl].any() else 0]
                for it, slot in ((it1, slot1), (it2, slot2)):
                    full = (gi + 1) * G <= W
                    contig = (full and not it[sl].any()
                              and (np.diff(slot[sl]) == 1).all())
                    row += [1 if contig else 0,
                            int(slot[sl][0]) if contig else 0]
                idxg.append(row)
        idxg = np.asarray(idxg, np.int32)
        dev = partition.device
        idxm = np.concatenate(idxm).astype(np.int32)
        self.windows = torch.as_tensor(window_offsets(packed_reads(idxm)),
                                       device=dev)
        self.idxm = torch.as_tensor(idxm, device=dev)
        self.idxg = torch.as_tensor(idxg, device=dev)
        self.e1 = torch.as_tensor(np.concatenate(e1s).astype(np.int32),
                                  device=dev)
        self.e2 = torch.as_tensor(np.concatenate(e2s).astype(np.int32),
                                  device=dev)
        self.nG = idxg.shape[0]
        self.contig_frac = float(idxg[:, (4, 6)].mean())
        u, v, e = (int(x) for x in root_info)

        def remap(node):
            if node < n_tips:
                return int(node)
            return n_tips + int(pad_remap[sched.remap[node - n_tips]])

        self.root_info = (remap(u), remap(v), e)


def packed_walk(idxm, e1, e2, P, tip_codes, codetab, G: int, windows=None,
                tile: int | None = None, lanes: int | None = None):
    """Run a packed schedule's whole traversal.

    Args:
      idxm: int32 [nG·G, 6]; e1, e2: int32 [nG·G] (:class:`PackedSchedule`)
      P: float32 [edges, C, S, S] transition matrices (row ``r`` takes
        ``P[e1[r]]`` and ``P[e2[r]]``)
      tip_codes: int32 [n_tips, Ppad]; codetab: float32 [n_codes, S]
      G: rows a group (the schedule's ``G``)
      windows: int32 [n_windows + 1] row offsets of the walk's windows
        (the schedule's ``windows``; by default cut from ``idxm`` on the
        host, :func:`window_offsets`)
      tile, lanes: force the kernel's pattern tile and row lanes (by
        default ``_build.group_walk_tile``'s)
    Returns:
      (clvs float32 [nG·G, C·S, Ppad], scalers int32 [nG·G, 1, Ppad]):
      row ``r``'s rescaled product and cumulative scaler in slot ``r``.
      CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if P.device.type == "cpu":
        return packed_walk_plain(idxm, e1, e2, P, tip_codes, codetab, G)
    n_rows = idxm.shape[0]
    E, C, S, _ = P.shape
    n_tips, Ppad = tip_codes.shape
    n_codes = codetab.shape[0]
    name = "pllmod_packed_walk"
    _build.check_tensors(name, [
        (P, torch.float32, (E, C, S, S)),
        (idxm, torch.int32, (n_rows, 6)),
        (e1, torch.int32, (n_rows,)), (e2, torch.int32, (n_rows,)),
        (tip_codes, torch.int32, (n_tips, Ppad)),
        (codetab, torch.float32, (n_codes, S))])
    if n_rows == 0 or n_rows % G:
        raise ValueError(f"{name}: rows ({n_rows}) must be a nonzero "
                         f"multiple of G ({G})")
    if windows is None:
        windows = torch.as_tensor(window_offsets(packed_reads(
            idxm.cpu().numpy())), device=P.device)
    _build.check_tensors(name, [(P, torch.float32, None),
                                (windows, torch.int32, None)])
    clvs = torch.empty((n_rows, C * S, Ppad), dtype=torch.float32,
                       device=P.device)
    scalers = torch.empty((n_rows, 1, Ppad), dtype=torch.int32,
                          device=P.device)
    _build.launch_group_walk(
        name, P.device, 2 * n_rows, n_rows, C, S, n_codes, Ppad, tile, lanes,
        (idxm.data_ptr(), e1.data_ptr(), e2.data_ptr(), n_rows, P.data_ptr(),
         E, tip_codes.data_ptr(), n_tips, codetab.data_ptr(), n_codes,
         clvs.data_ptr(), scalers.data_ptr()),
        (windows.data_ptr(), windows.shape[0] - 1))
    return clvs, scalers


def packed_walk_plain(idxm, e1, e2, P, tip_codes, codetab, G: int):
    """Plain torch version of :func:`packed_walk`: group by group, both
    children of every member (tips through the code table, inner
    children from their padded slots) times ``P[e1]`` / ``P[e2]``
    (products and sums rounded separately in state order), the product,
    the bit-formula rescale clipped to [−125, 127] and the scaler
    ``s1 + s2 + e``, written into the members' slots."""
    n_rows = idxm.shape[0]
    _, C, S, _ = P.shape
    Ppad = tip_codes.shape[1]
    dev = P.device
    clvs = torch.zeros((n_rows, C * S, Ppad), dtype=torch.float32,
                       device=dev)
    scalers = torch.zeros((n_rows, 1, Ppad), dtype=torch.int32, device=dev)
    # level_idx column order: (slot1, slot2, is_tip1, is_tip2, tip1, tip2)
    idx6 = idxm[:, [0, 2, 1, 3, 4, 5]]
    P1, P2 = P[e1.long()], P[e2.long()]
    for off in range(0, n_rows, G):
        s = slice(off, off + G)
        level_combined_plain(idx6[s], clvs, scalers, tip_codes, codetab,
                             P1[s], P2[s], off)
    return clvs, scalers


def update_partials_packed(partition, P, packed: PackedSchedule):
    """Whole-traversal pruning on the packed kernel
    (``pallas_clv.update_partials_packed``): (clvs [n_slots_pad, C·S,
    Ppad] float32, scalers [n_slots_pad, 1, Ppad] int32)."""
    return packed_walk(packed.idxm, packed.e1, packed.e2,
                       P.to(torch.float32).contiguous(),
                       partition.tip_states, code_table(partition), packed.G,
                       packed.windows)


def loglikelihood_packed(partition, brlens, packed: PackedSchedule):
    """Full-tree logL through the packed kernel (float32 partitions)."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the packed kernel runs float32 partitions only "
                          f"(got {partition.dtype}); use schedule='scan'")
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    P = partition.prob_matrices(brlens)
    clvs, scalers = update_partials_packed(partition, P, packed)
    u, v, e = packed.root_info
    return root_loglikelihood_csp(partition, clvs, scalers, u, v, P[e])
