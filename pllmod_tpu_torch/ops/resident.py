"""Shared-memory-resident whole-traversal likelihood — the counterpart of
``pllmod_tpu.ops.pallas_resident`` (``_make_resident_kernel``).

A pruning traversal consumes each inner CLV exactly once, so under a
Sethi-Ullman evaluation order with slot recycling
(:func:`pllmod_tpu_torch.ops.clv.bounded_slot_ops`; pll_tree.c:1509-1573)
at most ~⌈log2 n_tips⌉+3 CLVs are live at any step. The CUDA kernel
``pllmod_resident_walk`` (``csrc/pruning.cu``) keeps that live set in
shared memory, one CTA per pattern tile (``_build.resident_tile``, chosen
per shape to fill the card; beyond 8 states after the fused walk's
pre-pass, which builds every row's tip tables into a scratch array), and
writes only the root
pseudo-node's per-category site product ``[C·S, Ppad]`` and total scaler
``[1, Ppad]`` to device memory. No CLV buffer ever exists there, so this
path returns the logL only.

On a CPU tensor the wrapper runs :func:`resident_walk_plain`, the same
arithmetic in plain torch; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch import profile
from pllmod_tpu_torch.common import ERROR_UNSUPPORTED, PllModError
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops.fused import code_table, pair_pmats


def resident_slot_bound(n_tips: int) -> int:
    """A topology-independent live-slot bound (Sethi-Ullman register need
    of a binary tree ≤ ⌈log2(n_leaves)⌉+1, +2 for the pinned root
    endpoints)."""
    return int(np.ceil(np.log2(max(n_tips, 2)))) + 3


def compile_resident(partition, tree, root_edge=None,
                     n_slots_min: int | None = None):
    """Compile a tree into the resident kernel's rows (on the partition's
    device): the serial slot-recycled schedule of
    :func:`~pllmod_tpu_torch.ops.clv.bounded_slot_ops` plus the root
    pseudo-node row.

    Returns (idx8 int32 [n_inner+1, 8], e1, e2 int64, n_slots); idx8
    columns are (slot1, slot2, is_tip1, is_tip2, tip1, tip2, out_slot,
    is_root) — the table of ``pallas_resident.compile_resident``.
    """
    ops, root_info = tree.traversal_ops(root_edge)
    u, v, e = (int(x) for x in root_info)
    n_tips = partition.n_tips
    ops_np = np.asarray(ops)
    live = ops_np[ops_np[:, 0] >= 0]
    ops_b, n_slots, slot_map = clv_mod.bounded_slot_ops(
        live, n_tips, root_refs=(u, v))
    rows8, e1s, e2s = [], [], []
    for out, c1, ee1, c2, ee2 in ops_b.tolist():
        it1 = 1 if c1 < n_tips else 0
        it2 = 1 if c2 < n_tips else 0
        rows8.append([0 if it1 else c1 - n_tips, 0 if it2 else c2 - n_tips,
                      it1, it2, c1 if it1 else 0, c2 if it2 else 0, out, 0])
        e1s.append(ee1)
        e2s.append(ee2)

    def enc(ref):
        return (0, 1, ref) if ref < n_tips else (slot_map[ref - n_tips], 0, 0)

    s_u, it_u, t_u = enc(u)
    s_v, it_v, t_v = enc(v)
    rows8.append([s_u, s_v, it_u, it_v, t_u, t_v, 0, 1])
    e1s.append(0)
    e2s.append(e)
    if n_slots_min is not None:
        n_slots = max(n_slots, n_slots_min)
    dev = partition.device
    return (torch.as_tensor(rows8, dtype=torch.int32, device=dev),
            torch.as_tensor(e1s, dtype=torch.int64, device=dev),
            torch.as_tensor(e2s, dtype=torch.int64, device=dev),
            n_slots)


def resident_walk(idx8, P5, tip_codes, codetab, n_slots: int,
                  tile: int | None = None):
    """Run a resident table: the root row's rescaled per-category site
    product (prod [C·S, Ppad] float32) and total scaler ([1, Ppad]
    int32). CUDA tensors launch the kernel (at pattern tile ``tile``, by
    default ``_build.resident_tile``'s); CPU tensors run the plain
    version."""
    if P5.device.type == "cpu":
        return resident_walk_plain(idx8, P5, tip_codes, codetab, n_slots)
    _, _, C, S, _ = P5.shape
    Ppad = tip_codes.shape[1]
    prod = torch.empty((C * S, Ppad), dtype=torch.float32, device=P5.device)
    scaler = torch.empty((1, Ppad), dtype=torch.int32, device=P5.device)
    _build.launch_walk("pllmod_resident_walk", idx8, P5, tip_codes, codetab,
                       prod, scaler, n_slots, tile)
    return prod, scaler


def resident_walk_plain(idx8, P5, tip_codes, codetab, n_slots: int):
    """Plain torch version of the resident kernel: the same row walk and
    arithmetic (:func:`pllmod_tpu_torch.ops.clv.walk_rows_plain`), of which
    only the last (root) row's output is returned."""
    clvs, scalers = clv_mod.walk_rows_plain(idx8, P5, tip_codes, codetab,
                                            n_slots)
    root_out = int(idx8[-1, 6])
    return clvs[root_out], scalers[root_out]


def loglikelihood_resident(partition, idx8, brlens, e12, n_slots: int):
    """Full-tree edge logL: per-row P-matrices → resident kernel → the
    p-inv / rate-weight epilogue (pallas_resident.py:610-613), the spans
    ``pllmod.eval.pmats``, ``.walk`` and ``.root``."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the resident kernel runs float32 partitions "
                          f"only (got {partition.dtype}); use "
                          "schedule='scan'")
    e1, e2 = e12
    C, S = partition.n_cats, partition.states
    with profile.span("pllmod.eval.pmats"):
        P5 = pair_pmats(partition, brlens, e1, e2, root_row=True)
    with profile.span("pllmod.eval.walk"):
        prod, rsc = resident_walk(idx8, P5, partition.tip_states,
                                  code_table(partition), n_slots)
    with profile.span("pllmod.eval.root"):
        per_cat = prod.to(partition.dtype).reshape(C, S, -1).sum(dim=1)
        lnl = lk_mod._site_lnl(partition, per_cat.T, rsc[0])
        return torch.sum(lnl * partition.pattern_weights)
