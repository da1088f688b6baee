"""Whole-traversal pruning with every CLV in device memory — the
counterpart of the evaluation part of ``pllmod_tpu.ops.pallas_clv``
(the fused megakernel, ``_make_fused_kernel``).

:func:`fused_walk` runs an idx8 op table (slot1, slot2, is_tip1,
is_tip2, tip1, tip2, out_slot, level fence) in one launch of the CUDA
kernel ``pllmod_fused_walk`` (``csrc/pruning.cu``) and returns every
CLV ``[n_slots, C·S, Ppad]`` float32 with its cumulative scaler row
``[n_slots, 1, Ppad]`` int32. The branch-length optimization, SPR and
incremental paths of later slices build on these buffers. The kernel
needs no level fences (a CTA walks its own pattern columns in order);
the tables keep the column for layout parity with the JAX package.

On a CPU tensor the wrapper runs :func:`fused_walk_plain`, the same
arithmetic in plain torch; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import ERROR_UNSUPPORTED, PllModError
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod

LAUNCHES = 0            # launches of the fused kernel (counted by fused_walk)


def compile_fused_ops(partition, ops):
    """Compile a pruning-op list for the fused kernel, PRESERVING the op
    table's slot numbering (pallas_clv.compile_fused_ops, level mode).

    Rows are emitted in dependency-level order; column 7 flags the first
    row of each level after the first. Returns (idx8 [n_live, 8], e1, e2,
    n_slots) as int numpy arrays, with n_slots = max_slot + 2 (the last
    slot is scratch).
    """
    ops = np.asarray(ops)
    n_tips = partition.n_tips
    live = ops[ops[:, 0] >= 0]
    if live.size == 0:
        raise ValueError("no live ops")
    level_of: dict[int, int] = {}
    rows_by_level: dict[int, list] = {}
    for row in live:
        # child slots this table does not define impose no ordering
        deps = [level_of.get(int(c) - n_tips, -1)
                for c in (row[1], row[3]) if int(c) >= n_tips]
        lvl = (max(deps) + 1) if deps else 0
        level_of[int(row[0])] = lvl
        rows_by_level.setdefault(lvl, []).append(row)
    n_slots = int(live[:, 0].max()) + 2
    rows8, e1s, e2s = [], [], []
    for li, lvl in enumerate(sorted(rows_by_level)):
        arr = np.stack(rows_by_level[lvl]).astype(np.int64)
        c1, c2 = arr[:, 1], arr[:, 3]
        it1 = (c1 < n_tips).astype(np.int64)
        it2 = (c2 < n_tips).astype(np.int64)
        fence = np.zeros(arr.shape[0], np.int64)
        if li > 0:
            fence[0] = 1
        rows8.append(np.stack([
            np.where(it1 == 1, 0, c1 - n_tips),
            np.where(it2 == 1, 0, c2 - n_tips),
            it1, it2,
            np.where(it1 == 1, c1, 0), np.where(it2 == 1, c2, 0),
            arr[:, 0], fence,
        ], axis=1))
        e1s.append(arr[:, 2])
        e2s.append(arr[:, 4])
    return (np.concatenate(rows8).astype(np.int32), np.concatenate(e1s),
            np.concatenate(e2s), n_slots)


def compile_fused(partition, tree, root_edge=None, fuse_root: bool = False):
    """Compile a tree into the fused kernel's tables (on the partition's
    device): (idx8 int32 [nW, 8], e1, e2 int64 [nW], root_info, n_slots).

    ``fuse_root=True`` appends the ROOT PSEUDO-NODE row: children (u, v),
    matrices (diag(freqs_per_cat), P_root), out = the scratch slot
    ``n_slots - 1``; the kernel's ordinary row then leaves the root-edge
    per-category site product (f ⊙ clv_u)·(P_root clv_v) and the total
    scaler there, and root_info is (u, v, e, root_slot)."""
    ops, root_info = tree.traversal_ops(root_edge)
    idx8, e1, e2, n_slots = compile_fused_ops(partition, ops)
    u, v, e = (int(x) for x in root_info)
    info = (u, v, e)
    if fuse_root:
        n_tips = partition.n_tips

        def enc(ref):
            return (0, 1, ref) if ref < n_tips else (ref - n_tips, 0, 0)

        s_u, it_u, t_u = enc(u)
        s_v, it_v, t_v = enc(v)
        root_slot = n_slots - 1                  # the scratch slot
        idx8 = np.concatenate([idx8, np.asarray(
            [[s_u, s_v, it_u, it_v, t_u, t_v, root_slot, 1]], np.int32)])
        e1 = np.append(e1, 0)
        e2 = np.append(e2, e)
        info = (u, v, e, root_slot)
    dev = partition.device
    return (torch.as_tensor(idx8, dtype=torch.int32, device=dev),
            torch.as_tensor(e1, dtype=torch.int64, device=dev),
            torch.as_tensor(e2, dtype=torch.int64, device=dev),
            info, n_slots)


def _root_pair(partition, P_root):
    """[2, C, S, S] matrices of the root pseudo-node row:
    (diag(freqs_per_cat), P_root) — the row then emits
    (f ⊙ clv_u)·(P_root clv_v), the root-edge site product."""
    fdiag = torch.diag_embed(partition.freqs_per_cat()).to(P_root.dtype)
    return torch.stack([fdiag, P_root]).to(torch.float32)


def pair_pmats(partition, brlens, e1, e2):
    """The kernels' per-row matrices [nW, 2, C, S, S] float32:
    (P(t_{e1[w]}), P(t_{e2[w]})) for every row, the last row being the
    root pseudo-node (:func:`_root_pair` with P_root = P(t_{e2[-1]})).
    One batched P build over the 2·nW gathered branch lengths (the
    counterpart of pallas_clv.fused_p12)."""
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    t = brlens[torch.stack([e1, e2], dim=1)]                    # [nW, 2]
    P = partition.prob_matrices(t.reshape(-1))
    P5 = P.reshape(t.shape[0], 2, *P.shape[1:]).to(torch.float32)
    P5[-1] = _root_pair(partition, P5[-1, 1])
    return P5.contiguous()


def code_table(partition):
    """[n_codes, S] float32 code → tip-CLV table the kernels read."""
    return partition.code_clv.to(torch.float32).contiguous()


def fused_walk(idx8, P5, tip_codes, codetab, n_slots: int):
    """Run a fused op table: (clvs [n_slots, C·S, Ppad] float32, scalers
    [n_slots, 1, Ppad] int32). Slots no row writes are left unset.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    global LAUNCHES
    if P5.device.type == "cpu":
        return fused_walk_plain(idx8, P5, tip_codes, codetab, n_slots)
    _, _, C, S, _ = P5.shape
    Ppad = tip_codes.shape[1]
    clvs = torch.empty((n_slots, C * S, Ppad), dtype=torch.float32,
                       device=P5.device)
    scalers = torch.empty((n_slots, 1, Ppad), dtype=torch.int32,
                          device=P5.device)
    _build.launch_walk("pllmod_fused_walk", idx8, P5, tip_codes, codetab,
                       clvs, scalers, n_slots)
    LAUNCHES += 1
    return clvs, scalers


def fused_walk_plain(idx8, P5, tip_codes, codetab, n_slots: int):
    """Plain torch version of the fused kernel: the same row walk and
    arithmetic (:func:`pllmod_tpu_torch.ops.clv.walk_rows_plain`), every
    slot kept (unwritten slots are zero)."""
    return clv_mod.walk_rows_plain(idx8, P5, tip_codes, codetab, n_slots)


def root_from_prod_slot(partition, clvs, scalers, root_slot: int):
    """Edge-logL epilogue of the fused-root path: ``root_slot`` holds the
    rescaled per-category site product and its scaler row the TOTAL
    exponent."""
    C, S = partition.n_cats, partition.states
    prod = clvs[root_slot].to(partition.dtype)
    per_cat = prod.reshape(C, S, -1).sum(dim=1)                  # [C, P]
    lnl = lk_mod._site_lnl(partition, per_cat.T, scalers[root_slot, 0])
    return torch.sum(lnl * partition.pattern_weights)


def loglikelihood_fused(partition, idx8, brlens, e1, e2, root_info,
                        n_slots: int):
    """Full-tree logL through the fused kernel; the table must come from
    :func:`compile_fused` with ``fuse_root=True``."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the fused kernel runs float32 partitions only "
                          f"(got {partition.dtype}); use schedule='scan'")
    if len(root_info) != 4:
        raise ValueError("loglikelihood_fused needs a fuse_root table")
    P5 = pair_pmats(partition, brlens, e1, e2)
    clvs, scalers = fused_walk(idx8, P5, partition.tip_states,
                               code_table(partition), n_slots)
    return root_from_prod_slot(partition, clvs, scalers, root_info[3])
