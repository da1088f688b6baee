"""Whole-traversal pruning with every CLV in device memory — the
counterpart of the evaluation part of ``pllmod_tpu.ops.pallas_clv``
(the fused megakernel, ``_make_fused_kernel``).

:func:`fused_walk` runs an idx8 op table (slot1, slot2, is_tip1,
is_tip2, tip1, tip2, out_slot, level fence) through the CUDA entry point
``pllmod_fused_walk`` (``csrc/fused.cu``: a pre-pass that builds each
row's transposed matrices and tip tables, then one walk launch) and
returns every
CLV ``[n_slots, C·S, Ppad]`` float32 with its cumulative scaler row
``[n_slots, 1, Ppad]`` int32. The branch-length optimization (directed
tables, and the bounded sweep's serial slot-recycled tables) builds on
these buffers, as SPR scoring and incremental evaluation will. The
kernel needs no level fences: a CTA walks its own pattern columns in
row order, so serial and slot-recycled tables run as they are
(``csrc/fused.cu``'s header says why, and how a child that the row
before writes is forwarded through shared memory,
:func:`forwarded_children`); the tables keep the column for layout
parity with the JAX package. The JAX kernel's ``init=`` aliasing is ``fused_walk(out=
(clvs, scalers))`` here: the wrapper passes the prior buffers to the
kernel as its outputs, so the slots the table does not write keep
their values.

On a CPU tensor the wrapper runs :func:`fused_walk_plain`, the same
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


def compile_fused_ops(partition, ops, pad_to: int | None = None,
                      n_slots_min: int | None = None, serial: bool = False):
    """Compile a pruning-op list for the fused kernel, PRESERVING the op
    table's slot numbering (pallas_clv.compile_fused_ops).

    Default (level mode): rows are emitted in dependency-level order;
    column 7 flags the first row of each level after the first. Child
    slots the table does not define are taken as already valid in the
    buffer the walk writes into (``fused_walk(out=...)``) and impose no
    order. ``serial=True`` keeps the ORIGINAL row order, as a
    slot-recycled table (``clv.bounded_slot_ops``, the bounded BLO
    schedule) needs; column 7 then flags rows that read a slot written
    one or two rows before (the JAX package's fence column, kept for
    table parity; the CUDA kernel needs no fences). ``pad_to`` appends
    dummy tip/tip rows writing the scratch slot up to that many rows;
    ``n_slots_min`` fixes the buffer size from below.

    Returns (idx8 [rows, 8], e1, e2, n_slots) as int numpy arrays, with
    n_slots = max_slot + 2 (the last slot is scratch) or n_slots_min.
    """
    ops = np.asarray(ops)
    n_tips = partition.n_tips
    live = ops[ops[:, 0] >= 0]
    if live.size == 0:
        raise ValueError("no live ops")
    if serial:
        arr = live.astype(np.int64)
        fence = np.zeros(len(arr), np.int64)
        for w in range(len(arr)):
            for c in (arr[w, 1], arr[w, 3]):
                if c >= n_tips and (c - n_tips) in arr[max(w - 2, 0):w, 0]:
                    fence[w] = 1
        groups = [(arr, fence)]
    else:
        level_of: dict[int, int] = {}
        rows_by_level: dict[int, list] = {}
        for row in live:
            # child slots this table does not define impose no ordering
            deps = [level_of.get(int(c) - n_tips, -1)
                    for c in (row[1], row[3]) if int(c) >= n_tips]
            lvl = (max(deps) + 1) if deps else 0
            level_of[int(row[0])] = lvl
            rows_by_level.setdefault(lvl, []).append(row)
        groups = []
        for li, lvl in enumerate(sorted(rows_by_level)):
            arr = np.stack(rows_by_level[lvl]).astype(np.int64)
            fence = np.zeros(arr.shape[0], np.int64)
            if li > 0:
                fence[0] = 1
            groups.append((arr, fence))
    n_slots = int(live[:, 0].max()) + 2
    if n_slots_min is not None:
        n_slots = max(n_slots, n_slots_min)
    rows8, e1s, e2s = [], [], []
    for arr, fence in groups:
        c1, c2 = arr[:, 1], arr[:, 3]
        it1 = (c1 < n_tips).astype(np.int64)
        it2 = (c2 < n_tips).astype(np.int64)
        rows8.append(np.stack([
            np.where(it1 == 1, 0, c1 - n_tips),
            np.where(it2 == 1, 0, c2 - n_tips),
            it1, it2,
            np.where(it1 == 1, c1, 0), np.where(it2 == 1, c2, 0),
            arr[:, 0], fence,
        ], axis=1))
        e1s.append(arr[:, 2])
        e2s.append(arr[:, 4])
    idx8 = np.concatenate(rows8)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    if pad_to is not None and pad_to > idx8.shape[0]:
        npad = pad_to - idx8.shape[0]
        dummy = np.zeros((npad, 8), np.int64)
        dummy[:, 2] = dummy[:, 3] = 1            # tip/tip children
        dummy[:, 6] = n_slots - 1                # scratch slot
        idx8 = np.concatenate([idx8, dummy])
        e1 = np.concatenate([e1, np.zeros(npad, np.int64)])
        e2 = np.concatenate([e2, np.zeros(npad, np.int64)])
    return idx8.astype(np.int32), e1, e2, n_slots


def append_root_row(idx8, e1, e2, n_tips: int, u: int, v: int, e: int,
                    n_slots: int):
    """Append the ROOT PSEUDO-NODE row to a numpy table: children
    (u, v), matrices (diag(freqs_per_cat), P(t_e)) through
    ``pair_pmats(root_row=True)``, out = the scratch slot
    ``n_slots - 1``. Returns (idx8, e1, e2, root_slot)."""
    def enc(ref):
        return (0, 1, ref) if ref < n_tips else (ref - n_tips, 0, 0)

    s_u, it_u, t_u = enc(u)
    s_v, it_v, t_v = enc(v)
    root_slot = n_slots - 1
    idx8 = np.concatenate([idx8, np.asarray(
        [[s_u, s_v, it_u, it_v, t_u, t_v, root_slot, 1]], np.int32)])
    return idx8, np.append(e1, 0), np.append(e2, e), root_slot


def compile_fused(partition, tree, root_edge=None, fuse_root: bool = False):
    """Compile a tree into the fused kernel's tables (on the partition's
    device): (idx8 int32 [nW, 8], e1, e2 int64 [nW], root_info, n_slots).

    ``fuse_root=True`` appends the ROOT PSEUDO-NODE row: children (u, v),
    matrices (diag(freqs_per_cat), P_root), out = the scratch slot
    ``n_slots - 1``; the kernel's ordinary row then leaves the root-edge
    per-category site product (f ⊙ clv_u)·(P_root clv_v) and the total
    scaler there, and root_info is (u, v, e, root_slot). Its matrices
    come from ``pair_pmats(root_row=True)``; a table without the row
    takes ``root_row=False``."""
    ops, root_info = tree.traversal_ops(root_edge)
    idx8, e1, e2, n_slots = compile_fused_ops(partition, ops)
    u, v, e = (int(x) for x in root_info)
    info = (u, v, e)
    if fuse_root:
        idx8, e1, e2, root_slot = append_root_row(
            idx8, e1, e2, partition.n_tips, u, v, e, n_slots)
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


def pair_pmats(partition, brlens, e1, e2, *, root_row: bool):
    """The kernels' per-row matrices [nW, 2, C, S, S] float32:
    (P(t_{e1[w]}), P(t_{e2[w]})) for every row. ``root_row=True`` (the
    tables of ``compile_fused(fuse_root=True)`` and
    ``resident.compile_resident``): the last row is the root pseudo-node
    (:func:`_root_pair` with P_root = P(t_{e2[-1]})); directed and
    bounded tables have no such row and pass ``root_row=False``. One
    batched P build over the 2·nW gathered branch lengths (the
    counterpart of pallas_clv.fused_p12)."""
    brlens = torch.as_tensor(brlens).to(partition.device, partition.dtype)
    t = brlens[torch.stack([e1, e2], dim=1)]                    # [nW, 2]
    P = partition.prob_matrices(t.reshape(-1))
    P5 = P.reshape(t.shape[0], 2, *P.shape[1:]).to(torch.float32)
    if root_row:
        P5[-1] = _root_pair(partition, P5[-1, 1])
    return P5.contiguous()


def gather_pairs(P, e1, e2):
    """The rows' matrices [nW, 2, C, S, S] float32, (P[e1[w]], P[e2[w]]),
    from the P-matrices ``P`` [E, C, S, S] of every edge, for a table
    without a root row (the caller already holds P, e.g. a gradient's
    forward)."""
    return P[torch.stack([e1, e2], dim=1)].to(torch.float32).contiguous()


def code_table(partition):
    """[n_codes, S] float32 code → tip-CLV table the kernels read."""
    return partition.code_clv.to(torch.float32).contiguous()


def fused_walk(idx8, P5, tip_codes, codetab, n_slots: int, out=None,
               tile: int | None = None):
    """Run a fused op table: (clvs [n_slots, C·S, Ppad] float32, scalers
    [n_slots, 1, Ppad] int32). Without ``out`` the slots no row writes
    are left unset; ``out=(clvs, scalers)`` (prior buffers of those
    shapes) is written in place, so the slots the table does not write
    keep their values — the ``init=`` aliasing of
    ``pallas_clv.update_partials_fused``. CUDA tensors launch the
    kernel (at pattern tile ``tile``, by default ``_build.fused_tile``'s);
    CPU tensors run the plain version."""
    if P5.device.type == "cpu":
        return fused_walk_plain(idx8, P5, tip_codes, codetab, n_slots, out)
    _, _, C, S, _ = P5.shape
    Ppad = tip_codes.shape[1]
    if out is None:
        clvs = torch.empty((n_slots, C * S, Ppad), dtype=torch.float32,
                           device=P5.device)
        scalers = torch.empty((n_slots, 1, Ppad), dtype=torch.int32,
                              device=P5.device)
    else:
        clvs, scalers = out
        if (tuple(clvs.shape) != (n_slots, C * S, Ppad)
                or tuple(scalers.shape) != (n_slots, 1, Ppad)):
            raise ValueError("fused_walk: out buffers must be "
                             f"[{n_slots}, {C * S}, {Ppad}] and "
                             f"[{n_slots}, 1, {Ppad}]")
    _build.launch_walk("pllmod_fused_walk", idx8, P5, tip_codes, codetab,
                       clvs, scalers, n_slots, tile)
    return clvs, scalers


def fused_walk_plain(idx8, P5, tip_codes, codetab, n_slots: int,
                     out=None):
    """Plain torch version of the fused kernel: the same row walk and
    arithmetic (:func:`pllmod_tpu_torch.ops.clv.walk_rows_plain`);
    unwritten slots are zero, or keep their values in ``out``."""
    return clv_mod.walk_rows_plain(idx8, P5, tip_codes, codetab, n_slots,
                                   out)


def tip_tables_plain(P, codetab):
    """Tip tables PT [..., C, n_codes, S] of matrices P [..., C, S, S]:
    PT[..., c, code, i] = Σ_j P[..., c, i, j] · codetab[code, j], summed
    in j order with separately rounded products and sums
    (:func:`~pllmod_tpu_torch.ops.clv.apply_pmat` on the code table), so
    a lookup gives the bits of the per-pattern product on the expanded
    tip."""
    S = codetab.shape[1]
    x = codetab.T.to(P.dtype).expand(*P.shape[:-2], S, codetab.shape[0])
    return clv_mod.apply_pmat(P, x).transpose(-1, -2)


def tip_lookup_plain(PT, codes):
    """A tip child's [C, S, Ppad] values from its table PT [C, n_codes, S]
    and its codes [Ppad] (clamped to the table, as the kernels do)."""
    idx = codes.long().clamp(0, PT.shape[-2] - 1)
    return PT[:, idx, :].transpose(-1, -2)


def walk_tables_plain(idx8, P5, codetab, T: int):
    """Plain torch version of the fused walk's pre-pass at pattern tile T:
    [nW, 2, Q] float32, each row side's matrices transposed and padded,
    M[c, j, i] = P[c, i, j] (0 for i ≥ S), or for a tip child its table
    :func:`tip_tables_plain` padded the same way, [C, n_codes, SP]; the
    rest of the Q floats zero (``_build.fused_config`` gives SP and Q)."""
    nW, _, C, S, _ = P5.shape
    n_codes = codetab.shape[0]
    cf = _build.fused_config(C, S, n_codes, T)
    SP, Q = cf["SP"], cf["Q"]
    mats = torch.zeros((nW, 2, Q), dtype=torch.float32, device=P5.device)
    pad = torch.zeros((nW, 2, C, max(S, n_codes), SP), dtype=torch.float32,
                      device=P5.device)
    tip = torch.as_tensor(idx8[:, 2:4] != 0, device=P5.device)
    mt = pad.clone()
    mt[..., :S, :S] = P5.transpose(-1, -2)
    pad[..., :n_codes, :S] = tip_tables_plain(P5, codetab)
    n_mat, n_tab = C * S * SP, C * n_codes * SP
    mats[..., :n_mat] = mt[..., :S, :].reshape(nW, 2, n_mat)
    mats[tip, :n_tab] = pad[..., :n_codes, :].reshape(nW, 2, n_tab)[tip]
    mats[tip, n_tab:] = 0
    return mats


def walk_tables(idx8, P5, codetab, T: int):
    """The fused walk's pre-pass alone (``pllmod_fused_tables``; the walk
    launches it itself): [nW, 2, Q] float32 at pattern tile T. CUDA
    tensors launch the kernel; CPU tensors run
    :func:`walk_tables_plain`."""
    if P5.device.type == "cpu":
        return walk_tables_plain(idx8, P5, codetab, T)
    nW, _, C, S, _ = P5.shape
    n_codes = codetab.shape[0]
    _build.check_tensors("pllmod_fused_tables", [
        (idx8, torch.int32, (nW, 8)), (P5, torch.float32, (nW, 2, C, S, S)),
        (codetab, torch.float32, (n_codes, S))])
    cf = _build.fused_config(C, S, n_codes, T)
    if cf is None:
        raise ValueError(f"pllmod_fused_tables: no configuration at tile {T}")
    mats = torch.zeros((nW, 2, cf["Q"]), dtype=torch.float32,
                       device=P5.device)
    _build.launch("pllmod_fused_tables", P5.device, idx8.data_ptr(), nW,
                  P5.data_ptr(), codetab.data_ptr(), n_codes,
                  mats.data_ptr(), C, S, T)
    return mats


def forwarded_children(idx8, n_slots: int, depth: int, lookback: int = 1):
    """bool [nW, 2]: the children the fused walk takes from an earlier
    row's output on the chip instead of device memory — an inner child
    whose (clamped) slot is the out slot of one of the ``lookback`` rows
    before, on a side fetched before that row ends (side < depth).
    ``_build.fused_config`` gives both: the thread walk fetches both
    children two rows ahead (depth 2, lookback 2), the tile walk the
    first NB − 1 children of the next row (lookback 1). The kernel
    computes the same from the table as it walks."""
    rows = torch.as_tensor(idx8).cpu().long()
    slots = rows[:, [0, 1, 6]].clamp(0, n_slots - 1)
    fwd = torch.zeros((rows.shape[0], 2), dtype=torch.bool)
    for back in range(1, lookback + 1):
        fwd[back:] |= ((rows[back:, 2:4] == 0)
                       & (slots[back:, :2] == slots[:-back, 2:3]))
    fwd[:, depth:] = False
    return fwd


def root_from_prod_slot(partition, clvs, scalers, root_slot: int,
                        persite: bool = False):
    """Edge-logL epilogue of the fused-root path: ``root_slot`` holds the
    rescaled per-category site product and its scaler row the TOTAL
    exponent. ``persite=True`` returns (total, per-pattern logL)."""
    C, S = partition.n_cats, partition.states
    prod = clvs[root_slot].to(partition.dtype)
    per_cat = prod.reshape(C, S, -1).sum(dim=1)                  # [C, P]
    lnl = lk_mod._site_lnl(partition, per_cat.T, scalers[root_slot, 0])
    return lk_mod.weighted_total(partition, lnl, persite)


def loglikelihood_fused(partition, idx8, brlens, e1, e2, root_info,
                        n_slots: int, persite: bool = False):
    """Full-tree logL through the fused kernel; the table must come from
    :func:`compile_fused` with ``fuse_root=True``. ``persite=True``
    returns (total, per-pattern logL). The spans ``pllmod.eval.pmats``,
    ``.walk`` and ``.root``."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the fused kernel runs float32 partitions only "
                          f"(got {partition.dtype}); use schedule='scan'")
    if len(root_info) != 4:
        raise ValueError("loglikelihood_fused needs a fuse_root table")
    with profile.span("pllmod.eval.pmats"):
        P5 = pair_pmats(partition, brlens, e1, e2, root_row=True)
    with profile.span("pllmod.eval.walk"):
        clvs, scalers = fused_walk(idx8, P5, partition.tip_states,
                                   code_table(partition), n_slots)
    with profile.span("pllmod.eval.root"):
        return root_from_prod_slot(partition, clvs, scalers, root_info[3],
                                   persite)
