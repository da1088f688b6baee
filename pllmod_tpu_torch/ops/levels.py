"""Per-level pruning kernels — the counterpart of the per-level half of
``pllmod_tpu.ops.pallas_clv`` (``_child_pass``, ``_child2_pass``,
``level_update``, ``level_update_combined``, ``update_partials_pallas``,
``root_loglikelihood_csp``, ``loglikelihood_pallas``).

Layout, as in the JAX package: CLVs ``[n_slots, C·S, Ppad]`` float32 and
scalers ``[n_slots, 1, Ppad]`` int32; level ``l`` of a
:class:`~pllmod_tpu_torch.ops.clv.LevelSchedule` writes the contiguous
slots ``[offset_l, offset_l + W_l)``. A level's rows are
:func:`level_idx` rows (slot1, slot2, is_tip1, is_tip2, tip1, tip2); its
matrices are per child, ``[W, C, S, S]`` float32 (the JAX kernels'
block-diagonal ``[C·S, C·S]`` forms only feed the TPU's matrix unit).

Three CUDA kernels (``csrc/levels.cu``), each with its wrapper, its plain
torch version, each launch counted in ``profile.LAUNCHES`` under its
entry point's name:

- :func:`child_pass` (kernel 3, ``pllmod_child_pass``): ``P·child`` for
  one child (side 0 or 1) of every row of a level, ``[W, C·S, Ppad]``,
  with the child's scaler row (0 for tips); its pattern tile follows the
  level's width (``_build.child_tile``);
- :func:`child2_pass` (kernel 4, ``pllmod_child2_pass``): the second
  child times its matrix, times ``left``, the exact power-of-two rescale
  (bit formula) and the cumulative scaler, written into the level's
  slots;
- :func:`level_update_combined` (kernel 5, ``pllmod_level_combined``):
  both children, product and rescale in one launch, written into the
  level's slots.

Kernels 4 and 5 take their pattern tile from the level's width as well
(``_build.level_tile``: the tiled kernel, every category of a row's tile
in one CTA after a pre-pass of each row side's table, or the simple
kernel where that fits no tile); each wrapper takes ``tile=`` to force
one (``_build.level_config`` says what a tile gives). All three take a
ragged last tile.

The last two write in place into the buffers they are given (the JAX
functions return updated copies; ``dynamic_update_slice`` and the
combined kernel's full-buffer copy have no counterpart): a level's
children live in earlier levels, so no launch reads a slot it writes.
:func:`level_update` runs :func:`child_pass` for both children and
combines in torch with the unclipped frexp rescale, as
``pallas_clv.level_update`` does. On a CPU tensor a wrapper runs its
plain version (the kernel's arithmetic: products and sums rounded
separately in state order); on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import ERROR_UNSUPPORTED, PllModError
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops.fused import code_table

# the per-level step of update_partials_pallas: kernel 3 then kernel 4
# (the JAX driver), level_update (kernel 3 twice + torch combine), or
# level_update_combined (kernel 5)
STEPS = ("child2", "split", "combined")


# ---------------------------------------------------------------------------
# layout converters and level tables
# ---------------------------------------------------------------------------
def csp_from_standard(clvs):
    """[slots, P, C, S] -> [slots, C·S, P]."""
    n, P, C, S = clvs.shape
    return clvs.permute(0, 2, 3, 1).reshape(n, C * S, P)


def csp_to_standard(clvs_csp, C: int, S: int):
    """[slots, C·S, P] -> [slots, P, C, S]."""
    n, _, P = clvs_csp.shape
    return clvs_csp.reshape(n, C, S, P).permute(0, 3, 1, 2)


def level_idx(partition, ops_lvl):
    """int32 numpy [W, 6] rows (slot1, slot2, is_tip1, is_tip2, tip1,
    tip2) of one level's op rows, the slot and tip columns clamped to 0
    where they do not apply (``pallas_clv._level_idx``)."""
    ops_lvl = np.asarray(ops_lvl)
    n_tips = partition.n_tips
    c1, c2 = ops_lvl[:, 1], ops_lvl[:, 3]
    t1, t2 = c1 < n_tips, c2 < n_tips
    return np.stack([np.where(t1, 0, c1 - n_tips),
                     np.where(t2, 0, c2 - n_tips), t1, t2,
                     np.where(t1, c1, 0), np.where(t2, c2, 0)],
                    axis=1).astype(np.int32)


def level_tables(partition, levels):
    """(idx int32 [n_slots, 6], e1, e2 int64 [n_slots]) on the partition's
    device: the :func:`level_idx` rows and child edges of every level,
    concatenated in level order. A LevelSchedule numbers its slots level
    by level, so level ``l``'s rows are ``idx[offset_l:offset_l + W_l]``
    (contiguous slices, as the kernels take them). Built once a
    topology."""
    ops = np.concatenate([np.asarray(lv) for lv in levels])
    if not np.array_equal(ops[:, 0], np.arange(len(ops))):
        raise ValueError("level_tables: levels must come from a "
                         "LevelSchedule (slots numbered level by level)")
    idx = np.concatenate([level_idx(partition, lv) for lv in levels])
    dev = partition.device
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(ops[:, 2], dtype=torch.int64, device=dev),
            torch.as_tensor(ops[:, 4], dtype=torch.int64, device=dev))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def gather_children(idx, side: int, clvs, scalers, tip_codes, codetab,
                    C: int):
    """Side ``side``'s child of every row: ([W, C, S, Ppad] float32 — tips
    expanded from their codes through the code table — and [W, Ppad]
    int32 scalers, 0 for tips). The plain versions' gather, also the
    input of ``chip_smoke.py``'s library yardstick for kernel 3."""
    W, S, Ppad = idx.shape[0], codetab.shape[1], tip_codes.shape[1]
    is_tip = idx[:, 2 + side] != 0
    tips = codetab[tip_codes[idx[:, 4 + side].long()].long()]   # [W, Ppad, S]
    tips = tips.transpose(1, 2)[:, None].expand(W, C, S, Ppad)
    slot = idx[:, side].long()
    x = torch.where(is_tip[:, None, None, None], tips,
                    clvs[slot].view(W, C, S, Ppad))
    sc = torch.where(is_tip[:, None], 0, scalers[slot, 0])
    return x, sc


def child_pass_plain(idx, side: int, clvs, scalers, tip_codes, codetab, P):
    """Plain torch version of :func:`child_pass`."""
    W, C = idx.shape[0], P.shape[1]
    x, sc = gather_children(idx, side, clvs, scalers, tip_codes, codetab, C)
    return clv_mod.apply_pmat(P, x).reshape(W, -1, x.shape[-1]), sc[:, None]


def _write_level(clvs, scalers, offset: int, prod, sc):
    """Rescale a level's products [W, C, S, Ppad] (bit formula) and store
    them with their cumulative scalers in slots [offset, offset + W)."""
    W = prod.shape[0]
    scaled, e = clv_mod.rescale_bits(prod)
    clvs[offset:offset + W] = scaled.reshape(W, -1, prod.shape[-1])
    scalers[offset:offset + W, 0] = sc + e
    return clvs, scalers


def child2_pass_plain(idx, clvs, scalers, tip_codes, codetab, P, left, s1,
                      offset: int):
    """Plain torch version of :func:`child2_pass`."""
    W, C = idx.shape[0], P.shape[1]
    x, s2 = gather_children(idx, 1, clvs, scalers, tip_codes, codetab, C)
    prod = left.view(x.shape) * clv_mod.apply_pmat(P, x)
    return _write_level(clvs, scalers, offset, prod, s1[:, 0] + s2)


def level_combined_plain(idx, clvs, scalers, tip_codes, codetab, P1, P2,
                         offset: int):
    """Plain torch version of :func:`level_update_combined`."""
    C = P1.shape[1]
    x1, s1 = gather_children(idx, 0, clvs, scalers, tip_codes, codetab, C)
    x2, s2 = gather_children(idx, 1, clvs, scalers, tip_codes, codetab, C)
    prod = clv_mod.apply_pmat(P1, x1) * clv_mod.apply_pmat(P2, x2)
    return _write_level(clvs, scalers, offset, prod, s1 + s2)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _check(name, idx, clvs, scalers, tip_codes, codetab, mats, extra=()):
    """Check a level kernel's inputs (CUDA tensors of the kernel's types
    and shapes, at most MAX_STATES states and 65535 rows); returns (W,
    n_slots, Ppad, C, S)."""
    W = idx.shape[0]
    n_slots, _, Ppad = clvs.shape
    _, C, S, _ = mats[0].shape
    _build.check_tensors(name, [
        (clvs, torch.float32, (n_slots, C * S, Ppad)),
        (idx, torch.int32, (W, 6)),
        (scalers, torch.int32, (n_slots, 1, Ppad)),
        (tip_codes, torch.int32, (tip_codes.shape[0], Ppad)),
        (codetab, torch.float32, (codetab.shape[0], S)),
        *[(m, torch.float32, (W, C, S, S)) for m in mats], *extra])
    if S > _build.MAX_STATES:
        raise ValueError(f"{name}: at most {_build.MAX_STATES} states, "
                         f"got {S}")
    if W > 65535:
        raise ValueError(f"{name}: at most 65535 rows, got {W}")
    return W, n_slots, Ppad, C, S


def _check_offset(name, offset: int, W: int, n_slots: int) -> None:
    if offset < 0 or offset + W > n_slots:
        raise ValueError(f"{name}: slots [{offset}, {offset + W}) outside "
                         f"the buffer's {n_slots}")


def child_pass(idx, side: int, clvs, scalers, tip_codes, codetab, P,
               tile: int | None = None):
    """``P[w]·child`` for child ``side`` (0 or 1) of every row of a level
    (``pallas_clv._child_pass``), on the card at pattern tile ``tile``
    (by default ``_build.child_tile``'s for the level's width).

    Args:
      idx: int32 [W, 6] :func:`level_idx` rows
      clvs: float32 [n_slots, C·S, Ppad]; scalers: int32 [n_slots, 1,
        Ppad] (the children's slots)
      tip_codes: int32 [n_tips, Ppad]; codetab: float32 [n_codes, S]
      P: float32 [W, C, S, S] the side's matrix of each row
    Returns:
      (float32 [W, C·S, Ppad], int32 [W, 1, Ppad] the child's scaler row)
    """
    if side not in (0, 1):
        raise ValueError(f"child_pass: side must be 0 or 1, got {side}")
    if clvs.device.type == "cpu":
        return child_pass_plain(idx, side, clvs, scalers, tip_codes, codetab,
                                P)
    W, n_slots, Ppad, C, S = _check("pllmod_child_pass", idx, clvs,
                                    scalers, tip_codes, codetab, [P])
    n_codes = codetab.shape[0]
    T = _build.child_tile(C, S, n_codes, Ppad, W) if tile is None else tile
    if _build.child_config(C, S, n_codes, T) is None:
        raise ValueError(f"pllmod_child_pass: no launch configuration at "
                         f"tile {T}")
    out = torch.empty((W, C * S, Ppad), dtype=torch.float32,
                      device=clvs.device)
    sc = torch.empty((W, 1, Ppad), dtype=torch.int32, device=clvs.device)
    if W:
        _build.launch("pllmod_child_pass", clvs.device, idx.data_ptr(), W,
                      side, P.data_ptr(), clvs.data_ptr(), scalers.data_ptr(),
                      n_slots, tip_codes.data_ptr(), tip_codes.shape[0],
                      codetab.data_ptr(), codetab.shape[0], out.data_ptr(),
                      sc.data_ptr(), Ppad, C, S, T)
    return out, sc


def level_scratch_floats(mode: str, C: int, S: int, n_codes: int,
                         Ppad: int, W: int, tile: int | None = None) -> int:
    """Floats of the scratch that kernel 4's (``mode`` "child2") or 5's
    ("combined") pre-pass fills for a level of W rows at pattern tile
    ``tile`` (by default the rule's, ``_build.level_tile``): W·sides·Q,
    0 where the simple kernel runs."""
    T = (_build.level_tile(mode, C, S, n_codes, Ppad, max(W, 1))
         if tile is None else tile)
    cf = _build.level_config(mode, C, S, n_codes, T)
    return W * (_build.LEVEL_MODES.index(mode) + 1) * cf["Q"] if cf else 0


def _level_launch(name, mode: str, C: int, S: int, n_codes: int, Ppad: int,
                  W: int, tile, device, scratch):
    """Kernel 4's or 5's pattern tile (``tile``, or the rule's,
    ``_build.level_tile``, for a level of W rows) and the scratch of its
    pre-pass: ``scratch`` where given (checked), else a new one (None
    where the simple kernel runs); raises where the kernel takes no
    configuration at that tile."""
    T = (_build.level_tile(mode, C, S, n_codes, Ppad, max(W, 1))
         if tile is None else tile)
    cf = _build.level_config(mode, C, S, n_codes, T)
    if cf is None:
        raise ValueError(f"{name}: no launch configuration at tile {T}")
    n = W * (_build.LEVEL_MODES.index(mode) + 1) * cf["Q"]
    if not n:
        return T, None
    if scratch is None:
        return T, torch.empty(n, dtype=torch.float32, device=device)
    if (scratch.dtype != torch.float32 or scratch.device != device
            or not scratch.is_contiguous() or scratch.numel() < n):
        raise ValueError(f"{name}: the scratch must be a contiguous float32 "
                         f"tensor of at least {n} floats on {device}")
    return T, scratch


def child2_pass(idx, clvs, scalers, tip_codes, codetab, P, left, s1,
                offset: int, tile: int | None = None, scratch=None):
    """Second-child pass fused with the combine (``pallas_clv.
    _child2_pass``): ``left ⊙ (P[w]·child2)``, rescaled by the bit
    formula, with the cumulative scaler ``s1 + s2 + e``, written into
    slots ``[offset, offset + W)`` of ``clvs`` / ``scalers`` (in place;
    returned), on the card at pattern tile ``tile`` (by default
    ``_build.level_tile``'s for the level's width). ``left`` float32 [W,
    C·S, Ppad] and ``s1`` int32 [W, 1, Ppad] are :func:`child_pass`'s
    side-0 outputs; the other arguments as there, ``P`` the side-1
    matrices. ``scratch``: a float32 tensor on the card of at least
    :func:`level_scratch_floats` floats for the pre-pass's tables (by
    default one is allocated)."""
    if clvs.device.type == "cpu":
        return child2_pass_plain(idx, clvs, scalers, tip_codes, codetab, P,
                                 left, s1, offset)
    W, n_slots, Ppad, C, S = _check(
        "pllmod_child2_pass", idx, clvs, scalers, tip_codes, codetab, [P],
        [(left, torch.float32, (idx.shape[0], clvs.shape[1], clvs.shape[2])),
         (s1, torch.int32, (idx.shape[0], 1, clvs.shape[2]))])
    _check_offset("pllmod_child2_pass", offset, W, n_slots)
    T, mats = _level_launch("pllmod_child2_pass", "child2", C, S,
                            codetab.shape[0], Ppad, W, tile, clvs.device,
                            scratch)
    if W:
        _build.launch("pllmod_child2_pass", clvs.device, idx.data_ptr(), W,
                      P.data_ptr(), clvs.data_ptr(), scalers.data_ptr(),
                      n_slots, tip_codes.data_ptr(), tip_codes.shape[0],
                      codetab.data_ptr(), codetab.shape[0], left.data_ptr(),
                      s1.data_ptr(), offset, Ppad, C, S, T,
                      None if mats is None else mats.data_ptr())
    return clvs, scalers


def level_update_combined(clvs, scalers, idx, tip_codes, codetab, P1, P2,
                          offset: int, tile: int | None = None,
                          scratch=None):
    """One level in one launch (``pallas_clv.level_update_combined``):
    both children, their product, the bit-formula rescale and the
    cumulative scalers, written into slots ``[offset, offset + W)`` (in
    place; returned), on the card at pattern tile ``tile`` (by default
    ``_build.level_tile``'s for the level's width); ``scratch`` as in
    :func:`child2_pass`."""
    if clvs.device.type == "cpu":
        return level_combined_plain(idx, clvs, scalers, tip_codes, codetab,
                                    P1, P2, offset)
    W, n_slots, Ppad, C, S = _check("pllmod_level_combined", idx, clvs,
                                    scalers, tip_codes, codetab, [P1, P2])
    _check_offset("pllmod_level_combined", offset, W, n_slots)
    T, mats = _level_launch("pllmod_level_combined", "combined", C, S,
                            codetab.shape[0], Ppad, W, tile, clvs.device,
                            scratch)
    if W:
        _build.launch("pllmod_level_combined", clvs.device, idx.data_ptr(),
                      W, P1.data_ptr(), P2.data_ptr(), clvs.data_ptr(),
                      scalers.data_ptr(), n_slots, tip_codes.data_ptr(),
                      tip_codes.shape[0], codetab.data_ptr(),
                      codetab.shape[0], offset, Ppad, C, S, T,
                      None if mats is None else mats.data_ptr())
    return clvs, scalers


def level_update(clvs, scalers, idx, tip_codes, codetab, P1, P2,
                 offset: int):
    """One level as two :func:`child_pass` launches and a torch combine:
    the product, the frexp/ldexp rescale (unclipped, as
    pallas_clv.py:408-417) and the cumulative scalers, written into slots
    ``[offset, offset + W)`` (in place; returned)."""
    left, s1 = child_pass(idx, 0, clvs, scalers, tip_codes, codetab, P1)
    right, s2 = child_pass(idx, 1, clvs, scalers, tip_codes, codetab, P2)
    clv, e = clv_mod.rescale(left * right, (1,))
    W = idx.shape[0]
    clvs[offset:offset + W] = clv
    scalers[offset:offset + W] = s1 + s2 + e
    return clvs, scalers


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def update_partials_pallas(partition, P, levels, offsets, n_slots: int,
                           step: str = "child2", tables=None):
    """Full level-scheduled pruning on the per-level kernels.

    Args:
      P: [edges, C, S, S] transition matrices
      levels, offsets, n_slots: a LevelSchedule's (``engine.
        compile_schedule``)
      step: one of :data:`STEPS` — "child2" (kernel 3 then kernel 4 each
        level: ``pallas_clv.update_partials_pallas``), "split"
        (:func:`level_update`) or "combined" (:func:`level_update_combined`)
      tables: optional :func:`level_tables` of ``levels`` (built once a
        topology by ``engine.compile_fast_eval``)
    Returns:
      (clvs [n_slots, C·S, Ppad] float32, scalers [n_slots, 1, Ppad] int32)
    """
    if step not in STEPS:
        raise ValueError(f"unknown step {step!r}; one of {STEPS}")
    idx, e1, e2 = tables if tables is not None else level_tables(partition,
                                                                 levels)
    P = P.to(torch.float32)
    P1, P2 = P[e1], P[e2]                      # [n_slots, C, S, S] each
    dev = partition.device
    Ppad, CS = partition.n_patterns_padded, partition.n_cats * partition.states
    clvs = torch.empty((n_slots, CS, Ppad), dtype=torch.float32, device=dev)
    scalers = torch.empty((n_slots, 1, Ppad), dtype=torch.int32, device=dev)
    tip_codes, codetab = partition.tip_states, code_table(partition)
    scratch = None      # kernels 4 and 5's pre-pass tables, one an eval
    if dev.type == "cuda" and step != "split":
        n = max((level_scratch_floats(step, partition.n_cats,
                                      partition.states, codetab.shape[0],
                                      Ppad, len(lv)) for lv in levels),
                default=0)
        scratch = torch.empty(n, dtype=torch.float32, device=dev)
    for lv, off in zip(levels, offsets):
        s = slice(off, off + len(lv))
        if step == "child2":
            left, s1 = child_pass(idx[s], 0, clvs, scalers, tip_codes,
                                  codetab, P1[s])
            child2_pass(idx[s], clvs, scalers, tip_codes, codetab, P2[s],
                        left, s1, off, scratch=scratch)
        elif step == "split":
            level_update(clvs, scalers, idx[s], tip_codes, codetab, P1[s],
                         P2[s], off)
        else:
            level_update_combined(clvs, scalers, idx[s], tip_codes, codetab,
                                  P1[s], P2[s], off, scratch=scratch)
    return clvs, scalers


def root_loglikelihood_csp(partition, clvs_csp, scalers, ref_p: int,
                           ref_c: int, P_edge):
    """Edge logL from C·S×P CLVs (``pallas_clv.root_loglikelihood_csp``):
    refs < n_tips are tips (their CLV looked up through the code table),
    else ``n_tips + slot``; the sum runs in the partition's dtype."""
    n_tips, C, S = partition.n_tips, partition.n_cats, partition.states
    dtype = partition.dtype

    def fetch(ref):
        if ref < n_tips:
            t = partition.code_clv[partition.tip_states[ref].long()].T
            return (t.to(dtype).repeat(C, 1),
                    torch.zeros(t.shape[1], dtype=torch.int32,
                                device=t.device))
        return clvs_csp[ref - n_tips].to(dtype), scalers[ref - n_tips, 0]

    clv_p, s_p = fetch(int(ref_p))
    clv_c, s_c = fetch(int(ref_c))
    right = torch.einsum("cij,cjp->cip", P_edge.to(dtype),
                         clv_c.reshape(C, S, -1))
    fc = partition.freqs_per_cat().to(dtype)
    per_cat = (clv_p.reshape(C, S, -1) * right * fc[:, :, None]).sum(dim=1)
    lnl = lk_mod._site_lnl(partition, per_cat.T, s_p + s_c)
    return torch.sum(lnl * partition.pattern_weights)


def loglikelihood_pallas(partition, levels, brlens, offsets, root_info,
                         n_slots: int, step: str = "child2", tables=None):
    """Full-tree logL through the per-level kernels (float32 partitions).
    ``root_info``: (ref_p, ref_c, root_edge) with refs remapped through
    the LevelSchedule (``engine.compile_schedule``); ``step`` and
    ``tables`` as in :func:`update_partials_pallas`."""
    if partition.dtype != torch.float32:
        raise PllModError(ERROR_UNSUPPORTED,
                          "the per-level kernels run float32 partitions "
                          f"only (got {partition.dtype}); use "
                          "schedule='levels' or 'scan'")
    P = partition.prob_matrices(brlens)
    clvs, scalers = update_partials_pallas(partition, P, levels, offsets,
                                           n_slots, step, tables)
    u, v, e = root_info
    return root_loglikelihood_csp(partition, clvs, scalers, u, v, P[e])
