"""Branch-length derivative kernels on the fused walk's buffers — the
counterpart of ``pllmod_tpu.ops.pallas_deriv``.

Three CUDA kernels (``csrc/deriv.cu``), each with its wrapper, its plain
torch version, each launch counted in ``profile.LAUNCHES`` under its
entry point's name:

- :func:`edge_sumtables` (kernel 8, ``pllmod_edge_sumtables``): per-edge
  sumtables ``st [E, C·S, Ppad]`` float32 and summed scalers
  ``sc [E, 1, Ppad]`` int32 straight from directed CLVs
  ``[n_slots, C·S, Ppad]`` (the layout of :func:`fused.fused_walk`);
- :func:`edge_derivatives_k` (kernel 9, ``pllmod_edge_derivs``):
  per-edge (logL, d/dt, d²/dt²) from the sumtables at lengths ``t``;
- :func:`newton_edges_multi` (kernel 10, ``pllmod_newton_edges``): a
  whole bracketed Newton optimization per edge (the rules of
  :func:`pllmod_tpu_torch.optimize.newton.minimize_newton_multi`) over K
  partitions that share the edge lengths, with its logL at the start
  lengths and its iteration count; :func:`newton_edges` is its
  single-partition form (one kernel, counted per form: K > 1 under
  ``pllmod_newton_edges_multi``).

The float64 formulation (:mod:`pllmod_tpu_torch.ops.derivatives`) is the
yardstick. On a CPU tensor a wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises. The host glue (edge-reference
rows, the sumtable basis, the exponential weight rows, the p-inv plane)
is plain torch shared by both.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops.clv import LN2
from pllmod_tpu_torch.ops.derivatives import invariant_term
from pllmod_tpu_torch.optimize.newton import newton_step

TINY = 1e-37             # float32 floor of a site likelihood
LN_ZERO = -1e30          # log of a zero p-inv term


# ---------------------------------------------------------------------------
# host glue
# ---------------------------------------------------------------------------
def compile_edge_refs_np(edge_ref, edge_mask, n_tips: int):
    """Pack a DirectedTraversal's ``edge_ref`` [E, 2] into the kernels'
    [E, 6] int32 rows (slot1, slot2, is_tip1, is_tip2, tip1, tip2), the
    column convention of the walk tables' idx8[:, :6]. Dead edge slots
    become tip0/tip0 dummies (masked downstream)."""
    edge_ref = np.asarray(edge_ref)
    edge_mask = np.asarray(edge_mask)
    out = np.zeros((edge_ref.shape[0], 6), np.int64)
    out[:, 2] = out[:, 3] = 1                      # dummy: tip/tip
    for e in np.nonzero(edge_mask)[0]:
        for k in (0, 1):
            r = int(edge_ref[e, k])
            if r < n_tips:
                out[e, k], out[e, 2 + k], out[e, 4 + k] = 0, 1, r
            else:
                out[e, k], out[e, 2 + k], out[e, 4 + k] = r - n_tips, 0, 0
    return out.astype(np.int32)


def compile_edge_refs(edge_ref, edge_mask, n_tips: int, device):
    """:func:`compile_edge_refs_np` as an int32 tensor on ``device``."""
    return torch.as_tensor(compile_edge_refs_np(edge_ref, edge_mask, n_tips),
                           device=device)


def sumtable_basis(partition, eigen=None):
    """The paired sumtable basis [2, C, S, S] float32: ``[0, c] = A_c``
    with A_c[k, i] = π_c[i]·V_c[i, k], ``[1, c] = V⁻¹_c``, so that
    left = A_c·clv_a, right = V⁻¹_c·clv_b and st = left ⊙ right (the
    diagonal blocks of pallas_deriv.sumtable_basis)."""
    if eigen is None:
        eigen = partition.eigen()
    _, V, Vinv = eigen
    pidx = partition.param_indices
    V_c = V[pidx].to(torch.float32)                 # [C,S,S]
    pi_c = partition.freqs_per_cat().to(torch.float32)
    A_c = (V_c * pi_c[:, :, None]).transpose(1, 2)
    return torch.stack([A_c, Vinv[pidx].to(torch.float32)]).contiguous()


def sumtable_tip_tables(partition, basis):
    """[2, n_codes, C, S] float32: the basis applied to every tip code's
    CLV row — what a tip side of the sumtable kernel looks up."""
    codetab = partition.code_clv.to(torch.float32)
    return torch.einsum("hcki,ni->hnck", basis, codetab).contiguous()


def _lam_weight_rows(partition, eigen=None, scale=1.0):
    """[2, C·S] float32 rows (λ·r_c·scale per flat cat-state, effective
    weight w_c·(1−p_c) repeated per state): the t-independent pieces of
    :func:`deriv_coeffs`, read by the derivative and Newton kernels.
    ``scale`` folds a SCALED-linkage branch-length scaler into λr
    (pll_optimize.c:1249-1267)."""
    if eigen is None:
        eigen = partition.eigen()
    pidx = partition.param_indices
    pinv_c = partition.prop_invar[pidx]
    rc = partition.rate_cats / (1.0 - pinv_c)
    lr = (eigen[0][pidx] * rc[:, None] * scale).to(torch.float32)
    w = (partition.rate_weights * (1.0 - pinv_c)).to(torch.float32)
    return torch.stack([lr.reshape(-1),
                        w.repeat_interleave(partition.states)]).contiguous()


def deriv_coeffs(partition, t, eigen=None, lw=None):
    """Per-edge exponential weight rows [E, 3, C·S] float32:
    (w·e^{λrt}, w·λr·e^{λrt}, w·(λr)²·e^{λrt})."""
    if lw is None:
        lw = _lam_weight_rows(partition, eigen)
    return _coeff_rows(torch.as_tensor(t, device=lw.device), lw)


def _coeff_rows(t, lw):
    """The rows of :func:`deriv_coeffs` from float32 ``lw`` and ``t``,
    evaluated in float64 and rounded once to float32, as the kernels do:
    dL and ddL sum terms of both signs, so float32 rounding of the
    exponentials alone moves d/dt by ~1e-4 of its value near an
    optimum."""
    lr, w = lw[0].double(), lw[1].double()
    r0 = w * torch.exp(t.to(torch.float32).double()[:, None] * lr)
    r1 = r0 * lr
    return torch.stack([r0, r1, r1 * lr], dim=1).to(torch.float32)


def invar_log_plane(partition):
    """The p-inv mixture term B per pattern, in log space, as a [Ppad]
    float32 plane (−1e30 where B = 0)."""
    B = invariant_term(partition)
    lnB = torch.where(B > 0, torch.log(torch.clamp(B, min=TINY)),
                      torch.full_like(B, LN_ZERO))
    return lnB.to(torch.float32).contiguous()


def _deriv_inputs(partition, lw, lnB):
    if lw is None:
        lw = _lam_weight_rows(partition)
    if lnB is None:
        lnB = invar_log_plane(partition)
    pw = partition.pattern_weights.to(torch.float32).contiguous()
    return lw, lnB, pw


# ---------------------------------------------------------------------------
# kernel 8: per-edge sumtables
# ---------------------------------------------------------------------------
def edge_sumtables(partition, clvs, scalers, eref6, basis=None, *,
                   tile: int | None = None, simple: bool = False):
    """Per-edge sumtables from directed CLVs.

    Args:
      clvs: float32 [n_slots, C·S, Ppad], scalers: int32 [n_slots, 1,
        Ppad] (the fused walk's buffers)
      eref6: int32 [E, 6] (:func:`compile_edge_refs`)
      basis: optional :func:`sumtable_basis`
      tile: force kernel 8's tiled kernel at this pattern tile
        (:func:`_build.sumtable_config`); simple: force its simple
        kernel; by default the rule picks
    Returns:
      (st [E, C·S, Ppad] float32, sc [E, 1, Ppad] int32)
    """
    if basis is None:
        basis = sumtable_basis(partition)
    tabs = sumtable_tip_tables(partition, basis)
    if clvs.device.type == "cpu":
        return _sumtables_plain(partition, clvs, scalers, eref6, basis, tabs)
    name = "pllmod_edge_sumtables"
    C, S = partition.n_cats, partition.states
    n_slots, _, Ppad = clvs.shape
    E, n_codes = eref6.shape[0], tabs.shape[1]
    codes = partition.tip_states
    _build.check_tensors(name, [
        (clvs, torch.float32, (n_slots, C * S, Ppad)),
        (scalers, torch.int32, (n_slots, 1, Ppad)),
        (eref6, torch.int32, (E, 6)),
        (codes, torch.int32, (partition.n_tips, Ppad)),
        (basis, torch.float32, (2, C, S, S)),
        (tabs, torch.float32, (2, n_codes, C, S))])
    if S > _build.MAX_STATES:
        raise ValueError(f"{name}: takes at most {_build.MAX_STATES} "
                         f"states, got S={S}")
    if simple or _build.sumtable_config(C, S, n_codes, Ppad, E,
                                        tile) is None:
        if tile and not simple:
            raise ValueError(f"{name}: the tiled kernel takes no "
                             f"configuration at tile {tile} (C={C}, S={S}, "
                             f"Ppad={Ppad})")
        T = _build.pattern_tile(C)
        if Ppad % T or Ppad // T > 65535:
            raise ValueError(f"{name}: the simple kernel takes a multiple "
                             f"of {T} patterns (at most {65535 * T}); "
                             f"got Ppad={Ppad}")
    st = torch.empty((E, C * S, Ppad), dtype=torch.float32,
                     device=clvs.device)
    sc = torch.empty((E, 1, Ppad), dtype=torch.int32, device=clvs.device)
    if E:
        _build.launch(name, clvs.device, eref6.data_ptr(), E,
                      clvs.data_ptr(), scalers.data_ptr(), n_slots,
                      codes.data_ptr(), partition.n_tips, basis.data_ptr(),
                      tabs.data_ptr(), n_codes, st.data_ptr(), sc.data_ptr(),
                      Ppad, C, S, tile or 0, int(simple))
    return st, sc


def edge_sumtables_plain(partition, clvs, scalers, eref6, basis=None):
    """Plain torch version of :func:`edge_sumtables`: the kernel's
    arithmetic, every product and sum rounded separately in state
    order, so that the two agree bit for bit."""
    if basis is None:
        basis = sumtable_basis(partition)
    return _sumtables_plain(partition, clvs, scalers, eref6, basis,
                            sumtable_tip_tables(partition, basis))


def _sumtables_plain(partition, clvs, scalers, eref6, basis, tabs):
    C, S = partition.n_cats, partition.states
    n_slots, _, Ppad = clvs.shape
    ref = eref6.long()
    E = ref.shape[0]

    def side(k):
        is_tip = ref[:, 2 + k].bool()
        x = clvs[ref[:, k].clamp(0, n_slots - 1)].view(E, C, S, Ppad)
        inner = clv_mod.apply_pmat(basis[k], x)              # [E,C,S,P]
        codes = partition.tip_states[ref[:, 4 + k]].long()   # [E,P]
        tip = tabs[k][codes].permute(0, 2, 3, 1)             # [E,C,S,P]
        s = torch.where(is_tip[:, None], 0,
                        scalers[ref[:, k].clamp(0, n_slots - 1), 0])
        return torch.where(is_tip[:, None, None, None], tip, inner), s

    left, s1 = side(0)
    right, s2 = side(1)
    return ((left * right).reshape(E, C * S, Ppad),
            (s1 + s2).to(torch.int32)[:, None, :])


# ---------------------------------------------------------------------------
# kernel 9: per-edge derivatives
# ---------------------------------------------------------------------------
def edge_derivatives_k(partition, st, sc, t, lw=None, lnB=None):
    """(logL, d logL/dt, d² logL/dt²) per edge, each float32 [E], from the
    sumtables at branch lengths ``t`` [E] (one read of st).
    ``lw`` / ``lnB``: optional :func:`_lam_weight_rows` /
    :func:`invar_log_plane`."""
    lw, lnB, pw = _deriv_inputs(partition, lw, lnB)
    t = torch.as_tensor(t).to(st.device, torch.float32).contiguous()
    if st.device.type == "cpu":
        return _derivs_plain(st, sc, t, lw, lnB, pw)
    E, CS, Ppad = st.shape
    _build.check_tensors("pllmod_edge_derivs", [
        (st, torch.float32, (E, CS, Ppad)), (sc, torch.int32, (E, 1, Ppad)),
        (lw, torch.float32, (2, CS)), (lnB, torch.float32, (Ppad,)),
        (pw, torch.float32, (Ppad,)), (t, torch.float32, (E,))])
    out = torch.empty((E, 3), dtype=torch.float32, device=st.device)
    if E:
        _build.launch("pllmod_edge_derivs", st.device, st.data_ptr(),
                      sc.data_ptr(), lw.data_ptr(), lnB.data_ptr(),
                      pw.data_ptr(), t.data_ptr(), out.data_ptr(), E, CS,
                      Ppad)
    return out[:, 0], out[:, 1], out[:, 2]


def edge_derivatives_plain(partition, st, sc, t, lw=None, lnB=None):
    """Plain torch version of :func:`edge_derivatives_k` (the same site
    math; sums in another order)."""
    lw, lnB, pw = _deriv_inputs(partition, lw, lnB)
    t = torch.as_tensor(t).to(st.device, torch.float32)
    return _derivs_plain(st, sc, t, lw, lnB, pw)


def _derivs_sums(st, sc, t, lw, lnB, pw):
    """The pattern-weighted (logL, d/dt, d²/dt²) sums per edge in
    float64, before their rounding to float32."""
    coef = _coeff_rows(t, lw)                                 # [E,3,CS]
    rows = torch.bmm(coef, st)                                # [E,3,P]
    L, dL, ddL = rows[:, 0], rows[:, 1], rows[:, 2]
    Lsafe = torch.clamp(L, min=TINY)
    ln_a = torch.log(Lsafe) + sc[:, 0].to(torch.float32) * LN2
    mx = torch.maximum(ln_a, lnB)
    site = mx + torch.log1p(torch.exp(-(ln_a - lnB).abs()))
    frac = torch.exp(ln_a - site)
    r1s = frac * dL / Lsafe
    ddf = frac * ddL / Lsafe - r1s * r1s

    def wsum(v):
        return (v * pw).to(torch.float64).sum(-1)

    return wsum(site), wsum(r1s), wsum(ddf)


def _derivs_plain(st, sc, t, lw, lnB, pw):
    return tuple(v.to(torch.float32)
                 for v in _derivs_sums(st, sc, t, lw, lnB, pw))


# ---------------------------------------------------------------------------
# kernel 10: per-edge Newton over K partitions
# ---------------------------------------------------------------------------
NEWTON_CLUSTERS = (2, 4, 8, 16)      # CTAs an edge of the cluster form
NEWTON_KINDS = ("stream", "cluster")


def newton_config(cs, ppads, force: int = 0):
    """Kernel 10's design for K partitions of C·S ``cs`` and patterns
    ``ppads`` (csrc/configs.h deriv::newton_config), or None: a dict of
    kind, N (CTAs an edge) and smem (bytes a CTA). The rule: the smallest
    cluster of NEWTON_CLUSTERS whose CTAs each hold their pattern slice
    of every partition's sumtable, scaler, p-inv and weight rows beside
    the coefficient and λr / weight rows ("cluster": the edge's inputs
    are loaded once and the iterations run on chip), else one CTA an
    edge that streams them every iteration ("stream"). ``force``: 1 the
    streaming design, a cluster size that cluster, 0 the rule. Cached
    per shape."""
    return _newton_config(tuple(cs), tuple(ppads), force)


@functools.lru_cache(maxsize=None)
def _newton_config(cs: tuple, ppads: tuple, force: int):
    dims = (ctypes.c_longlong * (2 * len(cs)))(
        *[v for c, p in zip(cs, ppads) for v in (c, p)])
    return _build.query_config("pllmod_newton_config", ("kind", "N", "smem"),
                               NEWTON_KINDS, len(cs), dims, force)


def newton_fits(*partitions) -> bool:
    """Whether kernel 10 takes these partitions at once: its streaming
    design, their coefficient rows in one block's shared memory, fits
    (the port's rule; the JAX package's ``newton_fits_vmem`` is a VMEM
    gate of the TPU)."""
    return newton_config([p.n_cats * p.states for p in partitions],
                         [p.n_patterns_padded for p in partitions],
                         1) is not None


def newton_edges(partition, st, sc, t0, xmin, xmax, tol, max_iters=10,
                 lw=None, lnB=None):
    """Bracketed Newton optimization of every edge from its sumtable
    (single partition): :func:`newton_edges_multi` with K = 1.

    Returns (t_opt [E] float32, lnl0 [E] float32 — each edge's logL at
    ``t0`` — and iters [E] int32, the derivative evaluations each edge
    took before it converged or hit ``max_iters``)."""
    return newton_edges_multi(
        (partition,), (st,), (sc,), t0, (1.0,), xmin, xmax, tol, max_iters,
        None if lw is None else (lw,), None if lnB is None else (lnB,))


def newton_edges_plain(partition, st, sc, t0, xmin, xmax, tol, max_iters=10,
                       lw=None, lnB=None):
    """Plain torch version of :func:`newton_edges`: the masked
    ``minimize_newton_multi`` loop over :func:`edge_derivatives_plain`,
    recording each edge's logL at ``t0`` and its iteration count."""
    return newton_edges_multi_plain(
        (partition,), (st,), (sc,), t0, (1.0,), xmin, xmax, tol, max_iters,
        None if lw is None else (lw,), None if lnB is None else (lnB,))


def _multi_inputs(partitions, scalers, lws, lnBs):
    """Per partition (lw with its scaler folded into λr, lnB, pw)."""
    K = len(partitions)
    lws = lws if lws is not None else [None] * K
    lnBs = lnBs if lnBs is not None else [None] * K
    out = []
    for part, s, lw, lnB in zip(partitions, scalers, lws, lnBs):
        if lw is None:
            lw = _lam_weight_rows(part, scale=s)
        out.append(_deriv_inputs(part, lw, lnB))
    return out


def newton_edges_multi(partitions, sts, scs, t0, scalers, xmin, xmax, tol,
                       max_iters=10, lws=None, lnBs=None, force: int = 0):
    """Bracketed Newton optimization of every edge over K partitions that
    share its length (``pallas_deriv.newton_edges_pallas_multi``): per
    iteration the K partitions' (logL, d/dt, d²/dt²) are summed.

    Args:
      partitions: K partitions; sts / scs: their sumtables [E, C·S_k,
        P_k] / [E, 1, P_k] (:func:`edge_sumtables`), built at
        ``t0 · scalers[k]``
      t0: [E] shared start lengths; scalers: K branch-length scalers
        (SCALED linkage; 1.0 otherwise), folded into each partition's λr
        row (:func:`_lam_weight_rows`), so the derivatives are in the
        shared length
      lws / lnBs: optional per-partition :func:`_lam_weight_rows` (with
        the scaler already folded in) / :func:`invar_log_plane`
    Returns:
      (t_opt [E] float32, lnl0 [E] float32 — each edge's summed logL at
      ``t0`` — and iters [E] int32)
    CUDA tensors launch kernel 10 (counted as "pllmod_newton_edges" for
    K = 1, "pllmod_newton_edges_multi" above) in the design of
    :func:`newton_config` (``force`` as there); CPU tensors run the plain
    version.
    """
    inputs = _multi_inputs(partitions, scalers, lws, lnBs)
    dev = sts[0].device
    t0 = torch.as_tensor(t0).to(dev, torch.float32).contiguous()
    if dev.type == "cpu":
        return _newton_plain(sts, scs, inputs, t0, xmin, xmax, tol,
                             max_iters)
    name = "pllmod_newton_edges"
    E = sts[0].shape[0]
    rows, cs = [], []
    for st, sc, (lw, lnB, pw) in zip(sts, scs, inputs):
        _, CS, Ppad = st.shape
        _build.check_tensors(name, [
            (st, torch.float32, (E, CS, Ppad)),
            (sc, torch.int32, (E, 1, Ppad)), (lw, torch.float32, (2, CS)),
            (lnB, torch.float32, (Ppad,)), (pw, torch.float32, (Ppad,)),
            (t0, torch.float32, (E,))])
        rows.append([st.data_ptr(), sc.data_ptr(), lw.data_ptr(),
                     lnB.data_ptr(), pw.data_ptr(), CS, Ppad])
        cs.append(CS)
    if max_iters < 1:
        raise ValueError("newton_edges: max_iters must be at least 1")
    ppads = [r[6] for r in rows]
    if newton_config(cs, ppads, force) is None:
        raise ValueError(f"{name}: the coefficient rows of C·S {cs} do "
                         f"not fit a block's shared memory"
                         if force in (0, 1) else
                         f"{name}: a cluster of {force} CTAs an edge does "
                         f"not hold C·S {cs} × patterns {ppads} in shared "
                         f"memory")
    t_opt = torch.empty(E, dtype=torch.float32, device=dev)
    lnl0 = torch.empty(E, dtype=torch.float32, device=dev)
    iters = torch.empty(E, dtype=torch.int32, device=dev)
    if E:
        # the descriptors (csrc/deriv.cu PartDesc): pinned, so that the
        # copy queues on the stream without waiting for it
        desc = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        dims = (ctypes.c_longlong * (2 * len(rows)))(
            *[v for c, p in zip(cs, ppads) for v in (c, p)])
        _build.launch(name, dev, desc.data_ptr(), len(rows),
                      ctypes.addressof(dims), t0.data_ptr(), float(xmin),
                      float(xmax), float(tol), int(max_iters),
                      t_opt.data_ptr(), lnl0.data_ptr(), iters.data_ptr(),
                      E, int(force),
                      key=name if len(rows) == 1 else f"{name}_multi")
    return t_opt, lnl0, iters


def newton_edges_multi_plain(partitions, sts, scs, t0, scalers, xmin, xmax,
                             tol, max_iters=10, lws=None, lnBs=None):
    """Plain torch version of :func:`newton_edges_multi`: the masked
    ``minimize_newton_multi`` loop over the partitions' summed
    derivatives (each partition's pattern sums in float64, added in
    partition order and rounded once to float32, as the kernel does)."""
    inputs = _multi_inputs(partitions, scalers, lws, lnBs)
    t0 = torch.as_tensor(t0).to(sts[0].device, torch.float32)
    return _newton_plain(sts, scs, inputs, t0, xmin, xmax, tol, max_iters)


def _newton_plain(sts, scs, inputs, t0, xmin, xmax, tol, max_iters):
    dev = sts[0].device

    def derivs(x):
        tot = None
        for st, sc, (lw, lnB, pw) in zip(sts, scs, inputs):
            sums = _derivs_sums(st, sc, x, lw, lnB, pw)
            tot = sums if tot is None else tuple(
                a + b for a, b in zip(tot, sums))
        return tuple(v.to(torch.float32) for v in tot)

    xmin = torch.full_like(t0, float(xmin))
    xmax = torch.full_like(t0, float(xmax))
    max_step = (xmax - xmin) / max_iters
    x, xl, xh = t0, xmin, xmax
    lnl0 = torch.zeros(t0.shape, dtype=torch.float32, device=dev)
    iters = torch.zeros(t0.shape, dtype=torch.int32, device=dev)
    conv = torch.zeros(t0.shape, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        if conv.device.type == "cpu" and bool(conv.all()):
            break
        lnl, df, ddf = derivs(x)
        if it == 0:
            lnl0 = lnl
        x_new, xl_n, xh_n = newton_step(x, df, ddf, xl, xh, xmin, xmax,
                                        max_step)
        live = ~conv
        xl = torch.where(live, xl_n, xl)
        xh = torch.where(live, xh_n, xh)
        iters = iters + live.to(torch.int32)
        conv = conv | ((x_new - x).abs() < tol) | (df == 0)
        x = torch.where(live, x_new, x)
    return x, lnl0, iters
