"""Generic masked parameter-vector optimization over one partition —
counterpart of ``pllmod_tpu.optimize.params`` (the reference's
``pllmod_opt_optimize_onedim`` / ``pllmod_opt_optimize_multidim``,
pll_optimize.c:411-454, 473-742, and the parameter-vector encoder
``set_x_to_parameters``, pll_optimize.c:71-301).

Any combination of PLLMOD_OPT_PARAM_* bits packs into one flat ``x``
vector, in the reference's segment order

    SUBST_RATES (symmetry classes, last class pinned to 1)
    FREQUENCIES (s-1 ratios to the last state)
    PINV        (one scalar, written to every rate matrix)
    ALPHA       (one scalar; gamma cats recomputed differentiably)
    FREE_RATES  (rate_cats)
    RATE_WEIGHTS(C-1 ratios to the last category)
    BRANCHES_ALL(every branch length)

and one projected L-BFGS run optimizes the whole vector with analytic
gradients: the edge decomposition of ``optimize/edge_grad.py``, whose
gradient covers the branch lengths too (each length enters only its own
edge's P). ``optimize_onedim`` is the Brent single-scalar path (ALPHA /
PINV / BRANCHES_SINGLE) over plain evaluations.

As in the JAX package, frequency and rate-weight ratios are pinned to
the LAST state/category instead of the reference's argmax: with analytic
gradients the pin only affects conditioning, not the optimum.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.common import (
    OPT_ERROR_PARAMETER, PARAM_ALPHA, PARAM_BRANCHES_ALL,
    PARAM_BRANCHES_SINGLE, PARAM_FREE_RATES, PARAM_FREQUENCIES, PARAM_PINV,
    PARAM_RATE_WEIGHTS, PARAM_SUBST_RATES, OptimizeError)
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.optimize import edge_grad as eg
from pllmod_tpu_torch.optimize.brent import minimize_brent_multi
from pllmod_tpu_torch.optimize.lbfgsb import minimize_lbfgsb

_MULTIDIM_ORDER = (PARAM_SUBST_RATES, PARAM_FREQUENCIES, PARAM_PINV,
                   PARAM_ALPHA, PARAM_FREE_RATES, PARAM_RATE_WEIGHTS,
                   PARAM_BRANCHES_ALL)


def _host(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _segments(partition, tree, which, symmetries):
    """(bit, size, x0, lo, hi) per selected segment, reference order; the
    rates segment also carries its (remap, pinned) packing."""
    segs = []
    s, C = partition.states, partition.n_cats
    packing = None
    if which & PARAM_SUBST_RATES:
        remap, pinned, k, x0 = eg.rate_classes(partition, symmetries)
        if k >= 2:
            packing = (remap, pinned)
            segs.append((PARAM_SUBST_RATES, k - 1,
                         np.clip(x0, common.MIN_SUBST_RATE,
                                 common.MAX_SUBST_RATE),
                         common.MIN_SUBST_RATE, common.MAX_SUBST_RATE))
    if which & PARAM_FREQUENCIES:
        cur = _host(partition.freqs[0])
        segs.append((PARAM_FREQUENCIES, s - 1,
                     np.clip(cur[:-1] / cur[-1], common.MIN_FREQ,
                             common.MAX_FREQ),
                     common.MIN_FREQ, common.MAX_FREQ))
    if which & PARAM_PINV:
        segs.append((PARAM_PINV, 1,
                     np.array([max(float(partition.pinv_mix()), 0.02)]),
                     1e-9, common.MAX_PINV))
    if which & PARAM_ALPHA:
        segs.append((PARAM_ALPHA, 1, np.array([float(partition.alpha)]),
                     common.MIN_ALPHA, common.MAX_ALPHA))
    if which & PARAM_FREE_RATES:
        segs.append((PARAM_FREE_RATES, C, _host(partition.rate_cats),
                     common.MIN_RATE, common.MAX_RATE))
    if which & PARAM_RATE_WEIGHTS:
        cur = _host(partition.rate_weights)
        segs.append((PARAM_RATE_WEIGHTS, C - 1,
                     np.clip(cur[:-1] / cur[-1], 1e-4, 1e4), 1e-4, 1e4))
    if which & PARAM_BRANCHES_ALL:
        live = np.asarray(tree.lengths, np.float64)
        segs.append((PARAM_BRANCHES_ALL, len(live),
                     np.clip(live, common.MIN_BRANCH_LEN,
                             common.MAX_BRANCH_LEN),
                     common.MIN_BRANCH_LEN, common.MAX_BRANCH_LEN))
    return segs, packing


def _make_builder(partition, tree, which, symmetries):
    """x (float64 tensor) -> (partition', brlens'), differentiable."""
    segs, packing = _segments(partition, tree, which, symmetries)
    offsets = np.cumsum([0] + [sz for _, sz, *_ in segs])
    seg_of = {bit: (int(offsets[i]), int(offsets[i] + sz))
              for i, (bit, sz, *_rest) in enumerate(segs)}
    brl0 = torch.as_tensor(tree.lengths, dtype=partition.dtype,
                           device=partition.device)

    def build(x):
        part = partition
        if PARAM_SUBST_RATES in seg_of:
            a, b = seg_of[PARAM_SUBST_RATES]
            part = eg.with_rates(part, eg.expand_sym(x[a:b], *packing))
        if PARAM_FREQUENCIES in seg_of:
            a, b = seg_of[PARAM_FREQUENCIES]
            part = eg.with_freq_ratios(part, x[a:b])
        if PARAM_PINV in seg_of:
            a, _ = seg_of[PARAM_PINV]
            part = part.replace(prop_invar=eg.rows(x[a], part.prop_invar))
        if PARAM_ALPHA in seg_of:
            a, _ = seg_of[PARAM_ALPHA]
            part = part.with_alpha(x[a])
        if PARAM_FREE_RATES in seg_of:
            a, b = seg_of[PARAM_FREE_RATES]
            part = eg.with_cats(part, x[a:b])
        if PARAM_RATE_WEIGHTS in seg_of:
            a, b = seg_of[PARAM_RATE_WEIGHTS]
            raw = torch.cat([x[a:b], torch.ones(1, dtype=x.dtype,
                                                device=x.device)])
            part = part.replace(rate_weights=(raw / raw.sum()).to(
                part.dtype))
        if PARAM_BRANCHES_ALL in seg_of:
            a, b = seg_of[PARAM_BRANCHES_ALL]
            brl = x[a:b].to(partition.dtype)
        else:
            brl = brl0
        return part, brl

    return build, segs, seg_of


def optimize_multidim(partition, tree, which: int, symmetries=None,
                      umin=None, umax=None, tol: float = 1e-4,
                      max_iters: int = 200):
    """One projected-L-BFGS run over every parameter selected in ``which``
    (pllmod_opt_optimize_multidim, pll_optimize.c:473-742), on the
    partition's device.

    Args:
      which: OR of PARAM_SUBST_RATES | PARAM_FREQUENCIES | PARAM_PINV |
        PARAM_ALPHA | PARAM_FREE_RATES | PARAM_RATE_WEIGHTS |
        PARAM_BRANCHES_ALL
      symmetries: rate-symmetry int vector (SUBST_RATES packing)
      umin/umax: optional flat bound arrays over the whole packed vector
        (reference signature); default = the per-segment PLLMOD_OPT_MIN/
        MAX_* constants.
    Returns (new_partition, logL). With BRANCHES_ALL set, ``tree.lengths``
    is updated in place (the reference writes its branch buffer back).
    """
    known = 0
    for bit in _MULTIDIM_ORDER:
        known |= bit
    if not (which & known):
        raise OptimizeError(OPT_ERROR_PARAMETER,
                            f"no optimizable parameter in mask {which:#x}")
    build, segs, seg_of = _make_builder(partition, tree, which, symmetries)
    x0 = np.concatenate([x for _, _, x, _, _ in segs])
    lo = np.concatenate([np.full(sz, lo) for _, sz, _, lo, _ in segs])
    hi = np.concatenate([np.full(sz, hi) for _, sz, _, _, hi in segs])
    if umin is not None:
        lo = np.broadcast_to(np.asarray(umin, np.float64), lo.shape)
    if umax is not None:
        hi = np.broadcast_to(np.asarray(umax, np.float64), hi.shape)
    et = eg.edge_tables(partition, tree)
    dev = partition.device

    def vg(z):
        xt = torch.tensor(z, dtype=torch.float64, device=dev,
                          requires_grad=True)
        f = eg.edge_decomp_neg_loglh(*build(xt), et)
        g, = torch.autograd.grad(f, xt)
        host = torch.cat([f.detach().reshape(1), g]).cpu().numpy()
        return host[0], host[1:]

    x, fv, _ = minimize_lbfgsb(vg, np.clip(x0, lo, hi), lo, hi,
                               max_iters=max_iters, pgtol=tol)
    with torch.no_grad():
        part, brl = build(torch.as_tensor(x, dtype=torch.float64,
                                          device=dev))
    if PARAM_BRANCHES_ALL in seg_of:
        tree.lengths[:] = _host(brl)
    return part, -float(fv)


def optimize_onedim(partition, tree, which: int, edge: int | None = None,
                    umin: float | None = None, umax: float | None = None,
                    tol: float = 1e-4):
    """Brent on one scalar: ALPHA, PINV, or BRANCHES_SINGLE
    (pllmod_opt_optimize_onedim, pll_optimize.c:411-454), each evaluation
    through the partition's ``engine.compile_fast_eval`` evaluator. Any
    other mask raises, like the reference's -INFINITY return.

    Returns (new_partition, logL); BRANCHES_SINGLE updates
    ``tree.lengths[edge]`` in place and returns the partition unchanged.
    """
    if partition.reversible and partition.eigen_lam is None and \
            which in (PARAM_PINV, PARAM_BRANCHES_SINGLE):
        partition = partition.cache_eigen()
    dt, dev = partition.dtype, partition.device
    brl0 = torch.as_tensor(tree.lengths, dtype=dt, device=dev)

    if which == PARAM_ALPHA:
        x0 = float(partition.alpha)
        lo = umin if umin else common.MIN_ALPHA
        hi = umax if umax else common.MAX_ALPHA

        def make(x):
            return partition.with_alpha(x), brl0
    elif which == PARAM_PINV:
        x0 = max(float(partition.pinv_mix()), 0.02)
        lo = umin if umin else 1e-9
        hi = umax if umax else common.MAX_PINV

        def make(x):
            return partition.replace(
                prop_invar=torch.full_like(partition.prop_invar, x)), brl0
    elif which == PARAM_BRANCHES_SINGLE:
        if edge is None:
            raise OptimizeError(OPT_ERROR_PARAMETER,
                                "BRANCHES_SINGLE needs an edge id")
        x0 = float(tree.lengths[edge])
        lo = umin if umin else common.MIN_BRANCH_LEN
        hi = umax if umax else common.MAX_BRANCH_LEN

        def make(x):
            brl = brl0.clone()
            brl[edge] = x
            return partition, brl
    else:
        raise OptimizeError(OPT_ERROR_PARAMETER,
                            f"mask {which:#x} is not a one-dim parameter")
    ev = engine_mod.compile_fast_eval(partition, tree)

    def obj(xs, live):
        return np.array([-float(ev(*make(float(xs[0]))))])

    x_opt, f_opt = minimize_brent_multi(obj, np.array([lo]), np.array([hi]),
                                        x0=np.array([np.clip(x0, lo, hi)]),
                                        tol=tol)
    x = float(x_opt[0])
    if which == PARAM_BRANCHES_SINGLE:
        tree.lengths[edge] = x
        return partition, -float(f_opt[0])
    part, _ = make(x)
    return part, -float(f_opt[0])
