"""Model-parameter optimization over a TreeInfo — counterpart of
``pllmod_tpu.algorithm.opt_model`` (``pllmod_algorithm.c`` single and
treeinfo families, :51-480 and :729-1870, and their target callbacks).

The reference packs parameters and runs L-BFGS-B / Brent / EM with
finite-difference gradients, each evaluation re-entering the full
likelihood. Here, as in the JAX package:

- rates (symmetry classes, the class of the last rate pinned to 1),
  frequencies (ratios to the last state), alpha + p-inv together, and
  free category rates run the lock-step L-BFGS
  (:func:`~pllmod_tpu_torch.optimize.lbfgsb.minimize_lbfgsb_multi`)
  with analytic gradients;
- alpha, p-inv and branch-length scalers alone run lock-step Brent lanes
  (:func:`~pllmod_tpu_torch.optimize.brent.minimize_brent_multi`) over
  plain evaluations: the partition's ``engine.compile_fast_eval``
  evaluator (kernel 1 or kernel 2's fused root for float32, the serial
  engine for float64);
- free rates + weights alternate EM on the weights with L-BFGS on the
  rates, the Σwr = 1 normalization pushed into the branch lengths;
- branches run the batched Newton BLO (kernels 8-10).

**Gradients by edge decomposition** (``optimize/edge_grad.py``): the
directed CLVs facing every edge are primal data (kernel 2's directed
walk for float32, the serial engine for float64) and autograd runs only
through θ → P and one root term. The JAX package's
autodiff-through-the-scan objectives (``_neg_*_fn``) compute the same
quantities; the port's serial scan writes its CLVs in place and cannot
be differentiated.

The lock-step L-BFGS makes one (value, grad) call for all lanes a step
and one device→host copy of all lanes' (f, g). The JAX package's
device-resident L-BFGS and whole-Brent programs, their policy switch
and the LRU caches of jitted programs exist for the TPU's dispatch cost
and are not ported.

Under a site mesh (``parallel.shard_treeinfo``; the JAX package's
``shard_map`` branches, opt_model.py:427-436, :505-557) every family
runs against the sharded partitions: the Brent lanes evaluate through a
reducing evaluator (each shard's kernel on its device, the logLs
reduced), the edge decomposition runs on every shard and sums, and the
EM E-step's per-category sums are reduced over the shards.

Every driver takes ``stats``, an optional dict that it fills by family
with counts: ``vg_calls`` (L-BFGS (value, grad) calls), ``brent_iters``
and ``evals`` (Brent objective calls and lane evaluations),
``em_steps``; ``opt_model`` adds each family's host ``seconds``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.common import (
    BRLEN_SCALED, BRLEN_UNLINKED, PARAM_ALPHA, PARAM_BRANCH_LEN_SCALER,
    PARAM_BRANCHES_ITERATIVE, PARAM_FREE_RATES, PARAM_FREQUENCIES,
    PARAM_PINV, PARAM_RATE_WEIGHTS, PARAM_SUBST_RATES)
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.ops import fused as fused_mod
from pllmod_tpu_torch.ops import gamma as gamma_mod
from pllmod_tpu_torch.optimize import blo as blo_mod
from pllmod_tpu_torch.optimize import edge_grad as eg
from pllmod_tpu_torch.optimize.brent import minimize_brent_multi
from pllmod_tpu_torch.optimize.em import em_rates_weights
from pllmod_tpu_torch.optimize.lbfgsb import minimize_lbfgsb_multi
from pllmod_tpu_torch.parallel.sharding import (is_sharded, per_shard,
                                                shards_of)

def _count(stats, family: str, key: str, n=1) -> None:
    if stats is not None:
        fam = stats.setdefault(family, {})
        fam[key] = fam.get(key, 0) + n


def _edge_tables(treeinfo, idx) -> eg.EdgeTables:
    """:func:`edge_tables` of partition ``idx``, cached on the treeinfo
    by partition and keyed on (topology, partition shape, the shards'
    devices): the families of one ``opt_model`` call reuse them."""
    part = treeinfo.partitions[idx]
    tree = treeinfo.tree
    key = (tree.edge_nodes.tobytes(), part.n_tips, str(part.dtype),
           part.n_cats, part.states, part.n_patterns_padded,
           part.code_clv.shape[0],
           tuple(str(s.device) for s in shards_of(part)))
    ent = treeinfo._edge_tables.get(idx)
    if ent is None or ent[0] != key:
        ent = treeinfo._edge_tables[idx] = (key, eg.edge_tables(part, tree))
    return ent[1]


def _brl_tensor(treeinfo, idx, src=None):
    part = treeinfo.partitions[idx]
    src = treeinfo.partition_brlens(idx) if src is None else src
    return torch.as_tensor(np.asarray(src, np.float64), dtype=part.dtype,
                           device=part.device)


@dataclasses.dataclass
class _Lane:
    """One partition's L-BFGS instance: its start and box, and
    ``build(x) -> partition`` (x a float64 tensor on the partition's
    device; the optimizer's result is ``build(x_opt)``) evaluated at
    ``brl`` against the tables ``et``."""
    x0: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    build: object
    brl: torch.Tensor
    et: eg.EdgeTables


def _lbfgsb_lanes(family: str, lanes, max_iters: int, pgtol: float,
                  stats=None):
    """K lanes through the lock-step L-BFGS: every step one (value, grad)
    call for all lanes (one backward) and one device→host copy of all
    lanes' (f, g). Returns the per-lane (x_opt, f_opt, n_evals)."""

    def vg_multi(xs):
        _count(stats, family, "vg_calls")
        xts = [torch.tensor(np.asarray(x, np.float64), dtype=torch.float64,
                            device=ln.brl.device, requires_grad=True)
               for x, ln in zip(xs, lanes)]
        fs = [eg.edge_decomp_neg_loglh(ln.build(xt), ln.brl, ln.et)
              for xt, ln in zip(xts, lanes)]
        gs = torch.autograd.grad(fs, xts, allow_unused=True)
        gs = [torch.zeros_like(xt) if g is None else g
              for g, xt in zip(gs, xts)]
        host = torch.cat([torch.stack(fs).detach().to(torch.float64)]
                         + [g.to(fs[0].device) for g in gs]).cpu().numpy()
        out, off = [], len(lanes)
        for k, xt in enumerate(xts):
            n = xt.numel()
            out.append((host[k], host[off:off + n]))
            off += n
        return out

    return minimize_lbfgsb_multi(
        vg_multi, [ln.x0 for ln in lanes], [ln.lo for ln in lanes],
        [ln.hi for ln in lanes], max_iters=max_iters, pgtol=pgtol)


def _evaluator(treeinfo, idx):
    """``ev(part, brlens) -> logL`` (0-dim tensor) of partition ``idx``
    on the current topology: the treeinfo's cached
    ``engine.compile_fast_eval`` evaluator for float32 (kernel 1, or
    kernel 2 with its root row, by the ``auto`` rule), the serial engine
    for float64. A sharded partition's evaluator runs each shard's on
    its device and reduces the logLs (``engine.shard_evaluator``)."""
    part = treeinfo.partitions[idx]
    ops, root_info = treeinfo.tree.traversal_ops()
    ri = tuple(int(x) for x in root_info)
    if is_sharded(part):
        return engine_mod.shard_evaluator(
            treeinfo._fast_eval(idx, part, ops, ri))
    if engine_mod.use_fast_kernel(part):
        return treeinfo._fast_eval(idx, part, ops, ri)

    def ev(p, brl):
        return engine_mod.loglikelihood(p, ops, brl, ri)
    return ev


def _select(treeinfo, need: int, both: bool = False):
    """Local partition indices whose mask has the bits ``need`` (all of
    them with ``both``, any of them otherwise)."""
    out = []
    for i in treeinfo.local_indices():
        m = treeinfo.params_to_optimize[i] & need
        if (m == need) if both else m:
            out.append(i)
    return out


# ---------------------------------------------------------------------------
# one-dimensional treeinfo optimizations (Brent): alpha, pinv, scaler
# ---------------------------------------------------------------------------
_BRENT_FAMILIES = {
    "alpha": lambda p, brl, x: (p.with_alpha(x), brl),
    "pinv": lambda p, brl, x: (
        p.replace(prop_invar=torch.full_like(p.prop_invar, x)), brl),
    "scaler": lambda p, brl, x: (p, brl * x),
}


def _opt_onedim(treeinfo, make_fn, get_x0, xmin, xmax, mask_bit, tol,
                family: str, brl_of=None, collect_x=None, stats=None):
    """Generic per-partition scalar Brent (pllmod_algo_opt_onedim_treeinfo,
    pllmod_algorithm.c:729-853). The selected partitions are lock-step
    lanes; each iteration evaluates the lanes that have not converged,
    one evaluation each, and reads their logLs in one copy.

    ``make_fn(partition, brlens, x) -> (partition', brlens')``;
    ``get_x0(i, partition)`` the start; ``brl_of(i)`` overrides the
    lengths a lane evaluates at (the scaler family: the base lengths);
    ``collect_x`` receives (partition index, x_opt) pairs."""
    sel = []
    for i in treeinfo.local_indices():
        if mask_bit is not None and \
                not (treeinfo.params_to_optimize[i] & mask_bit):
            continue
        part = treeinfo.partitions[i]
        # alpha / pinv / scaler leave rates and freqs fixed
        if part.reversible and part.eigen_lam is None:
            part = part.cache_eigen()
            treeinfo.partitions[i] = part
        src = brl_of(i) if brl_of is not None else None
        sel.append((i, part, _brl_tensor(treeinfo, i, src),
                    _evaluator(treeinfo, i)))
    if not sel:
        return 0.0

    def obj(xs, live):
        _count(stats, family, "brent_iters")
        vals = []
        for k, (_i, part, brl, ev) in enumerate(sel):
            if live is not None and not live[k]:
                vals.append(torch.zeros((), dtype=torch.float64,
                                        device=part.device))
                continue
            _count(stats, family, "evals")
            p2, b2 = make_fn(part, brl, float(xs[k]))
            vals.append(-ev(p2, b2).to(torch.float64))
        return torch.stack([v.to(vals[0].device) for v in vals]).cpu().numpy()

    x0 = np.array([get_x0(i, p) for i, p, _, _ in sel], np.float64)
    x_opt, f_opt = minimize_brent_multi(obj, np.full(len(sel), xmin),
                                        np.full(len(sel), xmax), x0=x0,
                                        tol=tol)
    total = 0.0
    for k, (i, part, brl, _ev) in enumerate(sel):
        treeinfo.partitions[i], _ = make_fn(part, brl, float(x_opt[k]))
        treeinfo.partition_loglh[i] = -float(f_opt[k])
        total += -float(f_opt[k])
        if collect_x is not None:
            collect_x.append((i, float(x_opt[k])))
    return total


def opt_alpha(treeinfo, min_alpha=common.MIN_ALPHA,
              max_alpha=common.MAX_ALPHA, tol=1e-4, stats=None):
    """Brent on the Gamma shape (pllmod_algo_opt_alpha /
    opt_onedim_treeinfo ALPHA)."""
    return _opt_onedim(treeinfo, _BRENT_FAMILIES["alpha"],
                       lambda i, p: float(p.alpha), min_alpha, max_alpha,
                       PARAM_ALPHA, tol, "alpha", stats=stats)


def opt_pinv(treeinfo, min_pinv=1e-9, max_pinv=common.MAX_PINV, tol=1e-4,
             stats=None):
    """Brent on the proportion of invariant sites (opt_onedim_treeinfo
    PINV)."""
    return _opt_onedim(treeinfo, _BRENT_FAMILIES["pinv"],
                       lambda i, p: max(float(p.pinv_mix()), 0.02),
                       min_pinv, max_pinv, PARAM_PINV, tol, "pinv",
                       stats=stats)


def opt_brlen_scalers(treeinfo, min_scaler=1e-3, max_scaler=100.0,
                      tol=1e-4, stats=None):
    """Brent on per-partition branch-length scalers (SCALED mode;
    pllmod_algo_opt_brlen_scalers_treeinfo, pllmod_algorithm.c:855-941),
    followed by normalization."""
    if treeinfo.brlen_linkage != BRLEN_SCALED:
        return treeinfo.compute_loglh()
    found = []
    total = _opt_onedim(
        treeinfo, _BRENT_FAMILIES["scaler"],
        lambda i, p: float(treeinfo.brlen_scalers[i]), min_scaler,
        max_scaler, PARAM_BRANCH_LEN_SCALER, tol, "scaler",
        brl_of=lambda i: treeinfo.tree.lengths, collect_x=found,
        stats=stats)
    for i, x in found:
        treeinfo.brlen_scalers[i] = x
    treeinfo.normalize_brlen_scalers()
    return total


def opt_onedim_custom(treeinfo, make_partition, get_x0, xmin, xmax,
                      mask_bit=None, tol=1e-4, stats=None):
    """Generic one-dimensional treeinfo optimization with user callbacks
    (pllmod_algo_opt_onedim_treeinfo_custom, pllmod_algorithm.c:803-853):
    ``make_partition(partition, x) -> partition`` writes the scalar,
    ``get_x0(partition) -> x`` reads the start. ``mask_bit=None``
    optimizes every local partition. Returns the total logL."""
    return _opt_onedim(treeinfo,
                       lambda p, b, x: (make_partition(p, x), b),
                       lambda i, p: float(get_x0(p)), xmin, xmax, mask_bit,
                       tol, "custom", stats=stats)


# ---------------------------------------------------------------------------
# the gradient families (L-BFGS)
# ---------------------------------------------------------------------------
def _run_lanes(treeinfo, family, sel, lanes, max_iters, tol, stats):
    """Run the lanes of the partitions ``sel`` and store each result.
    Returns the summed logL."""
    results = _lbfgsb_lanes(family, lanes, max_iters=max_iters, pgtol=tol,
                            stats=stats)
    total = 0.0
    for i, ln, (x, fv, _) in zip(sel, lanes, results):
        with torch.no_grad():
            treeinfo.partitions[i] = ln.build(torch.as_tensor(
                x, dtype=torch.float64, device=ln.brl.device))
        treeinfo.partition_loglh[i] = -float(fv)
        total += -float(fv)
    return total


def opt_alpha_pinv(treeinfo, tol=1e-4, stats=None):
    """2-D L-BFGS on (alpha, pinv) jointly (pllmod_algo_opt_alpha_pinv,
    pllmod_algorithm.c:296-342, :1313-1432), the selected partitions as
    lock-step lanes."""
    sel = _select(treeinfo, PARAM_ALPHA | PARAM_PINV, both=True)
    if not sel:
        return 0.0
    lanes = []
    for i in sel:
        part = treeinfo.partitions[i]
        lanes.append(_Lane(
            x0=np.array([float(part.alpha),
                         max(float(part.pinv_mix()), 0.02)]),
            lo=np.array([common.MIN_ALPHA, 1e-9]),
            hi=np.array([common.MAX_ALPHA, common.MAX_PINV]),
            build=lambda x, p=part: eg.with_alpha_pinv(p, x),
            brl=_brl_tensor(treeinfo, i), et=_edge_tables(treeinfo, i)))
    return _run_lanes(treeinfo, "alpha_pinv", sel, lanes, 100, tol, stats)


def opt_subst_rates(treeinfo, symmetries=None,
                    min_rate=common.MIN_SUBST_RATE,
                    max_rate=common.MAX_SUBST_RATE, tol=1e-4, stats=None):
    """Optimize exchangeability rates per partition with symmetry-class
    packing (pllmod_algo_opt_subst_rates_treeinfo,
    pllmod_algorithm.c:944-1135). ``symmetries``: optional per-partition
    rate-symmetry vectors (None entries = all-free GTR;
    ``SubstModel.rate_sym`` fits)."""
    sel, lanes = [], []
    for i in _select(treeinfo, PARAM_SUBST_RATES):
        part = treeinfo.partitions[i]
        sym = None if symmetries is None else symmetries[i]
        remap, pinned, k, x0 = eg.rate_classes(part, sym)
        if k < 2:
            continue

        def build(x, p=part, r=remap, pn=pinned):
            return eg.with_rates(p, eg.expand_sym(x, r, pn))
        lanes.append(_Lane(
            x0=np.clip(x0, min_rate, max_rate), lo=np.full(k - 1, min_rate),
            hi=np.full(k - 1, max_rate), build=build,
            brl=_brl_tensor(treeinfo, i), et=_edge_tables(treeinfo, i)))
        sel.append(i)
    if not sel:
        return 0.0
    return _run_lanes(treeinfo, "rates", sel, lanes, 200, tol, stats)


def opt_frequencies(treeinfo, min_freq=common.MIN_FREQ, tol=1e-4,
                    stats=None):
    """Optimize stationary frequencies as ratios to the last state
    (pllmod_algo_opt_frequencies_treeinfo, pllmod_algorithm.c:1137-1311),
    the selected partitions as lock-step lanes."""
    sel = _select(treeinfo, PARAM_FREQUENCIES)
    if not sel:
        return 0.0
    lanes = []
    for i in sel:
        part = treeinfo.partitions[i]
        s = part.states
        cur = part.freqs[0].detach().cpu().double().numpy()
        lanes.append(_Lane(
            x0=np.clip(cur[:-1] / cur[-1], min_freq, common.MAX_FREQ),
            lo=np.full(s - 1, min_freq), hi=np.full(s - 1, common.MAX_FREQ),
            build=lambda x, p=part: eg.with_freq_ratios(p, x),
            brl=_brl_tensor(treeinfo, i), et=_edge_tables(treeinfo, i)))
    return _run_lanes(treeinfo, "freqs", sel, lanes, 200, tol, stats)


# ---------------------------------------------------------------------------
# free rates + weights (EM + L-BFGS, renormalization into brlens)
# ---------------------------------------------------------------------------
def site_cat_likelihood(part, tree, brlens, tables=None):
    """Per-site per-category scaled likelihood [P, C] and log2 scaler [P]
    at the traversal's root edge, for the EM E-step: float32 takes the
    two root-side CLVs from kernel 2's walk over the tree's op table
    (``tables``: that table's ``fused.compile_fused`` on the
    partition's device, when the caller has it), float64 the serial
    engine."""
    P = part.prob_matrices(brlens)
    if engine_mod.use_fast_kernel(part):
        idx8, e1, e2, (u, v, e), n_slots = (
            tables or fused_mod.compile_fused(part, tree))
        clvs, scalers = fused_mod.fused_walk(
            idx8, fused_mod.gather_pairs(P, e1, e2), part.tip_states,
            fused_mod.code_table(part), n_slots)
        refs = torch.as_tensor([u, v], dtype=torch.int64, device=part.device)
        clv, sc = eg.gather_csp(part, clvs, scalers, refs)
    else:
        ops, (u, v, e) = tree.traversal_ops()
        clvs, scalers = clv_mod.update_partials(part, P, ops)
        clv, sc = eg.gather_std(part, clvs, scalers,
                              torch.as_tensor([u, v], device=part.device))
    right = torch.matmul(P[e].to(clv.dtype), clv[1])               # [C,S,P]
    per_cat = eg.root_per_cat(clv[0], part.freqs_per_cat().to(clv.dtype),
                              right)                               # [C, P]
    return per_cat.T, sc[0] + sc[1]


def opt_rates_weights(treeinfo, min_rate=common.MIN_RATE,
                      max_rate=common.MAX_RATE, tol=1e-4,
                      max_rounds: int = 10, stats=None):
    """Free-rate model: alternate EM on category weights and L-BFGS on
    category rates until converged, then renormalize so Σ wᵢrᵢ = 1 and
    push the factor into branch lengths
    (pllmod_algo_opt_rates_weights_treeinfo, pllmod_algorithm.c:1434-1840).

    Rounds are round-major across partitions: every round runs the
    unconverged partitions as lanes (one EM each, one lock-step L-BFGS,
    one convergence evaluation each through the partition's evaluator).
    A sharded partition's E-step runs on every shard, and the EM's
    per-category sums are reduced over the shards.
    Each lane reads its branch lengths at entry; under UNLINKED linkage
    its factor goes into that partition's own lengths only."""
    lanes = []
    for i in _select(treeinfo, PARAM_FREE_RATES | PARAM_RATE_WEIGHTS):
        mask = treeinfo.params_to_optimize[i]
        part = treeinfo.partitions[i]
        cats = part.rate_cats.detach().cpu().double().numpy()
        if (mask & PARAM_FREE_RATES) and part.n_cats > 1 and \
                np.allclose(cats, cats[0]):
            # all-equal rates are a symmetric saddle (every category sees
            # the same gradient): seed from a gamma(1) discretization, as
            # RAxML-NG initializes +R models from +G quantiles
            init = gamma_mod.compute_gamma_cats_host(1.0, part.n_cats,
                                                     part.gamma_mode)
            part = part.replace(rate_cats=torch.as_tensor(
                init, dtype=part.dtype, device=part.device))
        lanes.append(dict(i=i, part=part, mask=mask,
                          brl=_brl_tensor(treeinfo, i),
                          ev=_evaluator(treeinfo, i), prev=-np.inf,
                          active=True))
    if not lanes:
        return 0.0
    for _ in range(max_rounds):
        act = [st for st in lanes if st["active"]]
        if not act:
            break
        for st in act:
            if st["mask"] & PARAM_RATE_WEIGHTS:
                _count(stats, "rates_weights", "em_steps")
                with torch.no_grad():
                    part = st["part"]
                    shards = shards_of(part)
                    tabs = [None] * len(shards)
                    if engine_mod.use_fast_kernel(part):
                        # kernel 2's table compiled once for every shard
                        idx8, e1, e2, ri, ns = fused_mod.compile_fused(
                            shards[0], treeinfo.tree)
                        tabs = [(*t, ri, ns) for t in
                                per_shard((idx8, e1, e2), shards)]
                    w = em_rates_weights(
                        [site_cat_likelihood(s, treeinfo.tree, st["brl"],
                                             t)[0].to("cpu", torch.float64)
                         for s, t in zip(shards, tabs)],
                        [s.pattern_weights.to("cpu", torch.float64)
                         for s in shards],
                        part.rate_weights.to("cpu", torch.float64))
                st["part"] = part.replace(
                    rate_weights=w.to(part.device, part.dtype))
        lb = [st for st in act if st["mask"] & PARAM_FREE_RATES]
        if lb:
            lb_lanes = [_Lane(
                x0=st["part"].rate_cats.detach().cpu().double().numpy(),
                lo=np.full(st["part"].n_cats, min_rate),
                hi=np.full(st["part"].n_cats, max_rate),
                build=lambda x, p=st["part"]: eg.with_cats(p, x),
                brl=st["brl"], et=_edge_tables(treeinfo, st["i"]))
                for st in lb]
            results = _lbfgsb_lanes("rates_weights", lb_lanes,
                                    max_iters=100, pgtol=tol, stats=stats)
            for st, ln, (x, _fv, _n) in zip(lb, lb_lanes, results):
                st["part"] = ln.build(torch.as_tensor(
                    x, dtype=torch.float64, device=ln.brl.device))
        # the convergence evaluation: one copy for all lanes
        with torch.no_grad():
            lnls = torch.stack([st["ev"](st["part"], st["brl"]).to(
                torch.float64) for st in act]).cpu().numpy()
        for st, lnl in zip(act, lnls):
            if abs(float(lnl) - st["prev"]) < tol:
                st["active"] = False
            st["prev"] = float(lnl)
    total = 0.0
    for st in lanes:
        i, part = st["i"], st["part"]
        # renormalize: Σ w r = 1, the factor goes into branch lengths
        factor = float(part.rate_weights.double()
                       @ part.rate_cats.double())
        part = part.replace(rate_cats=part.rate_cats / factor)
        if treeinfo.brlen_linkage == BRLEN_UNLINKED:
            treeinfo.brlens[i] *= factor
        else:
            treeinfo.tree.lengths = treeinfo.tree.lengths * factor
            if treeinfo.brlens is not None:
                treeinfo.brlens[i] *= factor
        with torch.no_grad():
            lnl = float(st["ev"](part, _brl_tensor(treeinfo, i)))
        treeinfo.partitions[i] = part
        treeinfo.partition_loglh[i] = lnl
        total += lnl
    return total


def opt_brlen(treeinfo, **kwargs):
    """Branch-length optimization (pllmod_algo_opt_brlen_treeinfo,
    pllmod_algorithm.c:1842-1870): the batched Newton BLO."""
    return blo_mod.optimize_branch_lengths_treeinfo(treeinfo, **kwargs)


def opt_model(treeinfo, symmetries=None, tol=1e-4, blo_kwargs=None,
              stats=None):
    """Optimize all flagged parameters once, in the reference's order
    (a RAxML-NG round: rates, freqs, alpha(+pinv), free rates/weights,
    brlen scalers, branches). Returns the final total logL.

    Two guards, both reference semantics:

    - **Rate-model arbitration**: ALPHA and FREE_RATES/RATE_WEIGHTS are
      exclusive (+G against +R); each partition follows its declared
      model — finite ``alpha`` ⇒ gamma (free-rate bits dropped), NaN
      ``alpha`` ⇒ free rates (alpha bit dropped).
    - **Rollback on worse** per family: a family whose result lowers the
      total logL (``compute_loglh``) is reverted — partitions, lengths,
      per-partition lengths and scalers restored.

    ``stats``: optional dict, filled by family (module docstring), with
    each family's host ``seconds`` (its call and its ``compute_loglh``)."""
    import time
    masks = list(treeinfo.params_to_optimize)
    eff = list(masks)
    for i in treeinfo.local_indices():
        if bool(torch.isnan(treeinfo.partitions[i].alpha.detach()).item()):
            eff[i] = eff[i] & ~PARAM_ALPHA
        else:
            eff[i] = eff[i] & ~(PARAM_FREE_RATES | PARAM_RATE_WEIGHTS)
    treeinfo.params_to_optimize = eff

    def any_has(bit):
        return any(eff[i] & bit for i in treeinfo.local_indices())

    lnl = None

    def guarded(name, step):
        nonlocal lnl
        if lnl is None:
            lnl = treeinfo.compute_loglh()
        snap = (list(treeinfo.partitions), treeinfo.tree.lengths.copy(),
                None if treeinfo.brlens is None else treeinfo.brlens.copy(),
                treeinfo.brlen_scalers.copy())
        t0 = time.perf_counter()
        step()
        new = treeinfo.compute_loglh()
        _count(stats, name, "seconds", time.perf_counter() - t0)
        if new < lnl - 1e-9 * abs(lnl):
            treeinfo.partitions = snap[0]
            treeinfo.tree.lengths = snap[1]
            treeinfo.brlens = snap[2]
            treeinfo.brlen_scalers = snap[3]
            return
        lnl = new

    try:
        if any_has(PARAM_SUBST_RATES):
            guarded("rates", lambda: opt_subst_rates(
                treeinfo, symmetries=symmetries, tol=tol, stats=stats))
        if any_has(PARAM_FREQUENCIES):
            guarded("freqs", lambda: opt_frequencies(treeinfo, tol=tol,
                                                     stats=stats))
        both = PARAM_ALPHA | PARAM_PINV
        if any(eff[i] & both == both for i in treeinfo.local_indices()):
            guarded("alpha_pinv", lambda: opt_alpha_pinv(treeinfo, tol=tol,
                                                         stats=stats))
        else:
            if any_has(PARAM_ALPHA):
                guarded("alpha", lambda: opt_alpha(treeinfo, tol=tol,
                                                   stats=stats))
            if any_has(PARAM_PINV):
                guarded("pinv", lambda: opt_pinv(treeinfo, tol=tol,
                                                 stats=stats))
        if any_has(PARAM_FREE_RATES) or any_has(PARAM_RATE_WEIGHTS):
            guarded("rates_weights", lambda: opt_rates_weights(
                treeinfo, tol=tol, stats=stats))
        if any_has(PARAM_BRANCH_LEN_SCALER):
            guarded("scaler", lambda: opt_brlen_scalers(treeinfo, tol=tol,
                                                        stats=stats))
        if any_has(PARAM_BRANCHES_ITERATIVE):
            guarded("brlen", lambda: opt_brlen(treeinfo,
                                               **(blo_kwargs or {})))
    finally:
        treeinfo.params_to_optimize = masks
    return treeinfo.compute_loglh() if lnl is None else lnl
