"""Model-parameter gradients by edge decomposition, and the parameter
packings they differentiate — the (value, grad) of the port's L-BFGS
families (``algorithm/opt_model.py``) and of
``optimize/params.py``'s ``optimize_multidim``.

The likelihood is multilinear in the per-edge transition matrices
{P_e}: each edge's P appears once in every site's pruning product (the
identity behind the reference's sumtable derivatives,
pll_optimize.c:1223-1287). So

    dlogL/dθ = Σ_e ⟨∂logL/∂P_e |_(CLVs fixed), dP_e/dθ⟩
               + ∂logL/∂(root freqs, p-inv, weights) · d(...)/dθ,

and the gradient needs only the directed CLVs facing every edge (primal
data, computed without autograd: kernel 2's directed walk for float32,
``blo``'s serial-engine path for float64) and autograd through the small
map θ → P [E, C, S, S] and the root reduction at one designated edge e0.
With per-edge logLs lnl_e(θ) against constant CLVs,

    h(θ) = lnl_e0(θ, root factors) + Σ_{e≠e0} [lnl_e(θ) − sg(lnl_e(θ))]

has the value of the tree logL through e0 (every bracket is 0) and the
gradient of the tree logL (sg = ``detach``). The JAX package's
autodiff-through-the-scan objectives (``_neg_*_fn`` of its
``opt_model``) compute the same quantities; the port's serial scan
writes its CLVs in place and cannot be differentiated, so the
decomposition is the port's only gradient.

The packings (``with_*``, :func:`expand_sym`, :func:`rate_classes`) map
a float64 parameter vector onto a partition differentiably: symmetry
classes of the rates with the last rate's class pinned to 1, frequencies
as ratios to the last state, (alpha, p-inv), free category rates.

Under a site mesh (a sharded partition) the decomposition runs on every
shard, on its device, and the shards' values are reduced
(``engine.reduce_shards``); autograd carries the gradient back through
the cross-device copies to the parameters on the first device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pllmod_tpu_torch import profile
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops.engine import reduce_shards
from pllmod_tpu_torch.optimize import blo as blo_mod
from pllmod_tpu_torch.parallel.sharding import is_sharded


@dataclasses.dataclass
class EdgeTables:
    """The per-(topology, partition shape) tables of the decomposition:
    the directed traversal's tables (``blo._Tables``: kernel 2's for
    float32, the serial engine's for float64), the directed-CLV
    references facing each live edge on its root side and on its subtree
    side, and the live edge ids; the designated edge e0 is ``edges[0]``."""
    tabs: object
    edges: torch.Tensor      # long [E] live edge ids
    ref_root: torch.Tensor   # long [E] the CLV facing each edge, root side
    ref_sub: torch.Tensor    # long [E] the CLV facing it, subtree side
    shards: list | None = None


def edge_tables(partition, tree) -> EdgeTables:
    """:class:`EdgeTables` of ``tree`` for ``partition``. An edge's root
    side is its endpoint nearer the traversal's root tip 0 (BFS depth).
    A sharded partition: ``shards[k]`` are shard k's tables (shard 0's
    compiled, the others' copied by ``blo.tables_for``).

    The root-frequency factor must ride the root side of every edge's
    contraction: both sides give the same value by reversibility
    (π_i P_ij = π_j P_ji), but their ∂/∂P_e are transposes of each
    other, and frequency tangents leave the π-reversible family — only
    the root-sided form's partial equals the fixed-rooting ∂logL/∂P_e
    (libpll folds the frequencies into the parent side of its
    sumtables, pll.c core_update_sumtable)."""
    if is_sharded(partition):
        first = edge_tables(partition.shards[0], tree)
        per = [first] + [EdgeTables(
            tabs=blo_mod.tables_for(first.tabs, s),
            edges=first.edges.to(s.device),
            ref_root=first.ref_root.to(s.device),
            ref_sub=first.ref_sub.to(s.device))
            for s in partition.shards[1:]]
        return dataclasses.replace(first, shards=per)
    trav = blo_mod.DirectedTraversal(tree)
    tabs = blo_mod._compile_tables(partition, trav, derivs=False)
    adj = tree.adjacency()
    depth = np.full(tree.n_nodes, -1, np.int64)
    depth[0] = 0
    stack = [0]
    while stack:
        node = stack.pop()
        for nbr, _e in adj[node]:
            if depth[nbr] < 0:
                depth[nbr] = depth[node] + 1
                stack.append(nbr)
    live = np.nonzero(trav.edge_mask)[0]
    en = np.asarray(tree.edge_nodes, np.int64)[live]
    swap = depth[en[:, 1]] < depth[en[:, 0]]
    ref = np.asarray(trav.edge_ref, np.int64)[live]
    dev = partition.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    return EdgeTables(tabs=tabs, edges=t(live),
                      ref_root=t(np.where(swap, ref[:, 1], ref[:, 0])),
                      ref_sub=t(np.where(swap, ref[:, 0], ref[:, 1])))


def gather_csp(partition, clvs, scalers, refs):
    """The CLVs [K, C, S, P] and scalers [K, P] of the node references
    ``refs`` (tips through the code table) from kernel 2's buffers
    ([n_slots, C·S, P] / [n_slots, 1, P])."""
    C, S, Ppad = partition.n_cats, partition.states, \
        partition.n_patterns_padded
    is_tip = refs < partition.n_tips
    out = torch.empty((len(refs), C, S, Ppad), dtype=clvs.dtype,
                      device=clvs.device)
    sc = torch.zeros((len(refs), Ppad), dtype=torch.int32,
                     device=clvs.device)
    slot = refs[~is_tip] - partition.n_tips
    out[~is_tip] = clvs[slot].view(-1, C, S, Ppad)
    sc[~is_tip] = scalers[slot, 0]
    tip = partition.code_clv[partition.tip_states[refs[is_tip]].long()]
    out[is_tip] = tip.to(clvs.dtype).transpose(1, 2)[:, None]
    return out, sc


def gather_std(partition, clvs, scalers, refs):
    """As :func:`gather_csp` from the serial engine's [n, P, C, S]."""
    clv, sc = clv_mod.gather_node_clvs(partition, clvs, scalers, refs)
    return clv.permute(0, 2, 3, 1), sc


def root_per_cat(clv_root, freqs_per_cat, right):
    """Σ_s clv_root[.., c, s, p] · f[c, s] · right[.., c, s, p]: the
    per-category site likelihood [.., C, P] of an edge whose root-side
    CLV is ``clv_root`` and whose subtree side, moved across the edge,
    is ``right`` = P_e · clv_sub ([.., C, S, P] each)."""
    return (clv_root * freqs_per_cat[:, :, None] * right).sum(-2)


@profile.spanned("pllmod.blo.walk")
def directed_clvs(partition, tabs, brlens=None, P=None):
    """The directed CLVs of the tables ``tabs`` (``blo._compile_tables``
    or ``blo.walk_tables``) at the lengths ``brlens`` (a tensor indexed
    by the rows' edge ids) or at the P-matrices ``P`` [E, C, S, S]:
    kernel 2's walk for a float32 partition, the serial engine for
    float64 (a buffer of ``tabs.n_slots`` + 1 slots when the tables fix
    it). Returns (clvs, scalers, gather), ``gather`` the matching one of
    :func:`gather_csp` / :func:`gather_std`. Each call is the span
    ``pllmod.blo.walk``."""
    if tabs.kernel:
        clvs, scalers = blo_mod._directed_clvs(partition, tabs, brlens, P=P)
        return clvs, scalers, gather_csp
    if P is None:
        P = partition.prob_matrices(brlens)
    init_clvs = init_scalers = None
    if tabs.n_slots:
        Ppad, C, S = (partition.n_patterns_padded, partition.n_cats,
                      partition.states)
        init_clvs = torch.zeros((tabs.n_slots + 1, Ppad, C, S),
                                dtype=partition.dtype, device=partition.device)
        init_scalers = torch.zeros((tabs.n_slots + 1, Ppad),
                                   dtype=torch.int32, device=partition.device)
    clvs, scalers = clv_mod.update_partials(partition, P, tabs.ops,
                                            init_clvs, init_scalers)
    return clvs, scalers, gather_std


def _directed_side_clvs(partition, P, et: EdgeTables):
    """The root-side and subtree-side CLVs of every live edge
    ([E, C, S, P] each) and their summed scalers [E, P], at the
    P-matrices ``P`` (no autograd)."""
    clvs, scalers, gather = directed_clvs(partition, et.tabs, P=P)
    clvR, sR = gather(partition, clvs, scalers, et.ref_root)
    clvS, sS = gather(partition, clvs, scalers, et.ref_sub)
    return clvR, clvS, sR + sS


def _weighted_sum(partition, site_lnl):
    """Σ_p w_p lnl[..., p], summed in float64."""
    return site_lnl.to(torch.float64) @ partition.pattern_weights.to(
        torch.float64)


def edge_decomp_neg_loglh(p_theta, brlens, et: EdgeTables):
    """−logL(θ) of ``p_theta`` at ``brlens`` (a tensor that may require
    grad) with the edge-decomposition gradient (module docstring): the
    value is the logL through the designated edge, the gradient that of
    the tree logL in every parameter of ``p_theta`` and in ``brlens``.
    A 0-dim float64 tensor; for a sharded ``p_theta`` the shards' values
    reduced on its first device."""
    if et.shards is not None:
        return reduce_shards([edge_decomp_neg_loglh(s, brlens, e)
                              for s, e in zip(p_theta.shards, et.shards)],
                             p_theta.device)
    P_theta = p_theta.prob_matrices(brlens)                 # [E_all,C,S,S]
    p_const = detached(p_theta)
    with torch.no_grad():
        clvR, clvS, sc = _directed_side_clvs(p_const, P_theta.detach(), et)
    P_e = P_theta[et.edges]                                 # [E, C, S, S]
    right = torch.matmul(P_e, clvS)                         # [E, C, S, P]
    per_cat = root_per_cat(clvR, p_const.freqs_per_cat().to(clvR.dtype),
                           right)                           # [E, C, P]
    site = lk_mod._site_lnl(p_const, per_cat.transpose(1, 2), sc)
    lnl_e = _weighted_sum(p_const, site)                    # [E]
    grad_only = (lnl_e - lnl_e.detach())[1:].sum()
    # the designated edge: full θ-dependence, P_e0 and the root factors
    per_cat0 = root_per_cat(clvR[0], p_theta.freqs_per_cat().to(clvR.dtype),
                            right[0])                       # [C, P]
    lnl0 = _weighted_sum(p_const, lk_mod._site_lnl(p_theta, per_cat0.T,
                                                   sc[0]))
    return -(lnl0 + grad_only)


def detached(part):
    """The partition with every tensor detached (the decomposition's
    constant copy)."""
    return part.replace(**{
        f.name: getattr(part, f.name).detach()
        for f in dataclasses.fields(part) if f.init
        and isinstance(getattr(part, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# parameter packings
# ---------------------------------------------------------------------------
def rate_classes(part, sym):
    """(remap long tensor, pinned class, class count, x0 numpy) of the
    symmetry classes ``sym`` (None: all-free GTR)."""
    n_rates = part.states * (part.states - 1) // 2
    sym = np.arange(n_rates) if sym is None else np.asarray(sym)
    uniq, remap = np.unique(sym, return_inverse=True)
    pinned, k = int(remap[-1]), len(uniq)
    cur = part.subst_rates[0].detach().cpu().double().numpy()
    first = np.array([np.nonzero(remap == c)[0][0] for c in range(k)])
    x0 = np.delete(cur[first] / cur[first][pinned], pinned)
    remap_t = torch.as_tensor(remap, dtype=torch.int64, device=part.device)
    return remap_t, pinned, k, x0


def expand_sym(free, remap, pinned: int):
    """Symmetry-class free params -> full rate vector (pinned class = 1)."""
    ones = torch.ones(1, dtype=free.dtype, device=free.device)
    return torch.cat([free[:pinned], ones, free[pinned:]])[remap]


def rows(v, like):
    """``v`` [n] (or 0-dim) in ``like``'s dtype, one row per rate
    matrix: ``like``'s shape."""
    return v.to(like.dtype).expand(like.shape).contiguous()


def with_rates(part, full):
    return part.with_model_params(subst_rates=rows(full, part.subst_rates))


def with_freq_ratios(part, ratios):
    raw = torch.cat([ratios, torch.ones(1, dtype=ratios.dtype,
                                        device=ratios.device)])
    return part.with_model_params(freqs=rows(raw / raw.sum(), part.freqs))


def with_alpha_pinv(part, x):
    return part.with_alpha(x[0]).replace(
        prop_invar=rows(x[1], part.prop_invar))


def with_cats(part, r):
    return part.replace(rate_cats=r.to(part.dtype))
