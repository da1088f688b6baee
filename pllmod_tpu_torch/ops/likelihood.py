"""Edge / root log-likelihood — PyTorch counterpart of
``pllmod_tpu.ops.likelihood`` (libpll's ``pll_compute_edge_loglikelihood``
and ``pll_compute_root_loglikelihood``).

The p-inv mixture is combined in log space so that it is exact under
arbitrary CLV rescaling:

    lnL_site = logaddexp( ln Σ_c w_c (1-p_c) L_c_scaled + scaler·ln2,
                          ln Σ_c w_c p_c I_c ),   I_c = Σ_{s ∈ inv set} π_c[s]
"""

from __future__ import annotations

import torch

from pllmod_tpu_torch.ops.clv import LN2, get_node_clv

_TINY = 1e-300


def _site_lnl(partition, per_cat_lk, scaler):
    """Combine scaled per-category site likelihoods with the p-inv term.

    ``per_cat_lk``: [P, C] scaled per-category likelihoods (before
    rate-weight mixing), ``scaler``: [P] int. Returns per-site logL [P].
    p-inv and frequencies are indexed per category through
    ``param_indices`` (libpll core_likelihood). The p-inv branch is taken
    on the partition's host-side flag, so no device value is read.
    """
    dtype = partition.dtype
    w = partition.rate_weights
    pinv_c = partition.pinv_per_cat()
    tiny = _TINY if dtype == torch.float64 else 1e-37
    A = per_cat_lk @ (w * (1.0 - pinv_c))
    ln_var = torch.log(torch.clamp(A, min=tiny)) + scaler.to(dtype) * LN2
    if not partition.has_pinv:
        return ln_var
    inv_pc = partition.inv_indicator @ partition.freqs_per_cat().T  # [P,C]
    B = inv_pc @ (w * pinv_c)
    ln_b = torch.where(B > 0, torch.log(torch.clamp(B, min=tiny)),
                       torch.full_like(B, -float("inf")))
    return torch.logaddexp(ln_var, ln_b)


def edge_site_likelihood(partition, clv_p, clv_c, P_edge):
    """Scaled per-site per-category likelihood across an edge:
    L[p,c] = Σ_i π_c[i] clv_p[p,c,i] Σ_j P[c,i,j] clv_c[p,c,j]."""
    right = torch.einsum("pcj,cij->pci", clv_c, P_edge)
    return torch.einsum("pci,ci,pci->pc", clv_p, partition.freqs_per_cat(),
                        right)


def weighted_total(partition, lnl, persite: bool = False):
    """Σ lnl · pattern_weights; with ``persite`` also the per-pattern
    entries (unweighted; padded patterns carry weight 0)."""
    total = torch.sum(lnl * partition.pattern_weights)
    return (total, lnl) if persite else total


def edge_loglikelihood(partition, clvs, scalers, node_p: int, node_c: int,
                       P_edge, persite: bool = False):
    """Log-likelihood across the edge (node_p, node_c); either node may be
    a tip (pll_compute_edge_loglikelihood). ``persite=True`` returns
    (total, per-pattern logL [n_patterns_padded])."""
    clv_p, s_p = get_node_clv(partition, clvs, scalers, node_p)
    clv_c, s_c = get_node_clv(partition, clvs, scalers, node_c)
    per_cat = edge_site_likelihood(partition, clv_p, clv_c, P_edge)
    lnl = _site_lnl(partition, per_cat, s_p + s_c)
    return weighted_total(partition, lnl, persite)


def root_loglikelihood(partition, clvs, scalers, node: int,
                       persite: bool = False):
    """Log-likelihood at a (root) CLV: L[p] = Σ_c w_c Σ_i π_i clv[p,c,i]
    (pll_compute_root_loglikelihood); ``persite`` as in
    :func:`edge_loglikelihood`."""
    clv, s = get_node_clv(partition, clvs, scalers, node)
    per_cat = torch.einsum("pci,ci->pc", clv, partition.freqs_per_cat())
    lnl = _site_lnl(partition, per_cat, s)
    return weighted_total(partition, lnl, persite)
