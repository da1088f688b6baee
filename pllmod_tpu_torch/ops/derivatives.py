"""Analytic branch-length derivatives via the sumtable factorization —
PyTorch counterpart of ``pllmod_tpu.ops.derivatives`` (libpll's
``pll_update_sumtable`` + ``pll_compute_likelihood_derivatives``; call
sites ``pll_optimize.c:303-314``, ``pll_optimize.c:1223-1287``).

For an edge with CLVs clv_p / clv_c and eigensystem Q = V Λ V⁻¹, the
per-site per-category likelihood across the edge is

    L(t) = Σ_k  st[k] · exp(λ_k · r_c · t)          (r_c = rate / (1-pinv))
    st[k] = (Σ_i π_i clv_p[i] V[i,k]) · (Σ_j V⁻¹[k,j] clv_c[j])

so L, dL/dt and d²L/dt² come from one table ``st`` computed once per
edge. Derivatives of the per-site *log*-likelihood: l' = L'/L,
l'' = L''/L − (L'/L)², summed over sites with the pattern weights; with
p-inv the constant mixture term joins L before the ratio, in log space.

Plain torch in any dtype, on tensors with any leading batch dimensions
(the JAX package's ``vmap`` over edges is a written batch dimension).
This is the float64 path of the branch-length optimizer and the
yardstick of the derivative kernels (:mod:`pllmod_tpu_torch.ops.deriv`).
"""

from __future__ import annotations

import torch

from pllmod_tpu_torch.ops.clv import LN2


def sumtable(partition, clv_p, clv_c, eigen=None):
    """Per-edge sumtable st[..., p, c, k] from CLVs [..., P, C, S]
    (tips already expanded); ``eigen`` = optional (lam [M,S], V [M,S,S],
    Vinv [M,S,S])."""
    if eigen is None:
        eigen = partition.eigen()
    _, V, Vinv = eigen
    pi_c = partition.freqs_per_cat()                 # [C,S]
    V_c = V[partition.param_indices]                 # [C,S,S]
    Vinv_c = Vinv[partition.param_indices]           # [C,S,S]
    # the small factors first, the order opt_einsum picks for the
    # three-operand form, without its path search on every call
    left = torch.einsum("...pci,cik->...pck", clv_p, pi_c[:, :, None] * V_c)
    right = torch.einsum("ckj,...pcj->...pck", Vinv_c, clv_c)
    return left * right


def invariant_term(partition):
    """B[p] = Σ_c w_c p_c Σ_{s ∈ inv set} π_c[s], the p-inv mixture term
    (constant in t)."""
    pinv_c = partition.pinv_per_cat()
    inv_pc = partition.inv_indicator @ partition.freqs_per_cat().T   # [P,C]
    return inv_pc @ (partition.rate_weights * pinv_c)


def edge_derivatives(partition, st, scaler, brlen, eigen=None):
    """(logL, dlogL/dt, d²logL/dt²) of edges from their sumtables.

    Args:
      st: [..., P, C, S] sumtables
      scaler: [..., P] int32 combined scaler counts of the two CLVs
      brlen: [...] branch lengths
    Returns:
      (lnl, df, ddf), each of the leading shape. Sign convention of
      libpll: df/ddf are derivatives of the POSITIVE log-likelihood.
    """
    if eigen is None:
        eigen = partition.eigen()
    dtype = partition.dtype
    pidx = partition.param_indices
    lam = eigen[0][pidx]                             # [C,S]
    pinv_c = partition.prop_invar[pidx]              # [C]
    rc = partition.rate_cats / (1.0 - pinv_c)
    lr = lam * rc[:, None]                           # [C,S] effective rates
    # A(t) = Σ_c w_c (1-p_c) L_c(t)
    w_eff = partition.rate_weights * (1.0 - pinv_c)
    t = torch.as_tensor(brlen, dtype=dtype, device=st.device)
    expo = torch.exp(lr * t[..., None, None, None])  # [...,1,C,S]
    base = st * expo                                 # [...,P,C,S]
    L = torch.einsum("...pcs,c->...p", base, w_eff)
    # (the weights folded in first, as opt_einsum's path for the
    # three-operand form does, without its search on every call)
    dL = torch.einsum("...pcs,cs->...p", base, lr * w_eff[:, None])
    ddL = torch.einsum("...pcs,cs->...p", base, (lr * lr) * w_eff[:, None])

    tiny = 1e-300 if dtype == torch.float64 else 1e-37
    Lsafe = torch.clamp(L, min=tiny)
    # p-inv mixture in log space (overflow-safe under any scaling):
    #   M(t) = A(t) 2^s + B, frac = A 2^s / M, (log M)' = frac A'/A,
    #   (log M)'' = frac A''/A - (frac A'/A)^2
    B = invariant_term(partition)
    ln_a = torch.log(Lsafe) + scaler.to(dtype) * LN2
    ln_b = torch.where(B > 0, torch.log(torch.clamp(B, min=tiny)),
                       torch.full_like(B, -float("inf")))
    site_lnl = torch.logaddexp(ln_a, ln_b)
    frac = torch.exp(ln_a - site_lnl)
    r1 = frac * dL / Lsafe
    site_ddf = frac * ddL / Lsafe - r1 * r1
    pw = partition.pattern_weights
    return ((site_lnl * pw).sum(-1), (r1 * pw).sum(-1),
            (site_ddf * pw).sum(-1))


def edge_derivatives_batch(partition, st, scaler, brlens, eigen=None):
    """:func:`edge_derivatives` over a batch of edges: st [E, P, C, S],
    scaler [E, P], brlens [E] -> (lnl, df, ddf) each [E]."""
    return edge_derivatives(partition, st, scaler, brlens, eigen)
