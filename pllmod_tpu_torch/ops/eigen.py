"""GTR-family rate matrices, eigendecomposition, transition probabilities.

PyTorch counterpart of ``pllmod_tpu.ops.eigen`` — libpll's
``pll_update_prob_matrices``: build the reversible rate matrix Q from
exchangeability rates + stationary frequencies, eigendecompose it once per
rate matrix, then produce P(t) = V · exp(Λ · t · r_c / (1 - p_inv)) · V⁻¹
for all edges and rate categories in one batched computation.

Reversible Q is symmetrized as B = D^{1/2} Q D^{-1/2} (D = diag(π)) so
that ``torch.linalg.eigh`` applies; non-reversible custom models use
``torch.linalg.matrix_exp``.
"""

from __future__ import annotations

import torch

_FREQ_FLOOR = 1e-16


def rates_to_matrix(rates, states: int):
    """Symmetric exchangeability matrices from upper-triangle rate vectors
    ``[..., S(S-1)/2]`` (row-major upper triangle, AC AG AT CG CT GT for
    DNA — models_dna.c:38)."""
    iu = torch.triu_indices(states, states, offset=1, device=rates.device)
    R = rates.new_zeros(rates.shape[:-1] + (states, states))
    R[..., iu[0], iu[1]] = rates
    return R + R.transpose(-1, -2)


def build_q(rates, freqs):
    """Normalized reversible rate matrices Q (batched over leading dims)
    with mean substitution rate 1:
    Q_ij = s_ij π_j (i≠j), Q_ii = -Σ_j Q_ij, scaled so Σ_i π_i (-Q_ii) = 1.
    """
    states = freqs.shape[-1]
    Q = rates_to_matrix(rates, states) * freqs[..., None, :]
    Q = Q - torch.diag_embed(Q.sum(-1))
    mean_rate = -(freqs * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / torch.clamp(mean_rate, min=_FREQ_FLOOR)[..., None, None]


def eigen_reversible(rates, freqs):
    """Eigendecomposition of reversible Q matrices via symmetrization,
    batched over leading dims (the rate matrices of a partition).

    Returns (eigenvals [..., S], eigenvecs [..., S, S], inv_eigenvecs
    [..., S, S]) with Q = eigenvecs · diag(eigenvals) · inv_eigenvecs.
    """
    pi = torch.clamp(freqs, min=_FREQ_FLOOR)
    Q = build_q(rates, pi)
    sqrt_pi = torch.sqrt(pi)
    B = Q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    B = 0.5 * (B + B.transpose(-1, -2))     # exact symmetry for eigh
    lam, U = torch.linalg.eigh(B)
    V = U / sqrt_pi[..., :, None]
    Vinv = U.transpose(-1, -2) * sqrt_pi[..., None, :]
    return lam, V, Vinv


def _propagate(expo, V_c, Vinv_c):
    """P[e,c] = V_c · diag(expo[e,c]) · Vinv_c as one batched product
    against the basis M[c,k,(i,j)] = V[c,i,k] · Vinv[c,k,j].

    expo [E, C, S] -> P [E, C, S, S]."""
    E, C, S = expo.shape
    M = torch.einsum("cik,ckj->ckij", V_c, Vinv_c).reshape(C, S, S * S)
    P = torch.einsum("eck,ckn->ecn", expo, M)
    return P.reshape(E, C, S, S)


def prob_matrices_multi(eigen, brlens, rate_cats, param_indices, prop_invar):
    """P-matrices [E, C, S, S] when rate categories may use different rate
    matrices (``param_indices`` = libpll's params_indices,
    treeinfo.c:289).

    Args:
      eigen: batched (eigenvals [M,S], eigenvecs [M,S,S],
             inv_eigenvecs [M,S,S]) over M rate matrices
      brlens: [E] branch lengths
      rate_cats: [C]; param_indices: int [C]; prop_invar: [M]
    """
    lam, V, Vinv = eigen
    dtype = V.dtype
    lam_c = lam[param_indices]
    pinv_c = prop_invar.to(dtype)[param_indices]
    t = brlens.to(dtype)[:, None] * (rate_cats.to(dtype) / (1.0 - pinv_c))
    expo = torch.exp(lam_c[None] * t[:, :, None])             # [E,C,S]
    return _propagate(expo, V[param_indices], Vinv[param_indices])


def prob_matrices_expm_multi(rates_m, freqs_m, brlens, rate_cats,
                             param_indices, prop_invar):
    """General (non-reversible-capable) P-matrices [E, C, S, S] via batched
    matrix exponentials. Same signature/semantics as
    :func:`prob_matrices_multi` with the model parameters in place of
    the eigendecomposition."""
    Q = build_q(rates_m, torch.clamp(freqs_m, min=_FREQ_FLOOR))   # [M,S,S]
    dtype = Q.dtype
    pinv_c = prop_invar.to(dtype)[param_indices]
    rc = rate_cats.to(dtype) / (1.0 - pinv_c)
    t = brlens.to(dtype)[:, None] * rc[None, :]                   # [E,C]
    return torch.linalg.matrix_exp(Q[param_indices][None]
                                   * t[:, :, None, None])
