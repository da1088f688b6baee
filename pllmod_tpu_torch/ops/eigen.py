"""GTR-family rate matrices, eigendecomposition, transition probabilities.

PyTorch counterpart of ``pllmod_tpu.ops.eigen`` — libpll's
``pll_update_prob_matrices``: build the reversible rate matrix Q from
exchangeability rates + stationary frequencies, eigendecompose it once per
rate matrix, then produce P(t) = V · exp(Λ · t · r_c / (1 - p_inv)) · V⁻¹
for all edges and rate categories in one batched computation.

Reversible Q is symmetrized as B = D^{1/2} Q D^{-1/2} (D = diag(π)) so
that ``torch.linalg.eigh`` applies; non-reversible custom models use
``torch.linalg.matrix_exp``.

:func:`prob_matrices_params` builds P from the model parameters with a
derivative that stays finite where Q has repeated eigenvalues (JC, or
any equal-rates start of a rate optimization), where the backward of
``eigh`` divides by eigenvalue gaps: a ``torch.autograd.Function``
whose backward is the adjoint of the Fréchet derivative of the matrix
exponential (the JAX package's custom JVP, ``eigen.py:198-250``).
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


def matrix_to_rates(R):
    """Upper-triangle rate vector ``[..., S(S-1)/2]`` of symmetric
    matrices ``[..., S, S]`` (the inverse of :func:`rates_to_matrix`)."""
    S = R.shape[-1]
    iu = torch.triu_indices(S, S, offset=1, device=R.device)
    return R[..., iu[0], iu[1]]


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


def prob_matrices_expm(rates, freqs, brlens, rate_cats, prop_invar=0.0):
    """P-matrices [E, C, S, S] of one (possibly non-reversible) rate
    matrix by matrix exponentials."""
    Q = build_q(rates, torch.clamp(freqs, min=_FREQ_FLOOR))
    scale = rate_cats / (1.0 - torch.as_tensor(prop_invar, dtype=Q.dtype,
                                               device=Q.device))
    t = brlens.to(Q.dtype)[:, None] * scale[None, :]
    return torch.linalg.matrix_exp(Q * t[:, :, None, None])


def _dexp_divided_difference(a):
    """F_ij for the Fréchet derivative of exp at diag(a) (last axis S):
    (e^{a_i} − e^{a_j}) / (a_i − a_j), e^{a_i} on the diagonal, as
    e^{(a_i+a_j)/2} · sinh(x)/x with x = (a_i − a_j)/2 — symmetric and
    finite at equal eigenvalues."""
    ai = a[..., :, None]
    aj = a[..., None, :]
    x = 0.5 * (ai - aj)
    mid = torch.exp(0.5 * (ai + aj))
    small = x.abs() < 1e-6
    xs = torch.where(small, torch.ones_like(x), x)
    sinhc = torch.where(small, 1.0 + x * x / 6.0, torch.sinh(xs) / xs)
    return mid * sinhc


class _ProbMatricesParams(torch.autograd.Function):
    """(rates [M,R], freqs [M,S], brlens [E], rate_cats [C],
    param_indices [C], prop_invar [M]) -> P [E,C,S,S], computed in
    float64 and returned in the rates' dtype. The eigendecomposition
    and Q are built on the host (M small matrices, as
    ``Partition.cache_eigen`` does), the P-matrices and the adjoint's
    products on the inputs' device.

    With P = V e^{a} V⁻¹ (a = λt, t_ec = b_e r_c / (1 − p_c)), the
    derivative is dP = V (F ∘ V⁻¹ E V) V⁻¹, E = dQ·t + Q·dt. Its adjoint
    takes a cotangent G of P to Ē = V⁻ᵀ (F ∘ Vᵀ G V⁻ᵀ) Vᵀ, then
    Q̄_c = Σ_e t_ec Ē_ec (summed over the categories of each matrix) and
    t̄_ec = ⟨Q_c, Ē_ec⟩; Q̄ reaches the rates and frequencies through
    :func:`build_q` by autograd."""

    @staticmethod
    def forward(ctx, rates_m, freqs_m, brlens, rate_cats, param_indices,
                prop_invar):
        f64, dev = torch.float64, brlens.device
        r = rates_m.detach().to("cpu", f64)
        f = freqs_m.detach().to("cpu", f64)
        lam, V, Vinv = (x.to(dev) for x in eigen_reversible(r, f))
        b, rc = brlens.detach().to(f64), rate_cats.detach().to(f64)
        pinv = prop_invar.detach().to(f64)
        pi = param_indices
        t = b[:, None] * (rc / (1.0 - pinv[pi]))[None, :]          # [E,C]
        P = _propagate(torch.exp(lam[pi][None] * t[:, :, None]),
                       V[pi], Vinv[pi])
        ctx.save_for_backward(b, rc, pinv, lam, V, Vinv)
        ctx.host = (r, f)
        ctx.param_indices = pi
        ctx.dtypes = tuple(x.dtype for x in (rates_m, freqs_m, brlens,
                                             rate_cats, prop_invar))
        return P.to(rates_m.dtype)

    @staticmethod
    def backward(ctx, grad):
        b, rc, pinv, lam, V, Vinv = ctx.saved_tensors
        r, f = ctx.host
        pi = ctx.param_indices
        pinv_c = pinv[pi]
        rcs = rc / (1.0 - pinv_c)
        t = b[:, None] * rcs[None, :]
        V_c, Vinv_c = V[pi], Vinv[pi]
        F = _dexp_divided_difference(lam[pi][None] * t[:, :, None])
        W = F * torch.einsum("cik,ecij,clj->eckl", V_c,
                             grad.to(torch.float64), Vinv_c)
        Ebar = torch.einsum("cki,eckl,cjl->ecij", Vinv_c, W, V_c)
        with torch.enable_grad():
            rg = r.clone().requires_grad_(True)
            fg = f.clone().requires_grad_(True)
            Q = build_q(rg, torch.clamp(fg, min=_FREQ_FLOOR))     # [M,S,S]
            Q_c = Q.detach().to(b.device)[pi]
            Qbar_c = torch.einsum("ec,ecij->cij", t, Ebar).cpu()
            Qbar = torch.zeros_like(Q).index_add_(0, pi.cpu(), Qbar_c)
            gr, gf = torch.autograd.grad(Q, (rg, fg), Qbar)
        tbar = torch.einsum("cij,ecij->ec", Q_c, Ebar)              # [E,C]
        rcs_bar = tbar.T @ b                                        # [C]
        gpinv = torch.zeros_like(pinv).index_add_(
            0, pi, rcs_bar * rc / (1.0 - pinv_c) ** 2)
        grads = (gr, gf, tbar @ rcs, rcs_bar / (1.0 - pinv_c), gpinv)
        dev = b.device
        gr, gf, gb, grc, gpinv = (g.to(dev, dt)
                                  for g, dt in zip(grads, ctx.dtypes))
        return gr, gf, gb, grc, None, gpinv


def prob_matrices_params(rates_m, freqs_m, brlens, rate_cats,
                         param_indices, prop_invar):
    """P-matrices [E, C, S, S] directly from the model parameters
    (reversible models), differentiable in every real argument (rates,
    freqs, brlens, rate_cats, prop_invar) with a derivative that is
    finite at degenerate spectra. Arguments as
    :func:`prob_matrices_multi`, with the parameters in place of the
    eigendecomposition; the work is done in float64 and P returned in
    the rates' dtype on the lengths' device."""
    dt = rates_m.dtype
    return _ProbMatricesParams.apply(
        rates_m, freqs_m, brlens.to(dt), rate_cats.to(dt),
        param_indices, prop_invar.to(dt))
