"""Discrete Gamma rate heterogeneity (Yang 1994) + proportion of invariant sites.

PyTorch counterpart of ``pllmod_tpu.ops.gamma`` — libpll's
``pll_compute_gamma_cats(alpha, ncats, rates, PLL_GAMMA_RATES_MEAN|MEDIAN)``.

:func:`compute_gamma_cats`, behind ``Partition.with_alpha``, is a
``torch.autograd.Function``: its forward is the host float64 scipy
discretization (:func:`compute_gamma_cats_host`, k numbers: no device
launch), and its backward differentiates the quantiles implicitly
(:func:`gamma_cats_alpha_grad`): from P(a, b_i) = p_i,
db_i/da = −∂ₐP(a, b_i) / ∂ₓP(a, b_i), with ∂ₐP summed from the series
of P term by term (:func:`dgammainc_da`). The JAX package differentiates
through its Newton iterations instead (``tests/test_torch_gradients.py``
holds the two within 1e-6).
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN


class _GammaCats(torch.autograd.Function):
    """alpha (0-dim tensor) -> the k category rates, forward on the host
    in float64, backward by :func:`gamma_cats_alpha_grad`."""

    @staticmethod
    def forward(ctx, alpha, n_cats: int, mode: int):
        a = float(alpha.detach())
        ctx.args = (a, n_cats, mode)
        return torch.as_tensor(compute_gamma_cats_host(a, n_cats, mode),
                               dtype=alpha.dtype, device=alpha.device)

    @staticmethod
    def backward(ctx, grad):
        dr = gamma_cats_alpha_grad(*ctx.args)
        g = grad.detach().to("cpu", torch.float64).numpy() @ dr
        return (torch.as_tensor(g, dtype=grad.dtype, device=grad.device),
                None, None)


def compute_gamma_cats(alpha, n_cats: int, mode: int = GAMMA_RATES_MEAN):
    """Discrete Gamma category rates with mean 1, differentiable in
    ``alpha`` (a tensor of the result's dtype and device; a number gives
    float64 on the CPU).

    mode=GAMMA_RATES_MEAN   — Yang (1994) mean-per-bin discretization
    mode=GAMMA_RATES_MEDIAN — median-per-bin, renormalized to mean 1
    """
    alpha = torch.as_tensor(alpha)
    if not alpha.is_floating_point():
        alpha = alpha.to(torch.float64)
    if n_cats == 1:
        return torch.ones(1, dtype=alpha.dtype, device=alpha.device)
    return _GammaCats.apply(alpha.reshape(()), n_cats, mode)


def dgammainc_da(a, x):
    """∂P(a, x)/∂a of the regularized lower incomplete gamma, float64
    numpy (broadcasting; a > 0, x ≥ 0), from the series
    P(a, x) = Σ_n t_n, t_n = e^{-x} x^{a+n} / Γ(a+n+1), term by term:
    ∂ₐt_n = t_n (ln x − ψ(a+n+1)). The terms peak near n = x − a and
    fall below 1e-17 of the peak within ~9√x + 40 more."""
    from scipy.special import digamma, gammaln
    a, x = np.broadcast_arrays(np.asarray(a, np.float64),
                               np.asarray(x, np.float64))
    out = np.zeros(a.shape)
    pos = x > 0
    if not pos.any():
        return out
    ap, xp = a[pos], x[pos]
    xmax = float(xp.max())
    n = np.arange(int(np.ceil(xmax + 9.0 * np.sqrt(xmax) + 40.0)))[:, None]
    lx = np.log(xp)
    t = np.exp((ap + n) * lx - xp - gammaln(ap + n + 1.0))
    out[pos] = (t * (lx - digamma(ap + n + 1.0))).sum(axis=0)
    return out


def _dgammainc_dx(a, x):
    """∂P(a, x)/∂x = x^{a−1} e^{−x} / Γ(a) (x > 0)."""
    from scipy.special import gammaln
    return np.exp((a - 1.0) * np.log(x) - x - gammaln(a))


def gamma_cats_alpha_grad(alpha: float, n_cats: int,
                          mode: int = GAMMA_RATES_MEAN) -> np.ndarray:
    """d r_i / d alpha [k] of :func:`compute_gamma_cats_host`, float64.

    The quantiles b_i = P⁻¹(a, p_i) move by db_i/da = −∂ₐP(a, b_i) /
    ∂ₓP(a, b_i). Mean mode: r_i = k [P(a+1, b_{i+1}) − P(a+1, b_i)]
    (b_0 = 0, b_k = ∞), so dr_i/da = k (D_{i+1} − D_i) with
    D_i = ∂ₐP(a+1, b_i) + ∂ₓP(a+1, b_i) db_i/da (D_0 = D_k = 0). Median
    mode: m_i = b_i / a, r = k m / Σm."""
    from scipy.special import gammaincinv as sp_gammaincinv
    a, k = float(alpha), n_cats
    if k == 1:
        return np.zeros(1)
    if mode == GAMMA_RATES_MEDIAN:
        b = sp_gammaincinv(a, (2.0 * np.arange(k) + 1.0) / (2.0 * k))
        db = -dgammainc_da(a, b) / _dgammainc_dx(a, b)
        m, dm = b / a, db / a - b / (a * a)
        tot = m.sum()
        return k * (dm * tot - m * dm.sum()) / (tot * tot)
    b = sp_gammaincinv(a, np.arange(1, k) / k)
    db = -dgammainc_da(a, b) / _dgammainc_dx(a, b)
    D = dgammainc_da(a + 1.0, b) + _dgammainc_dx(a + 1.0, b) * db
    return k * np.diff(np.concatenate([[0.0], D, [0.0]]))


def compute_gamma_cats_host(alpha, n_cats: int, mode: int = GAMMA_RATES_MEAN):
    """Host-side float64 category rates (numpy/scipy), for partition
    construction. Same discretization as :func:`compute_gamma_cats`;
    agrees to ~1e-12."""
    from scipy.special import gammainc as sp_gammainc
    from scipy.special import gammaincinv as sp_gammaincinv
    alpha = float(alpha)
    k = n_cats
    if k == 1:
        return np.ones(1)
    if mode == GAMMA_RATES_MEDIAN:
        ps = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
        med = sp_gammaincinv(alpha, ps) / alpha
        return med * (k / med.sum())
    ps = np.arange(1, k) / k
    bounds = sp_gammaincinv(alpha, ps)
    cdf_full = np.concatenate([[0.0], sp_gammainc(alpha + 1.0, bounds), [1.0]])
    return k * np.diff(cdf_full)


def invariant_sites_mask(tip_code_masks, tip_states):
    """Per-site invariant-state bitmask: AND over tips of state bitmasks
    (libpll ``pll_update_invariant_sites``). A site is potentially
    invariant iff the intersection of all tips' compatible-state sets is
    non-empty.

    Args:
      tip_code_masks: uint64 [n_codes] bitmask per tip-state code
      tip_states: int [tips, sites] code per tip per site
    Returns:
      uint64 [sites] intersection bitmask (0 = site cannot be invariant)

    The tips are reduced a block at a time, so the uint64 masks never
    stand for the whole [tips, sites] matrix (8 GB at 10,000 taxa ×
    100,000 sites).
    """
    out = np.full(tip_states.shape[1], np.iinfo(np.uint64).max, np.uint64)
    for i in range(0, tip_states.shape[0], 256):
        out &= np.bitwise_and.reduce(tip_code_masks[tip_states[i:i + 256]],
                                     axis=0)
    return out
