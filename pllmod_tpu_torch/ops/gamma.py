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

The port also keeps its own regularized lower incomplete gamma on
tensors, :func:`gammainc` (the series below ``a + 1``, the Lentz
continued fraction above, as scipy and XLA's ``igamma`` do;
``torch.special.gammainc`` turns to a ~1e-9-accurate asymptotic series
above shape 20), and its inverse :func:`gammaincinv` by Newton
iterations (the Gamma quantile function has no torch op).
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN

_NEWTON_ITERS = 40
_IGAM_MAX_TERMS = 2000   # series terms / continued-fraction steps at most
_IGAM_CHECK_EVERY = 16   # convergence is read every this many steps
_TINY = 1e-300


def gammainc(a, x):
    """Regularized lower incomplete gamma P(a, x) on tensors (a > 0,
    x >= 0, broadcasting; computed in at least float64).

    For x < a + 1 the power series
    P = e^{-x} x^a / Γ(a) · Σ_n x^n / (a (a+1) ... (a+n)); otherwise
    Q = 1 - P from the modified-Lentz continued fraction (Numerical
    Recipes ``gser`` / ``gcf``). Each element stops moving once its next
    term is below the float64 epsilon of its sum."""
    a, x = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(x))
    dtype = torch.promote_types(torch.promote_types(a.dtype, x.dtype),
                                torch.float64)
    a = a.to(dtype)
    x = x.to(dtype)
    eps = torch.finfo(dtype).eps
    series = x < a + 1.0
    # log of the common prefactor e^{-x} x^a / Γ(a) (0 at x = 0)
    log_pre = torch.where(x > 0, a * torch.log(torch.clamp(x, min=_TINY))
                          - x - torch.lgamma(a),
                          torch.full_like(x, -float("inf")))

    # series, on the elements that take it (others see x = 0: one term)
    xs = torch.where(series, x, torch.zeros_like(x))
    ap = a.clone()
    term = 1.0 / a
    total = term.clone()
    # continued fraction, on the others (the series ones see x = a + 2)
    xc = torch.where(series, a + 2.0, x)
    b = xc + 1.0 - a
    c = torch.full_like(xc, 1.0 / _TINY)
    d = 1.0 / b
    h = d.clone()
    done = torch.zeros_like(series)
    for i in range(1, _IGAM_MAX_TERMS + 1):
        ap = ap + 1.0
        term = torch.where(done, term, term * xs / ap)
        total = total + torch.where(done, torch.zeros_like(term), term)
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = torch.where(d.abs() < _TINY, torch.full_like(d, _TINY), d)
        c = b + an / c
        c = torch.where(c.abs() < _TINY, torch.full_like(c, _TINY), c)
        d = 1.0 / d
        delta = d * c
        h = torch.where(done, h, h * delta)
        done = done | torch.where(series, term.abs() < total.abs() * eps,
                                  (delta - 1.0).abs() < eps)
        if i % _IGAM_CHECK_EVERY == 0 and bool(done.all()):
            break
    p_series = total * torch.exp(log_pre)
    q_cf = torch.exp(log_pre) * h
    return torch.where(series, p_series, 1.0 - q_cf)


def gammaincinv(a, p):
    """Inverse of the regularized lower incomplete gamma function P(a, x).

    Solves P(a, x) = p for x (broadcasting tensors). Wilson–Hilferty /
    small-shape initial guess refined by damped Newton steps in log
    space. Accuracy ~1e-12 in float64 over a ∈ [1e-2, 1e3], p ∈ (0, 1).
    """
    a, p = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(p))
    dtype = torch.promote_types(torch.promote_types(a.dtype, p.dtype),
                                torch.float32)
    a = a.to(dtype)
    p = p.to(dtype)
    lgam_a = torch.lgamma(a)

    # Wilson–Hilferty: x ≈ a (1 - 1/(9a) + z sqrt(1/(9a)))^3, z = Φ⁻¹(p)
    z = np.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)
    wh = a * (1.0 - 1.0 / (9.0 * a) + z * torch.sqrt(1.0 / (9.0 * a))) ** 3
    # small-a / small-p regime: P(a,x) ≈ x^a / (a Γ(a))
    small = torch.exp((torch.log(torch.clamp(p, min=1e-300))
                       + torch.lgamma(a + 1.0)) / a)
    x0 = torch.where((wh > 1e-8) & torch.isfinite(wh),
                     torch.clamp(wh, min=1e-300), small)
    x0 = torch.where(a < 0.5, small, x0)      # WH is poor for small shapes
    u = torch.log(torch.clamp(x0, min=1e-300))

    # f(x) = P(a,x) - p; iterate on u = log x with du = -f / (x f'(x))
    for _ in range(_NEWTON_ITERS):
        x = torch.exp(u)
        f = gammainc(a, x) - p
        dfdu = torch.exp(a * u - x - lgam_a)
        step = torch.clamp(f / torch.clamp(dfdu, min=1e-300), -2.0, 2.0)
        u = u - step
    return torch.exp(u)


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
