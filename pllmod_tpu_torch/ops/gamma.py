"""Discrete Gamma rate heterogeneity (Yang 1994) + proportion of invariant sites.

PyTorch counterpart of ``pllmod_tpu.ops.gamma`` — libpll's
``pll_compute_gamma_cats(alpha, ncats, rates, PLL_GAMMA_RATES_MEAN|MEDIAN)``.

Partition construction uses the host scipy discretization
(:func:`compute_gamma_cats_host`); :func:`compute_gamma_cats` is the
tensor version behind ``Partition.with_alpha``, built on the port's own
regularized lower incomplete gamma :func:`gammainc` (the series below
``a + 1``, the Lentz continued fraction above, as scipy and XLA's
``igamma`` do; ``torch.special.gammainc`` turns to a ~1e-9-accurate
asymptotic series above shape 20). The Gamma quantile function has no
torch op, so it is solved by Newton iterations.
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


def compute_gamma_cats(alpha, n_cats: int, mode: int = GAMMA_RATES_MEAN):
    """Discrete Gamma category rates with mean 1 (tensor version).

    mode=GAMMA_RATES_MEAN   — Yang (1994) mean-per-bin discretization
    mode=GAMMA_RATES_MEDIAN — median-per-bin, renormalized to mean 1
    """
    alpha = torch.as_tensor(alpha)
    k = n_cats
    if k == 1:
        return torch.ones(1, dtype=alpha.dtype, device=alpha.device)
    ar = torch.arange(k, dtype=alpha.dtype, device=alpha.device)
    if mode == GAMMA_RATES_MEDIAN:
        med = gammaincinv(alpha, (2.0 * ar + 1.0) / (2.0 * k)) / alpha
        return med * (k / torch.sum(med))
    # mean mode: bin boundaries at quantiles i/k of Gamma(alpha, alpha);
    # category mean = k [P(alpha+1, alpha b_{i+1}) - P(alpha+1, alpha b_i)]
    bounds = gammaincinv(alpha, ar[1:] / k)     # rate-1 units: x = alpha b
    cdf = gammainc(alpha + 1.0, bounds)
    zero = torch.zeros(1, dtype=cdf.dtype, device=cdf.device)
    cdf_full = torch.cat([zero, cdf, zero + 1.0])
    return k * (cdf_full[1:] - cdf_full[:-1])


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
    """
    masks = tip_code_masks[tip_states]          # [tips, sites]
    return np.bitwise_and.reduce(masks, axis=0)
