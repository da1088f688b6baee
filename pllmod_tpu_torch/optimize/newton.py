"""Vectorized bracketed Newton-Raphson for 1-D maximization — PyTorch
counterpart of ``pllmod_tpu.optimize.newton``
(``pllmod_opt_minimize_newton_multi`` and
``pllmod_opt_minimize_newton_old``, opt_algorithms.c:133-261, 281-384).

``N`` independent scalar problems advance in lock-step with ONE shared
derivative callback per iteration; each tracks a bracket, clamps its
step and freezes once converged (frozen entries do not move). The JAX
``lax.while_loop`` is a Python loop of at most ``max_iters`` masked
steps. It stops early once every entry has converged only where that
check costs no host sync (CPU tensors); on the card it runs all steps,
which changes nothing since frozen entries keep their values.

Convention: we MAXIMIZE (df/ddf are derivatives of the log-likelihood);
the reference minimizes -logL with the same update rule.
"""

from __future__ import annotations

import torch


def _bounds(x0, xmin, xmax):
    x0 = torch.as_tensor(x0)
    xmin = torch.as_tensor(xmin, dtype=x0.dtype, device=x0.device)
    xmax = torch.as_tensor(xmax, dtype=x0.dtype, device=x0.device)
    return x0, xmin.expand_as(x0), xmax.expand_as(x0)


def _all_done(conv) -> bool:
    """True when every entry converged — read only on the CPU, where it
    costs no device sync."""
    return conv.device.type == "cpu" and bool(conv.all())


def newton_step(x, df, ddf, xl, xh, xmin, xmax, max_step):
    """One bracketed Newton step of ``pllmod_opt_minimize_newton_multi``
    (maximize convention): returns (x_new, xl, xh). ``df > 0`` puts the
    maximum to the right; Newton where concave and inside the bracket,
    else bisection toward the ascent side; clamped to [xmin, xmax].

    One difference from the JAX package: a Newton step that rounds to
    nothing (x_newton == x, which the bracket update has just made a
    bracket end) counts as inside the bracket, so x stays and converges.
    The JAX package bisects away from such a point, toward whichever end
    the sign of a derivative at rounding level picks — in float32 that
    happens at ~1e-7 relative steps, far inside the 1e-4 tolerance, and
    sends a converged edge to the middle of its bracket (e.g. to 50)."""
    xl = torch.where(df > 0, x, xl)
    xh = torch.where(df < 0, x, xh)
    newton_dx = torch.where(ddf < 0, -df / ddf, torch.zeros_like(df))
    newton_dx = torch.clamp(newton_dx, -max_step, max_step)
    x_newton = x + newton_dx
    x_bisect = torch.where(df > 0, 0.5 * (x + xh), 0.5 * (x + xl))
    use_newton = (ddf < 0) & (((x_newton > xl) & (x_newton < xh))
                              | (x_newton == x))
    x_new = torch.where(use_newton, x_newton, x_bisect)
    return torch.minimum(torch.maximum(x_new, xmin), xmax), xl, xh


def minimize_newton_multi(deriv_fn, x0, xmin, xmax, tol=1e-4, max_iters=10):
    """Bracketed Newton on a batch of independent 1-D problems.

    Args:
      deriv_fn: x [N] -> (df [N], ddf [N]) derivatives of the objective
        (to maximize) at x, called once per iteration for the batch
      x0: [N] starting points; xmin/xmax: scalar or [N] bounds
      tol: convergence threshold on |dx|
      max_iters: iteration cap (also sets the step clamp
        (xmax - xmin) / max_iters, opt_algorithms.c:195)
    Returns:
      x_opt [N]
    """
    x, xmin, xmax = _bounds(x0, xmin, xmax)
    max_step = (xmax - xmin) / max_iters
    xl, xh = xmin, xmax
    conv = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        if _all_done(conv):
            break
        df, ddf = deriv_fn(x)
        x_new, xl_n, xh_n = newton_step(x, df, ddf, xl, xh, xmin, xmax,
                                        max_step)
        xl = torch.where(conv, xl, xl_n)
        xh = torch.where(conv, xh, xh_n)
        new_conv = conv | ((x_new - x).abs() < tol) | (df == 0)
        x = torch.where(conv, x, x_new)
        conv = new_conv
    return x


def minimize_newton_old(deriv_fn, x0, xmin, xmax, tol=1e-4, max_iters=32):
    """Legacy IQ-TREE-derived Newton variant with bisection fallback
    (``pllmod_opt_minimize_newton_old``, opt_algorithms.c:281-384),
    vectorized like :func:`minimize_newton_multi`: keep a bracket from
    the sign of f = dlogL/dx; take the raw Newton step x − f/df unless
    the objective is locally convex (df ≥ 0) or the step leaves the
    bracket (the reference's product test), then bisect; stop when
    |dx| < tol or the derivative vanishes inside the bracket.
    Returns x_opt [N]."""
    x, xmin, xmax = _bounds(x0, xmin, xmax)
    x = torch.minimum(torch.maximum(x, xmin), xmax)
    f0, _ = deriv_fn(x)
    # f > 0: maximum to the right (reference f < 0 in minimize convention)
    xl = torch.where(f0 > 0, x, xmin)
    xh = torch.where(f0 > 0, xmax, x)
    conv = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        if _all_done(conv):
            break
        f, df = deriv_fn(x)
        done_now = (df < 0) & (f.abs() < tol)
        # out-of-bracket product test (opt_algorithms.c:330-333),
        # invariant under the min/max sign flip
        oob = ((x - xh) * df - f) * ((x - xl) * df - f) >= 0.0
        bisect = (df >= 0.0) | oob
        x_new = torch.where(bisect, xl + 0.5 * (xh - xl), x - f / df)
        x_new = torch.minimum(torch.maximum(x_new, xmin), xmax)
        dx = (x_new - x).abs()
        # the reference updates the bracket with the current f
        xl = torch.where(~conv & (f > 0), x, xl)
        xh = torch.where(~conv & (f <= 0), x, xh)
        new_conv = conv | done_now | (dx < tol)
        x = torch.where(conv | done_now, x, x_new)
        conv = new_conv
    return x
