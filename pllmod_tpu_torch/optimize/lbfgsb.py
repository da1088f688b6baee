"""Bound-constrained L-BFGS with analytic gradients — counterpart of
``pllmod_tpu.optimize.lbfgsb`` (host float64 algebra; the JAX package's
whole-trajectory device driver ``minimize_lbfgsb_multi_device`` exists
for the TPU's dispatch cost and is not ported).

Replaces the reference's vendored f2c L-BFGS-B v3.0 + forward
finite-difference gradients (opt_algorithms.c:418-540: one extra
objective evaluation PER DIMENSION per iteration — nmax=189 for protein
GTR). Here gradients come from autograd through the likelihood's edge
decomposition (``algorithm/opt_model.py``), so each iteration costs one
value-and-grad evaluation regardless of dimension.

Algorithm: projected two-loop-recursion L-BFGS — the quasi-Newton
direction is computed on the free variables (active-set by bound +
gradient sign), the trial point is projected onto the box, and an Armijo
backtracking line search guarantees monotone descent. This preserves the
reference's L-BFGS-B contract (box bounds, memory m, convergence on
projected-gradient norm and relative f decrease) without the Fortran
state machine.

The optimizer core is a GENERATOR state machine (`_lbfgsb_gen`): it
yields the point to evaluate and receives ``(f, g)`` — so the same
trajectory code serves both the single-instance driver
(:func:`minimize_lbfgsb`) and the LOCK-STEP multi-instance driver
(:func:`minimize_lbfgsb_multi`), the reference's
``pllmod_opt_minimize_lbfgsb_multi`` (opt_algorithms.c:542-807): K
instances advance together, and every step ALL lanes are evaluated in
ONE batched call — finished lanes are evaluated at their final point and
the result discarded. The driver is a host loop: the objective
dominates the cost; the O(m·d) vector algebra is negligible.
"""

from __future__ import annotations

import numpy as np

LBFGSB_FACTR = 1e7  # reference default factr (machine-eps multiples)
_EPSMCH = np.finfo(np.float64).eps


def _lbfgsb_gen(x0, lower, upper, m: int = 10, max_iters: int = 100,
                factr: float = LBFGSB_FACTR, pgtol: float = 1e-5):
    """Projected L-BFGS as a coroutine: ``f, g = yield x`` requests one
    objective evaluation. Returns (x_opt, f_opt, n_evals) via
    StopIteration.value. Trajectories are identical to the previous
    callback-driven implementation (same code, evaluation seam inverted).
    """
    x = np.clip(np.asarray(x0, np.float64), lower, upper)
    lower = np.broadcast_to(np.asarray(lower, np.float64), x.shape)
    upper = np.broadcast_to(np.asarray(upper, np.float64), x.shape)
    f, g = yield x
    f, g = float(f), np.asarray(g, np.float64)
    n_evals = 1
    S, Y, RHO = [], [], []

    for _ in range(max_iters):
        # projected gradient (KKT residual on the box)
        pg = np.where((x <= lower) & (g > 0), 0.0,
                      np.where((x >= upper) & (g < 0), 0.0, g))
        if np.max(np.abs(pg)) <= pgtol:
            break

        # free-variable mask; restrict direction to free set
        free = ~(((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0)))
        q = np.where(free, g, 0.0)
        alphas = []
        for s, y, rho in zip(reversed(S), reversed(Y), reversed(RHO)):
            a = rho * np.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if S:
            gamma = np.dot(S[-1], Y[-1]) / max(np.dot(Y[-1], Y[-1]), 1e-300)
            q = gamma * q
        for (s, y, rho), a in zip(zip(S, Y, RHO), reversed(alphas)):
            b = rho * np.dot(y, q)
            q = q + s * (a - b)
        d = -np.where(free, q, 0.0)
        if np.dot(d, g) >= 0:  # not a descent direction -> steepest descent
            d = -np.where(free, g, 0.0)
            if not np.any(d):
                break

        # Armijo backtracking on the projected path, with a Wolfe-style
        # expansion phase: if the unit step satisfies Armijo but the
        # directional derivative is still strongly negative (curvature
        # condition violated), grow the step — Armijo-only unit steps
        # crawl on ill-scaled valleys (the 189-dim protein-GTR case)
        step = 1.0
        accepted = False
        for _ls in range(30):
            x_new = np.clip(x + step * d, lower, upper)
            dx = x_new - x
            if not np.any(dx):
                break
            f_new, g_new = yield x_new
            f_new = float(f_new)
            n_evals += 1
            if f_new <= f + 1e-4 * np.dot(g, dx):
                accepted = True
                break
            step *= 0.5
        if not accepted:
            break
        for _exp in range(8):
            dgx = np.dot(np.asarray(g_new, np.float64), x_new - x)
            if dgx >= 0.9 * np.dot(g, x_new - x):
                break                       # curvature condition holds
            x_try = np.clip(x + 2.0 * step * d, lower, upper)
            if not np.any(x_try - x_new):
                break
            f_try, g_try = yield x_try
            f_try = float(f_try)
            n_evals += 1
            if f_try > f + 1e-4 * np.dot(g, x_try - x) or f_try >= f_new:
                break
            step *= 2.0
            x_new, f_new, g_new = x_try, f_try, g_try

        s_vec = x_new - x
        y_vec = np.asarray(g_new, np.float64) - g
        sy = np.dot(s_vec, y_vec)
        if sy > 1e-10 * np.linalg.norm(s_vec) * np.linalg.norm(y_vec):
            S.append(s_vec)
            Y.append(y_vec)
            RHO.append(1.0 / sy)
            if len(S) > m:
                S.pop(0), Y.pop(0), RHO.pop(0)

        f_prev = f
        x, f, g = x_new, f_new, np.asarray(g_new, np.float64)
        # factr <= 0 disables the relative-decrease stop (run to pgtol)
        if factr > 0 and (f_prev - f) <= factr * _EPSMCH * max(
                abs(f), abs(f_prev), 1.0):
            break

    return x, f, n_evals


def minimize_lbfgsb(value_and_grad, x0, lower, upper, m: int = 10,
                    max_iters: int = 100, factr: float = LBFGSB_FACTR,
                    pgtol: float = 1e-5):
    """Minimize f on a box.

    Args:
      value_and_grad: x [d] (np.float64) -> (f, g [d]); typically an
        autograd (value, grad) returned as numpy.
      x0, lower, upper: [d]
      m: history size
      factr: stop when (f_k - f_{k+1}) <= factr * eps * max(|f|, 1)
      pgtol: stop when max_i |proj_grad_i| <= pgtol
    Returns:
      (x_opt [d], f_opt, n_evals)
    """
    gen = _lbfgsb_gen(x0, lower, upper, m=m, max_iters=max_iters,
                      factr=factr, pgtol=pgtol)
    try:
        x = next(gen)
        while True:
            x = gen.send(value_and_grad(x))
    except StopIteration as stop:
        return stop.value


def minimize_lbfgsb_multi(value_and_grad_multi, x0s, lowers, uppers,
                          m: int = 10, max_iters: int = 100,
                          factr: float = LBFGSB_FACTR, pgtol: float = 1e-5):
    """K lock-step L-BFGS-B instances with ONE batched evaluation per
    step (pllmod_opt_minimize_lbfgsb_multi, opt_algorithms.c:542-807:
    every rank executes each instance's objective evaluations in the
    same order; here the "ranks" are lanes of one batched call).

    Args:
      value_and_grad_multi: xs (list of K [d_k] float64 arrays) ->
        list of K (f, g) pairs — ONE combined call evaluating every
        lane (lanes whose instance already converged are passed their
        final x; their result is ignored).
      x0s / lowers / uppers: per-lane arrays (dims may differ).
    Returns:
      list of K (x_opt, f_opt, n_evals) — each lane's trajectory is
      IDENTICAL to a standalone :func:`minimize_lbfgsb` run (the lock
      step only aligns evaluation timing, never lane state).
    """
    K = len(x0s)
    gens, xs, live, results = [], [], [], [None] * K
    for k in range(K):
        gen = _lbfgsb_gen(x0s[k], lowers[k], uppers[k], m=m,
                          max_iters=max_iters, factr=factr, pgtol=pgtol)
        gens.append(gen)
        xs.append(next(gen))
        live.append(True)
    while any(live):
        fgs = value_and_grad_multi(xs)
        for k in range(K):
            if not live[k]:
                continue
            try:
                xs[k] = gens[k].send(fgs[k])
            except StopIteration as stop:
                results[k] = stop.value
                xs[k] = stop.value[0]
                live[k] = False
    return results
