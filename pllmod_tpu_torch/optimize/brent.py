"""Vectorized bounded Brent 1-D minimization — counterpart of
``pllmod_tpu.optimize.brent`` (the reference's opt_algorithms.c:809-1467).

The reference splits Brent into init/loop/post phases so that N
independent optimizations synchronize only at target-function calls
(``brent_opt_alt`` + ``minimize_brent_multi``). Here the N lanes advance
together in a host loop over numpy float64 state, and each iteration
makes one batched call of the objective for the lanes that have not
converged (converged lanes are frozen). Each lane's trajectory is the
JAX package's: the same golden-section steps with parabolic
acceleration on the bracket [a, b], the same tests, in float64.
"""

from __future__ import annotations

import numpy as np

_GOLD = 0.3819660112501051  # (3 - sqrt(5)) / 2
_EPS = 1.0e-12


def minimize_brent_multi(f, xmin, xmax, x0=None, tol=1e-4, max_iters=100):
    """Minimize N independent scalar functions on boxes [xmin, xmax].

    Args:
      f: ``f(x, live) -> fx``: x float64 [N], live bool [N] (the lanes
        to evaluate; None on the first call, which evaluates every lane)
        -> fx [N] (entries of the other lanes are ignored). One call an
        iteration.
      xmin, xmax: [N] or scalar bounds
      x0: optional [N] starting points (default: golden point of the box)
      tol: relative x tolerance
    Returns:
      (x_opt [N], f_opt [N]) float64 numpy
    """
    a = np.asarray(xmin, np.float64)
    b = np.asarray(xmax, np.float64)
    if x0 is None:
        x = a + _GOLD * (b - a)
    else:
        x = np.clip(np.asarray(x0, np.float64), a, b)
    fx = np.asarray(f(x, None), np.float64)
    # the batch shape may come from the objective (scalar bounds)
    shape = np.broadcast_shapes(np.shape(x), np.shape(fx))
    a, b, x, fx = (np.broadcast_to(v, shape).copy() for v in (a, b, x, fx))
    w, v = x.copy(), x.copy()
    fw, fv = fx.copy(), fx.copy()
    d = np.zeros(shape)
    e = np.zeros(shape)
    conv = np.zeros(shape, bool)
    for _ in range(max_iters):
        if conv.all():
            break
        xm = 0.5 * (a + b)
        tol1 = tol * np.abs(x) + _EPS
        tol2 = 2.0 * tol1
        new_conv = conv | (np.abs(x - xm) <= tol2 - 0.5 * (b - a))

        # parabolic fit through (x, w, v)
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q2 = 2.0 * (q - r)
        p = np.where(q2 > 0, -p, p)
        q2 = np.abs(q2)
        use_para = ((np.abs(p) < np.abs(0.5 * q2 * e))
                    & (p > q2 * (a - x)) & (p < q2 * (b - x)))
        # golden-section fallback
        e_gold = np.where(x >= xm, a - x, b - x)
        d_gold = _GOLD * e_gold
        d_para = np.where(q2 != 0, p / np.where(q2 == 0, 1.0, q2), 0.0)
        new_e = np.where(use_para, d, e_gold)
        new_d = np.where(use_para, d_para, d_gold)
        # enforce the minimum step
        step = np.where(np.abs(new_d) >= tol1, new_d,
                        np.where(new_d >= 0, tol1, -tol1))
        u = x + step
        live = ~new_conv
        fu = fx.copy()
        if live.any():
            fu[live] = np.asarray(f(np.where(new_conv, x, u), live),
                                  np.float64)[live]

        better = fu <= fx
        # bracket update
        a2 = np.where(better, np.where(u >= x, x, a), np.where(u < x, u, a))
        b2 = np.where(better, np.where(u >= x, b, x), np.where(u < x, b, u))
        # best-three bookkeeping
        near = (fu <= fw) | (w == x)
        mid = (fu <= fv) | (v == x) | (v == w)
        v2 = np.where(better, w, np.where(near, w, np.where(mid, u, v)))
        fv2 = np.where(better, fw, np.where(near, fw, np.where(mid, fu, fv)))
        w2 = np.where(better, x, np.where(near, u, w))
        fw2 = np.where(better, fx, np.where(near, fu, fw))
        x2 = np.where(better, u, x)
        fx2 = np.where(better, fu, fx)

        upd = ~new_conv
        a[upd], b[upd], x[upd], w[upd], v[upd] = (
            a2[upd], b2[upd], x2[upd], w2[upd], v2[upd])
        fx[upd], fw[upd], fv[upd] = fx2[upd], fw2[upd], fv2[upd]
        d[upd], e[upd] = step[upd], new_e[upd]
        conv = new_conv
    return x, fx
