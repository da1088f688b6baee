"""The port's generic optimizers against the JAX package's, on the
functions of ``tests/test_optimize.py``, and ``optimize.params`` on a
small DNA case, in float64 on the CPU:

- lock-step Brent (``optimize/brent.py``, a host lane loop) against
  JAX's ``lax.while_loop`` Brent: the same minima, a dense grid's
  optimum within 1e-4, and converged lanes no longer evaluated;
- the projected L-BFGS (``optimize/lbfgsb.py``) with a torch autograd
  objective: the Rosenbrock box, free and with an active bound, and
  the lock-step lanes reproduce standalone runs;
- EM weights (``optimize/em.py``) against JAX's and against the direct
  ML over the simplex;
- ``params.optimize_multidim`` (one L-BFGS over rates, freqs, alpha and
  every branch length, its gradient from the edge decomposition) and
  ``params.optimize_onedim`` (Brent on alpha, p-inv, one length)
  against JAX's, within max(1e-6·|lnL|, 1e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import common as jc
from pllmod_tpu.optimize import em_rates_weights as jax_em
from pllmod_tpu.optimize import minimize_brent_multi as jax_brent
from pllmod_tpu.optimize import minimize_lbfgsb as jax_lbfgsb
from pllmod_tpu.optimize import params as jax_params
from pllmod_tpu_torch import common
from pllmod_tpu_torch.optimize import (em_rates_weights, minimize_brent_multi,
                                       minimize_lbfgsb, optimize_multidim,
                                       optimize_onedim)
from pllmod_tpu_torch.optimize.lbfgsb import minimize_lbfgsb_multi
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def test_brent_multi_matches_jax():
    m = np.array([0.4, 2.2, 0.9])
    calls = []

    def f(x, live):
        calls.append(None if live is None else live.copy())
        return (x - m) ** 2 + np.sin(x)

    x, fx = minimize_brent_multi(f, 0.01, 5.0, tol=1e-10, max_iters=200)
    jm = jnp.asarray(m)
    jx, jfx = jax_brent(lambda z: (z - jm) ** 2 + jnp.sin(z), 0.01, 5.0,
                        tol=1e-10, max_iters=200)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fx, np.asarray(jfx), rtol=1e-12)
    grid = np.linspace(0.01, 5.0, 200001)
    fg = (grid[:, None] - m) ** 2 + np.sin(grid[:, None])
    np.testing.assert_allclose(x, grid[np.argmin(fg, axis=0)], atol=1e-4)
    # the first call evaluates every lane; later calls name the live ones,
    # and a lane that converged is not asked again
    assert calls[0] is None
    live = np.array(calls[1:])
    assert live[:, 0].any() and not live[-1].all()
    for k in range(3):
        off = np.nonzero(~live[:, k])[0]
        assert len(off) == 0 or not live[off[0]:, k].any()


def test_brent_x0_and_bounds():
    x, fx = minimize_brent_multi(
        lambda z, live: (z - np.array([0.3, 7.0])) ** 2,
        np.array([0.0, 0.0]), np.array([1.0, 5.0]), x0=np.array([0.9, 4.0]),
        tol=1e-9)
    np.testing.assert_allclose(x, [0.3, 5.0], atol=1e-6)


def _rosen(x):
    return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _vg(x):
    xt = torch.tensor(x, requires_grad=True)
    f = _rosen(xt)
    g, = torch.autograd.grad(f, xt)
    return float(f.detach()), g.numpy()


def _jax_vg(x):
    f = lambda z: jnp.sum(100 * (z[1:] - z[:-1] ** 2) ** 2
                          + (1 - z[:-1]) ** 2)
    val, g = jax.value_and_grad(f)(jnp.asarray(x))
    return float(val), np.asarray(g)


def test_lbfgsb_rosenbrock_box_matches_jax():
    x0, lo = np.array([-1.0, 2.0, 2.0]), np.full(3, -5.0)
    for hi in (np.full(3, 5.0), np.array([0.5, 5.0, 5.0])):
        x, fv, ne = minimize_lbfgsb(_vg, x0, lo, hi, max_iters=500)
        jx, jfv, jne = jax_lbfgsb(_jax_vg, x0, lo, hi, max_iters=500)
        np.testing.assert_allclose(x, jx, rtol=1e-8, atol=1e-10)
        assert ne == jne
    x, _, _ = minimize_lbfgsb(_vg, x0, lo, np.full(3, 5.0), max_iters=500)
    np.testing.assert_allclose(x, 1.0, atol=1e-4)
    x, _, _ = minimize_lbfgsb(_vg, x0, lo, np.array([0.5, 5.0, 5.0]),
                              max_iters=500)
    assert x[0] == pytest.approx(0.5, abs=1e-8)


def test_lbfgsb_lanes_match_standalone_runs():
    starts = [np.array([-1.0, 2.0, 2.0]), np.array([0.5, 0.5]),
              np.array([1.5, -0.5, 0.3, 0.9])]
    lows = [np.full(len(s), -5.0) for s in starts]
    highs = [np.full(len(s), 5.0) for s in starts]
    n_calls = []

    def vg_multi(xs):
        n_calls.append(len(xs))
        return [_vg(x) for x in xs]

    lanes = minimize_lbfgsb_multi(vg_multi, starts, lows, highs,
                                  max_iters=300)
    for (x, fv, ne), s, lo, hi in zip(lanes, starts, lows, highs):
        x1, f1, n1 = minimize_lbfgsb(_vg, s, lo, hi, max_iters=300)
        np.testing.assert_array_equal(x, x1)
        assert (fv, ne) == (f1, n1)
    assert set(n_calls) == {3}
    assert len(n_calls) == max(ne for _, _, ne in lanes)


def test_em_weights_match_jax_and_direct_ml():
    rng = np.random.default_rng(0)
    true_w = np.array([0.6, 0.3, 0.1])
    P = 2000
    comp = rng.choice(3, p=true_w, size=P)
    L = np.full((P, 3), 0.05) + rng.uniform(0, 0.02, (P, 3))
    L[np.arange(P), comp] = 1.0
    w = em_rates_weights(torch.as_tensor(L), torch.ones(P, dtype=torch.float64),
                         torch.full((3,), 1 / 3, dtype=torch.float64),
                         max_iters=500, tol=1e-12).numpy()
    jw = np.asarray(jax_em(jnp.asarray(L), jnp.ones(P), jnp.full(3, 1 / 3),
                           max_iters=500, tol=1e-12))
    np.testing.assert_allclose(w, jw, rtol=1e-12)
    Lt = torch.as_tensor(L)

    def neg(theta):
        th = torch.tensor(theta, requires_grad=True)
        f = -torch.log(Lt @ torch.softmax(th, 0)).sum()
        g, = torch.autograd.grad(f, th)
        return float(f.detach()), g.numpy()

    th, f_opt, _ = minimize_lbfgsb(neg, np.zeros(3), np.full(3, -20.0),
                                   np.full(3, 20.0), max_iters=500)
    w_ml = torch.softmax(torch.as_tensor(th), 0).numpy()
    np.testing.assert_allclose(w, w_ml, atol=1e-4)
    assert abs(-np.log(L @ w).sum() - f_opt) < 1e-6


@pytest.fixture(scope="module")
def dna():
    return make_case(17, 8, 160, pinv=0.1, dtype=jnp.float64, cache=False,
                     symbols="ACGT")


def _bar(got, want):
    assert abs(got - want) <= max(1e-6 * abs(want), 1e-3), (got, want)


def test_optimize_multidim_matches_jax(dna):
    which = (common.PARAM_SUBST_RATES | common.PARAM_FREQUENCIES
             | common.PARAM_ALPHA | common.PARAM_BRANCHES_ALL)
    jtree, tree = dna.jtree.copy(), dna.tree.copy()
    jpart, jl = jax_params.optimize_multidim(dna.jpart, jtree, which)
    part, tl = optimize_multidim(dna.tpart, tree, which)
    _bar(tl, jl)
    np.testing.assert_allclose(tree.lengths, jtree.lengths, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(part.subst_rates.numpy(),
                               np.asarray(jpart.subst_rates), rtol=1e-3)
    assert float(part.alpha) == pytest.approx(float(jpart.alpha), rel=1e-3)
    with pytest.raises(common.OptimizeError):
        optimize_multidim(dna.tpart, tree, common.PARAM_BRANCHES_SINGLE)


@pytest.mark.parametrize("which", ["alpha", "pinv", "edge"])
def test_optimize_onedim_matches_jax(dna, which):
    bit = {"alpha": jc.PARAM_ALPHA, "pinv": jc.PARAM_PINV,
           "edge": jc.PARAM_BRANCHES_SINGLE}[which]
    edge = 3 if which == "edge" else None
    jtree, tree = dna.jtree.copy(), dna.tree.copy()
    jpart, jl = jax_params.optimize_onedim(dna.jpart, jtree, bit, edge=edge)
    part, tl = optimize_onedim(dna.tpart, tree, bit, edge=edge)
    _bar(tl, jl)
    assert tree.lengths[3] == pytest.approx(jtree.lengths[3], rel=1e-4)
    assert float(part.alpha) == pytest.approx(float(jpart.alpha), rel=1e-4)
    assert float(part.prop_invar[0]) == pytest.approx(
        float(jpart.prop_invar[0]), rel=1e-4)
