"""The port's derivatives against the JAX package's autodiff, in float64
on the CPU:

- the P-matrix vector-Jacobian product of
  ``eigen.prob_matrices_params`` against ``jax.vjp`` of the JAX
  function (its custom JVP), at random models and at the JC (fully
  degenerate) and K80-like (partly degenerate) spectra, where the
  backward of ``eigh`` is not finite: finite, and within rtol 1e-9;
- ``Partition.prob_matrices``' routes (cached eigendecomposition,
  parameters, matrix exponential) and a finite gradient through a
  partition at the JC start;
- the alpha gradient of ``gamma.compute_gamma_cats`` (implicit quantile
  derivative) against ``jax.jacfwd`` of the JAX function in both
  discretization modes, rtol 1e-6;
- ``engine.loglikelihood_asc`` against JAX's, rtol 1e-10;
- the edge-decomposition (value, grad) of the four gradient families
  (rates, freqs, alpha+pinv, cats) against JAX's ``_neg_*_fn``
  ``value_and_grad`` (autodiff through the serial scan): float64 to
  rtol 1e-9; float32 (the plain kernel-2 path) against JAX's float64
  to the bar of ``tests/test_lbfgs_lanes.py`` (f within 1e-6 relative,
  g within rtol 5e-5 + 5e-4 of the largest component).
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import eigen as jax_eigen
from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import gamma as jax_gamma
from pllmod_tpu.ops import partition as jax_partition
from pllmod_tpu_torch.common import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN
from pllmod_tpu_torch.ops import eigen, engine, gamma
from pllmod_tpu_torch.ops import partition as partition_mod
from pllmod_tpu_torch.optimize import edge_grad as eg
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

jom = importlib.import_module("pllmod_tpu.algorithm.opt_model")

SPECTRA = [(4, 1, 4, "random"), (4, 1, 4, "jc"), (4, 1, 4, "k80"),
           (20, 2, 4, "random"), (20, 2, 4, "jc")]


@jax.jit
def _jax_vjp(args, pidx, cot):
    """(P, the cotangent of every real argument) of the JAX function."""
    P, vjp = jax.vjp(lambda r, f, b, c, p: jax_eigen.prob_matrices_params(
        r, f, b, c, pidx, p), *args)
    return P, vjp(cot)


def _model(rng, S, M, kind):
    R = S * (S - 1) // 2
    rates = rng.uniform(0.5, 2.0, (M, R))
    freqs = rng.dirichlet([5] * S, M)
    if kind != "random":
        freqs = np.full((M, S), 1.0 / S)
        rates = np.ones((M, R))
    if kind == "k80":          # transitions AG, CT at 2.5: λ repeated
        rates[:] = [1.0, 2.5, 1.0, 1.0, 2.5, 1.0]
    return rates, freqs


@pytest.mark.parametrize("S,M,C,kind", SPECTRA,
                         ids=[f"{s}s-{k}-M{m}" for s, m, _, k in SPECTRA])
def test_pmatrix_vjp_matches_jax(S, M, C, kind):
    rng = np.random.default_rng(S * 10 + M)
    rates, freqs = _model(rng, S, M, kind)
    E = 6
    brl = rng.uniform(0.01, 0.5, E)
    cats = rng.uniform(0.2, 2.0, C)
    pidx = np.arange(C) % M
    pinv = rng.uniform(0.0, 0.3, M)
    cot = rng.normal(size=(E, C, S, S))
    args = tuple(jnp.asarray(x, jnp.float64)
                 for x in (rates, freqs, brl, cats, pinv))
    P_want, want = _jax_vjp(args, jnp.asarray(pidx), jnp.asarray(cot))
    want = [np.asarray(g) for g in want]
    ts = [torch.tensor(x, requires_grad=True)
          for x in (rates, freqs, brl, cats, pinv)]
    P = eigen.prob_matrices_params(ts[0], ts[1], ts[2], ts[3],
                                   torch.as_tensor(pidx), ts[4])
    np.testing.assert_allclose(P.detach().numpy(), np.asarray(P_want),
                               rtol=1e-12, atol=1e-14)
    got = torch.autograd.grad(P, ts, torch.as_tensor(cot))
    for name, g, w in zip(("rates", "freqs", "brlens", "rate_cats",
                           "prop_invar"), got, want):
        g = g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max(), err_msg=name)


def test_eigh_backward_is_not_finite_at_jc():
    """Why the Function exists: the plain ``eigh`` route has no finite
    gradient at the JC spectrum."""
    r = torch.ones(1, 6, dtype=torch.float64, requires_grad=True)
    f = torch.full((1, 4), 0.25, dtype=torch.float64)
    lam, V, Vinv = eigen.eigen_reversible(r, f)
    P = eigen.prob_matrices_multi(
        (lam, V, Vinv), torch.tensor([0.1, 0.3], dtype=torch.float64),
        torch.ones(1, dtype=torch.float64), torch.zeros(1, dtype=torch.int64),
        torch.zeros(1, dtype=torch.float64))
    g, = torch.autograd.grad((P * torch.arange(P.numel()).view_as(P)).sum(),
                             r)
    assert not torch.isfinite(g).all()


def test_partition_prob_matrices_routes():
    case = make_case(21, 8, 64, dtype=jnp.float64, cache=False)
    part = case.tpart.with_model_params(
        subst_rates=torch.ones_like(case.tpart.subst_rates),
        freqs=torch.full_like(case.tpart.freqs, 0.25))
    brl = torch.as_tensor(case.tree.lengths)
    params = part.prob_matrices(brl)
    cached = part.cache_eigen().prob_matrices(brl)
    expm = part.replace(reversible=False).prob_matrices(brl)
    np.testing.assert_allclose(params.numpy(), cached.numpy(), atol=1e-14)
    np.testing.assert_allclose(expm.numpy(), cached.numpy(), atol=1e-12)
    # the JC start of a rate optimization: a finite gradient through the
    # partition's default route
    r = part.subst_rates.clone().requires_grad_(True)
    g, = torch.autograd.grad(
        part.with_model_params(subst_rates=r).prob_matrices(brl).sum(), r)
    assert torch.isfinite(g).all()
    want = eigen.prob_matrices_expm(part.subst_rates[0], part.freqs[0], brl,
                                    part.rate_cats)
    np.testing.assert_allclose(want.numpy(), cached.numpy(), atol=1e-12)
    rates = torch.arange(1.0, 7.0, dtype=torch.float64)
    np.testing.assert_array_equal(
        eigen.matrix_to_rates(eigen.rates_to_matrix(rates, 4)).numpy(),
        np.asarray(jax_eigen.matrix_to_rates(
            jax_eigen.rates_to_matrix(jnp.asarray(rates.numpy()), 4))))


@pytest.mark.parametrize("mode", [GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN],
                         ids=["mean", "median"])
def test_alpha_gradient_matches_jax(mode):
    jac = jax.jit(jax.jacfwd(
        lambda a: jax_gamma.compute_gamma_cats(a, 4, mode)))
    for alpha in (0.05, 0.5, 1.0, 5.0, 50.0):
        want = np.asarray(jac(jnp.asarray(alpha, jnp.float64)))
        a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
        r = gamma.compute_gamma_cats(a, 4, mode)
        got = np.array([torch.autograd.grad(r[i], a, retain_graph=True)[0]
                        .item() for i in range(4)])
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"alpha {alpha}")
        np.testing.assert_allclose(
            gamma.gamma_cats_alpha_grad(alpha, 4, mode), got, rtol=0)


def test_dgammainc_da_matches_finite_difference():
    """∂P(a, x)/∂a from P's series against a fourth-order central
    difference of scipy's P in a (step 1e-4·a), over shapes 1e-2 to 1e3
    on both sides of x = a; 0 at x = 0."""
    from scipy.special import gammainc as sp_gammainc
    rng = np.random.default_rng(7)
    a = 10 ** rng.uniform(-2, 3, 400)
    x = a * 10 ** rng.uniform(-2, 0.7, 400)
    x[:5] = 0.0
    h = 1e-4 * a

    def diff(k):
        return sp_gammainc(a + k * h, x) - sp_gammainc(a - k * h, x)

    want = (8.0 * diff(1) - diff(2)) / (12.0 * h)
    got = gamma.dgammainc_da(a, x)
    assert np.all(got[:5] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


def test_alpha_gradient_through_with_alpha():
    """``Partition.with_alpha`` of a tensor that requires grad reaches
    the category rates; a single category has none."""
    case = make_case(5, 6, 32, dtype=jnp.float64)
    a = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    cats = case.tpart.with_alpha(a).rate_cats
    g, = torch.autograd.grad(cats @ torch.arange(4.0, dtype=torch.float64),
                             a)
    want = gamma.gamma_cats_alpha_grad(0.7, 4) @ np.arange(4.0)
    assert float(g) == pytest.approx(want, rel=1e-14)
    assert gamma.compute_gamma_cats(a, 1).tolist() == [1.0]


def test_loglikelihood_asc_matches_jax():
    case = make_case(13, 9, 120, dtype=jnp.float64)
    ops, ri = case.jtree.traversal_ops()
    ri = tuple(int(x) for x in ri)
    jasc = jax_partition.make_asc_partition(case.jpart)
    want = float(jax_engine.loglikelihood_asc(
        case.jpart, jasc, jnp.asarray(ops), jnp.asarray(case.jtree.lengths),
        ri))
    asc = partition_mod.make_asc_partition(case.tpart)
    for f in ("tip_states", "code_clv", "pattern_weights", "inv_indicator",
              "prop_invar"):
        np.testing.assert_array_equal(getattr(asc, f).numpy(),
                                      np.asarray(getattr(jasc, f)))
    got = float(engine.loglikelihood_asc(case.tpart, asc, ops,
                                         torch.as_tensor(case.tree.lengths),
                                         ri))
    assert got == pytest.approx(want, rel=1e-10)
    plain = float(engine.loglikelihood(case.tpart, ops,
                                       torch.as_tensor(case.tree.lengths), ri))
    assert got > plain      # ln(1 − Σ L_const) < 0


# ---------------------------------------------------------------------------
# the edge-decomposition (value, grad) against JAX's autodiff objectives
# ---------------------------------------------------------------------------
FAMILIES = ("rates", "freqs", "alpha_pinv", "cats")


def _family(name, jp, tp, states, ops_j, brl, ri):
    """(JAX objective of x, the port's build of x, x)."""
    R = states * (states - 1) // 2
    rng = np.random.default_rng(R)
    if name == "rates":
        return (lambda x: jom._neg_rates_fn(x, jp, jnp.arange(R), R - 1,
                                            ops_j, brl, ri),
                lambda x: eg.with_rates(tp, eg.expand_sym(
                    x, torch.arange(R), R - 1)),
                rng.uniform(0.5, 2.0, R - 1))
    if name == "freqs":
        return (lambda x: jom._neg_freqs_fn(x, jp, ops_j, brl, ri),
                lambda x: eg.with_freq_ratios(tp, x),
                rng.uniform(0.5, 2.0, states - 1))
    if name == "alpha_pinv":
        return (lambda x: jom._neg_alpha_pinv_fn(x, jp, ops_j, brl, ri),
                lambda x: eg.with_alpha_pinv(tp, x), np.array([0.6, 0.15]))
    return (lambda x: jom._neg_cats_fn(x, jp, ops_j, brl, ri),
            lambda x: eg.with_cats(tp, x), np.array([0.2, 0.6, 1.2, 2.0]))


DECOMP = [("f64", 4), ("f64", 20), ("f32", 4)]


@pytest.mark.parametrize("dt,states", DECOMP,
                         ids=[f"{d}-{s}states" for d, s in DECOMP])
def test_edge_decomposition_matches_jax_autodiff(dt, states):
    """The four families' (value, grad) at one point each, against JAX's
    float64 autodiff of the same data and model (a jitted float32 scan
    of the JAX package lands farther from it than the port's float32
    decomposition does). The JAX side differentiates the serial scan (no
    eigendecomposition cached: the rates and freqs families start from
    a fresh model)."""
    jdt = jnp.float64 if dt == "f64" else jnp.float32
    case = make_case(31, 10, 160, states=states, pinv=0.1, dtype=jdt,
                     cache=False)
    ops, ri = case.jtree.traversal_ops()
    ri = tuple(int(x) for x in ri)
    et = eg.edge_tables(case.tpart, case.tree)
    assert et.tabs.kernel == (dt == "f32")
    brl_t = torch.as_tensor(case.tree.lengths, dtype=case.tpart.dtype)
    ops_j = jnp.asarray(ops)
    brl_j = jnp.asarray(case.jtree.lengths)
    for name in FAMILIES:
        jf, build, x = _family(name, case.jpart64, case.tpart, states,
                               ops_j, brl_j, ri)
        fo, go = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x))
        fo, go = float(fo), np.asarray(go)
        xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        fn = eg.edge_decomp_neg_loglh(build(xt), brl_t, et)
        gn, = torch.autograd.grad(fn, xt)
        fn, gn = float(fn.detach()), gn.numpy()
        if dt == "f64":
            assert fn == pytest.approx(fo, rel=1e-9), name
            np.testing.assert_allclose(gn, go, rtol=1e-9,
                                       atol=1e-9 * np.abs(go).max(),
                                       err_msg=name)
        else:
            assert abs(fn - fo) <= 1e-6 * abs(fo), name
            np.testing.assert_allclose(gn, go, rtol=5e-5,
                                       atol=5e-4 * np.abs(go).max(),
                                       err_msg=name)

def test_edge_decomposition_gradient_in_branch_lengths():
    """The decomposition's gradient in the lengths (each length enters
    only its own edge's P) against a central difference of the serial
    engine's logL."""
    case = make_case(33, 8, 96, dtype=jnp.float64)
    et = eg.edge_tables(case.tpart, case.tree)
    ops, ri = case.tree.traversal_ops()
    brl = torch.as_tensor(case.tree.lengths).clone().requires_grad_(True)
    f = eg.edge_decomp_neg_loglh(case.tpart, brl, et)
    g, = torch.autograd.grad(f, brl)
    assert float(f) == pytest.approx(-float(engine.loglikelihood(
        case.tpart, ops, brl.detach(), ri)), rel=1e-12)
    h = 1e-6
    for e in range(len(case.tree.lengths)):
        d = torch.zeros_like(brl)
        d[e] = h
        fd = -(float(engine.loglikelihood(case.tpart, ops, brl.detach() + d,
                                          ri))
               - float(engine.loglikelihood(case.tpart, ops,
                                            brl.detach() - d, ri))) / (2 * h)
        assert float(g[e]) == pytest.approx(fd, rel=1e-5, abs=1e-6)
