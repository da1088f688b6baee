"""The port's derivative pipeline (ops/deriv.py, ops/derivatives.py,
optimize/newton.py) against the JAX package: the plain versions of the
sumtable, derivative and per-edge Newton kernels against the JAX Pallas
kernels in interpret mode on the same buffers (the port's directed CLVs),
and the float64 formulation against JAX's, for DNA with and without
p-inv, protein and a 5-state odd alphabet.

Tolerances: st within 1e-6 of max|st| with equal scaler rows (float32
products summed in another order); derivatives within 2e-5 (the JAX
package's kernel bar; see the test for the floor); Newton lengths 5e-4
relative to max(|t|, 1e-4) and lnl0 2e-6; float64 paths 1e-10."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops import derivatives as jax_deriv
from pllmod_tpu.ops import pallas_deriv
from pllmod_tpu.optimize import blo as jax_blo
from pllmod_tpu.optimize import newton as jax_newton
from pllmod_tpu_torch.common import (MAX_BRANCH_LEN, MIN_BRANCH_LEN,
                                     TOL_BRANCH_LEN)
from pllmod_tpu_torch.ops import _build, deriv, derivatives
from pllmod_tpu_torch.optimize import blo, newton
from pllmod_tpu_torch.profile import LAUNCHES
from tests.test_torch_partition import ODD5
from tests.torch_cases import make_case, to_torch
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

# (label, make_case arguments): sequences simulated along the tree
CASES = {
    "dna": dict(seed=21, n_taxa=10, n_sites=256, symbols="ACGT"),
    "dna_pinv": dict(seed=22, n_taxa=10, n_sites=256, pinv=0.25,
                     symbols="ACGT"),
    "protein": dict(seed=23, n_taxa=8, n_sites=128, states=20,
                    symbols=jax_charmap.AA_ORDER),
    # the fifth state has no symbol of its own: written as a gap
    "odd5": dict(seed=24, n_taxa=9, n_sites=160, states=5, pinv=0.1,
                 charmap=jax_charmap.custom(5, ODD5, "odd5"),
                 symbols="ABCD-"),
}
DERIV_RTOL = 2e-5
XMIN, XMAX, TOL = MIN_BRANCH_LEN, MAX_BRANCH_LEN, TOL_BRANCH_LEN


def _rel(got, want, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))


def _directed(label):
    """A case with its directed-CLV buffers (the port's fused walk),
    JAX's sumtables of them (interpret) and their torch copies."""
    case = make_case(**CASES[label])
    trav = jax_blo.DirectedTraversal(case.jtree)
    brl = np.clip(case.jtree.lengths, XMIN, XMAX).astype(np.float32)
    tabs = blo._compile_tables(case.tpart, blo.DirectedTraversal(case.tree))
    clvs, scalers = blo._directed_clvs(case.tpart, tabs,
                                       torch.as_tensor(brl))
    eref6 = pallas_deriv.compile_edge_refs(trav.edge_ref, trav.edge_mask,
                                           case.jpart.n_tips)
    st, sc = pallas_deriv.edge_sumtables_pallas(
        case.jpart, jnp.asarray(clvs.numpy()), jnp.asarray(scalers.numpy()),
        eref6, split=False, interpret=True)
    return dict(case=case, trav=trav, brl=brl, eref6=eref6, st=st, sc=sc,
                clvs=clvs, scalers=scalers,
                tst=torch.as_tensor(np.array(st)),
                tsc=torch.as_tensor(np.array(sc)))


@pytest.fixture(scope="module", params=list(CASES))
def directed(request):
    return _directed(request.param)


def test_edge_refs_and_basis_match_jax(directed):
    case, trav = directed["case"], directed["trav"]
    got = deriv.compile_edge_refs(trav.edge_ref, trav.edge_mask,
                                  case.tpart.n_tips, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(directed["eref6"]))
    AB = np.asarray(pallas_deriv.sumtable_basis(case.jpart))
    basis = deriv.sumtable_basis(case.tpart).numpy()
    C, S = case.tpart.n_cats, case.tpart.states
    CS = C * S
    for c in range(C):
        o = slice(c * S, (c + 1) * S)
        oo = slice(CS + c * S, CS + (c + 1) * S)
        np.testing.assert_allclose(basis[0, c], AB[o, o], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(basis[1, c], AB[oo, oo], rtol=1e-6,
                                   atol=1e-7)


def test_sumtables_match_jax_kernel(directed):
    """Kernel 8's plain version on JAX's directed buffers."""
    case = directed["case"]
    eref6 = torch.as_tensor(np.array(directed["eref6"]))
    before = dict(LAUNCHES)
    st, sc = deriv.edge_sumtables(case.tpart, directed["clvs"],
                                  directed["scalers"], eref6)
    assert LAUNCHES == before                # CPU tensors: the plain path
    want_st, want_sc = np.asarray(directed["st"]), np.asarray(directed["sc"])
    live = directed["trav"].edge_mask
    np.testing.assert_array_equal(sc.numpy()[live], want_sc[live])
    err = np.max(np.abs(st.numpy()[live] - want_st[live]))
    assert err <= 1e-6 * np.max(np.abs(want_st[live])), err


def test_derivatives_match_jax_kernel_and_f64(directed):
    """Kernel 9's plain version on JAX's sumtables against JAX's kernel
    (interpret) and JAX's XLA formulation; the port's float64
    formulation against JAX's, on the same sumtables."""
    case, trav, brl = directed["case"], directed["trav"], directed["brl"]
    live = trav.edge_mask
    got = deriv.edge_derivatives_k(case.tpart, directed["tst"],
                                   directed["tsc"], torch.as_tensor(brl))
    want = pallas_deriv.edge_derivatives_pallas(
        case.jpart, directed["st"], directed["sc"], jnp.asarray(brl),
        interpret=True)
    E, _, P = directed["tst"].shape
    C, S = case.tpart.n_cats, case.tpart.states
    st_std = np.asarray(directed["st"]).reshape(E, C, S, P).transpose(
        0, 3, 1, 2)
    sc = jnp.asarray(directed["sc"])[:, 0]
    # JAX's XLA formulation on the same sumtables (the JAX kernel test's
    # golden), and the float64 formulation of the same float32 inputs.
    # d/dt sums site terms of both signs (|r1| up to ~10) to values that
    # may be < 1, where float32 site math leaves ~1e-5 absolute: the bar
    # is 2e-5 relative to max(|b|, 1), and against JAX's float32
    # implementations 2e-5 plus their own error
    want_xla = jax_deriv.edge_derivatives_batch(
        case.jpart, jnp.asarray(st_std), sc, jnp.asarray(brl))
    exact = derivatives.edge_derivatives_batch(
        case.tpart.to(dtype=torch.float64), torch.as_tensor(st_std).double(),
        torch.as_tensor(np.asarray(sc)), torch.as_tensor(brl).double())
    for name, a, b, bx, b64 in zip(("lnl", "df", "ddf"), got, want,
                                   want_xla, exact):
        a, b64 = a.numpy()[live], b64.numpy()[live]
        assert _rel(a, b64, 1.0) < DERIV_RTOL, name
        b = np.asarray(b)[live]
        assert _rel(a, b, 1.0) < DERIV_RTOL + _rel(b, b64, 1.0), name
        bx = np.asarray(bx)[live]
        assert _rel(a, bx, 1.0) < DERIV_RTOL + _rel(bx, b64, 1.0), name
    # float64: the port's formulation against JAX's on the same sumtables
    jp = case.jpart64
    st64 = st_std.astype(np.float64)
    brl64 = brl.astype(np.float64)
    want64 = jax_deriv.edge_derivatives_batch(jp, jnp.asarray(st64), sc,
                                              jnp.asarray(brl64))
    got64 = derivatives.edge_derivatives_batch(
        to_torch(jp), torch.as_tensor(st64),
        torch.as_tensor(np.asarray(sc)), torch.as_tensor(brl64))
    for name, a, b in zip(("lnl", "df", "ddf"), got64, want64):
        assert _rel(a.numpy()[live], np.asarray(b)[live], 1e-3) < 1e-10, \
            name


def test_newton_matches_jax_kernel(directed):
    """Kernel 10's plain version on JAX's sumtables against JAX's fused
    Newton kernel (interpret), at the optimizer's own Newton tolerance
    (TOL_BRANCH_LEN). Where JAX's Newton ends at a stationary point
    (next Newton step < 10 tol) the lengths agree to 5e-4; elsewhere
    JAX's kernel bisected away from a point whose last Newton step
    rounded to nothing (optimize/newton.newton_step) and the port must
    end at a logL at least as high."""
    case, live, brl = directed["case"], directed["trav"].edge_mask, \
        directed["brl"]
    st, sc = directed["tst"], directed["tsc"]
    t, lnl0, iters = deriv.newton_edges(case.tpart, st, sc,
                                        torch.as_tensor(brl), XMIN, XMAX,
                                        TOL, 10)
    jt, jl = pallas_deriv.newton_edges_pallas(
        case.jpart, directed["st"], directed["sc"], jnp.asarray(brl), XMIN,
        XMAX, TOL, 10, interpret=True)
    jt = torch.as_tensor(np.array(jt))
    l_j, df_j, ddf_j = deriv.edge_derivatives_k(case.tpart, st, sc, jt)
    settled = ((df_j / ddf_j).abs() < 10 * TOL) & (ddf_j < 0)
    settled = settled.numpy() & live
    assert settled.sum() >= 0.8 * live.sum()
    assert _rel(t.numpy()[settled], jt.numpy()[settled], 1e-4) < 5e-4
    l_t = deriv.edge_derivatives_k(case.tpart, st, sc, t)[0]
    assert bool((l_t >= l_j - 1e-6 * l_j.abs()).numpy()[live].all())
    assert _rel(lnl0.numpy()[live], np.asarray(jl)[live], 1e-2) < 2e-6
    assert iters.dtype == torch.int32
    assert int(iters.min()) >= 1 and int(iters.max()) <= 10
    # the plain kernel 10 is minimize_newton_multi over plain kernel 9
    want = newton.minimize_newton_multi(
        lambda x: deriv.edge_derivatives_k(case.tpart, directed["tst"],
                                           directed["tsc"], x)[1:],
        torch.as_tensor(brl), XMIN, XMAX, tol=TOL, max_iters=10)
    assert torch.equal(t, want)


def test_port_f64_sumtable_matches_jax():
    """The float64 sumtable + derivatives of the port against JAX's, on
    the same CLVs (1e-10)."""
    case = make_case(31, 8, 96, pinv=0.2, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    P, C, S = case.tpart.n_patterns_padded, case.tpart.n_cats, \
        case.tpart.states
    a = rng.uniform(0.01, 1.0, (3, P, C, S))
    b = rng.uniform(0.01, 1.0, (3, P, C, S))
    want = np.stack([np.asarray(jax_deriv.sumtable(case.jpart, a[i], b[i]))
                     for i in range(3)])
    got = derivatives.sumtable(case.tpart, torch.as_tensor(a),
                               torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    sc = rng.integers(0, 3, (3, P)).astype(np.int32)
    t = np.array([0.05, 0.3, 1.2])
    want = jax_deriv.edge_derivatives_batch(case.jpart, jnp.asarray(want),
                                            jnp.asarray(sc), jnp.asarray(t))
    got = derivatives.edge_derivatives_batch(
        case.tpart, torch.as_tensor(got), torch.as_tensor(sc),
        torch.as_tensor(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)


def _quartic(x, c):
    # maximize -(x - c)^4 - (x - c)^2 per entry: (f', f'')
    d = x - c
    return -4 * d ** 3 - 2 * d, -12 * d ** 2 - 2


@pytest.mark.parametrize("fn", ["multi", "old"])
def test_newton_matches_jax(fn):
    x0 = np.linspace(0.1, 5.0, 7)
    c = np.linspace(0.5, 3.0, 7)
    jx = getattr(jax_newton, f"minimize_newton_{fn}")(
        lambda x: _quartic(x, jnp.asarray(c)), jnp.asarray(x0), 0.01, 10.0,
        tol=1e-8, max_iters=30)
    tx = getattr(newton, f"minimize_newton_{fn}")(
        lambda x: _quartic(x, torch.as_tensor(c)), torch.as_tensor(x0),
        0.01, 10.0, tol=1e-8, max_iters=30)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_allclose(tx.numpy(), c, rtol=1e-6)


def test_deriv_coeffs_and_plane_match_jax():
    case = make_case(33, 8, 96, pinv=0.3)
    t = np.array([0.01, 0.2, 1.5], np.float32)
    want = np.asarray(pallas_deriv.deriv_coeffs(case.jpart, jnp.asarray(t)))
    got = deriv.deriv_coeffs(case.tpart, torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want[:, :3], rtol=2e-6, atol=0)
    np.testing.assert_allclose(
        deriv.invar_log_plane(case.tpart).numpy(),
        np.asarray(pallas_deriv.invar_log_plane(case.jpart))[0, 0],
        rtol=1e-6)
    lw = deriv._lam_weight_rows(case.tpart, scale=1.7).numpy()
    np.testing.assert_allclose(
        lw, np.asarray(pallas_deriv._lam_weight_rows(
            case.jpart, scale=1.7))[0, :2], rtol=1e-6)


def test_blo_sweep_kernel_pipeline_matches_plain_path():
    """One float32 kernel-pipeline sweep (plain versions on the CPU)
    against the float64 plain path on every edge: the same logL at the
    incoming lengths and the same Newton optimum."""
    case = make_case(35, 10, 200, pinv=0.15)
    trav = blo.DirectedTraversal(case.tree)
    brl = np.clip(case.tree.lengths, XMIN, XMAX)
    edges = torch.as_tensor(np.nonzero(trav.edge_mask)[0])
    out = []
    for part in (case.tpart, case.tpart.to(dtype=torch.float64)):
        part = part.cache_eigen()
        tabs = blo._compile_tables(part, trav)
        out.append(blo._blo_sweep(part, tabs, edges,
                                  torch.as_tensor(brl, dtype=part.dtype),
                                  XMIN, XMAX, TOL))
    (b32, l32), (b64, l64) = out
    assert abs(float(l32) - float(l64)) / abs(float(l64)) < 2e-6
    assert _rel(b32.numpy()[trav.edge_mask], b64.numpy()[trav.edge_mask],
                1e-4) < 5e-4


def _round_up(n, k):
    return -(-n // k) * k


@pytest.mark.parametrize("cs,ppads,want", [
    ((16,), (16384,), ("cluster", 8)),           # flagship DNA +G4
    ((80,), (4096,), ("cluster", 8)),            # protein +G4
    ((16, 80), (16384, 4096), ("cluster", 16)),  # both at once (K = 2)
    ((16,), (512,), ("cluster", 2)),
    ((16,), (131072,), ("stream", 1)),           # no cluster holds it
])
def test_newton_config_cluster_size(cs, ppads, want):
    """Kernel 10's design: the smallest cluster whose CTAs hold their
    slices of the edge's rows beside the coefficient rows, else the
    streaming CTA; forced designs that do not hold the edge are refused
    (None), never swapped."""
    cf = deriv.newton_config(cs, ppads)
    assert (cf["kind"], cf["N"]) == want
    assert cf["smem"] <= _build.SMEM_PER_BLOCK
    if cf["kind"] == "cluster":
        slices = [_round_up(-(-p // cf["N"]), 4) for p in ppads]
        assert all(s % 4 == 0 and s * cf["N"] >= p
                   for s, p in zip(slices, ppads))
        smaller = [n for n in deriv.NEWTON_CLUSTERS if n < cf["N"]]
        assert all(deriv.newton_config(cs, ppads, n) is None
                   for n in smaller)
    assert deriv.newton_config(cs, ppads, 1)["kind"] == "stream"
    assert deriv.newton_config([16] * 5000, [512] * 5000) is None


@pytest.mark.parametrize("C", [1, 4, 8, 32])
@pytest.mark.parametrize("S", [4, 5, 8, 16, 20, 32, 61, 64])
def test_sumtable_config_invariants(C, S):
    """Kernel 8's tiled configuration (csrc/configs.h sumtable_config,
    through the host library): its tile divides Ppad, its threads are
    C · IG · T / 4 ≤ 256, its shared memory (mbarriers, bases, tip
    tables, two stages, 128-byte aligned) fits a block, C·S fits one
    tensor copy's box; the rule takes the widest tile that fits, or None
    (the simple kernel) where that tile's CTA has under 4 warps or the
    launch fewer items than SMs, or no tile fits; a forced tile is that
    one or None."""
    def r32(n):
        return _round_up(n, 32)
    for n_codes in (S + 1, 16, 230):
        for Ppad in (128, 512, 4096, 16384, 100, 102):
            fits = [T for T in _build.SUMTABLE_TILES
                    if _build.sumtable_config(C, S, n_codes, Ppad, 1, T)]
            for T in fits:
                cf = _build.sumtable_config(C, S, n_codes, Ppad, 1, T)
                assert cf["T"] == T and Ppad % T == 0 and T % 4 == 0
                assert cf["SP"] == cf["IG"] * cf["RI"] >= S > \
                    cf["SP"] - cf["RI"]
                assert cf["threads"] == C * cf["IG"] * (T // 4) <= 256
                assert cf["smem"] == 128 + 4 * (
                    r32(32 + 2 * C * S * cf["SP"]
                        + 2 * C * n_codes * cf["SP"])
                    + 2 * r32(2 * r32(C * S * T) + 4 * T))
                assert cf["smem"] <= 227 * 1024 and C * S <= 256
            for E in (1, 13, 1000):
                cf = _build.sumtable_config(C, S, n_codes, Ppad, E)
                if not fits:
                    assert cf is None
                    continue
                widest = _build.sumtable_config(C, S, n_codes, Ppad, 1,
                                                fits[0])
                small = (widest["threads"] < 128
                         or E * (Ppad // fits[0]) < _build.SMS)
                assert cf == (None if small else widest)
    # no tile divides 102 patterns; at 64 states the bases and tables of 4
    # categories exceed a block; C·S 512 exceeds a tensor copy's box; more
    # than 64 states; DNA without categories makes CTAs of 2 warps
    assert _build.sumtable_config(C, S, S + 1, 102, 1000) is None
    assert _build.sumtable_config(4, 64, 65, 4096, 1000) is None
    assert _build.sumtable_config(32, 16, 17, 4096, 1000) is None
    assert _build.sumtable_config(C, 65, 66, 4096, 1000) is None
    assert _build.sumtable_config(1, 4, 5, 16384, 1000) is None
    assert _build.sumtable_config(4, 4, 5, 16384, 1000)["T"] == 256
