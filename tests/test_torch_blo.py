"""The port's branch-length optimization (optimize/blo.py,
optimize/blo_bounded.py) against the JAX package: the directed-CLV
schedule and edge colors (exact), the whole driver in float32 (the
kernel pipeline through the kernels' plain versions) and float64 (the
plain path), SAFE and local modes, the reference's BLO goldens through
the port's derivatives and Newton, and the memory-bounded sweep (its
tables exact, its optimum within the JAX package's 0.05 bar)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pllmod_tpu.native as jax_native
import pllmod_tpu_torch.native as torch_native
from pllmod_tpu.ops import pallas_clv
from pllmod_tpu.optimize import blo as jax_blo
from pllmod_tpu.optimize import blo_bounded as jax_bounded
from pllmod_tpu_torch.ops import charmap as torch_charmap
from pllmod_tpu_torch.ops import clv, derivatives, engine, fused
from pllmod_tpu_torch.ops import likelihood as lk
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.optimize import blo, blo_bounded
from pllmod_tpu_torch.optimize.newton import minimize_newton_multi
from tests import reference_impl as ref
from tests.test_reference_parity import (ALPHA, BRLENS, BRLENS5_OPT, FREQS4,
                                         LOGL5_INITIAL, LOGL5_OPTIMIZED,
                                         LOGL_INITIAL, LOGL_OPTIMIZED, SUBST,
                                         TIP1, TIP2, TIP3)
from tests.test_torch_partition import ODD5
from tests.torch_cases import make_case, to_torch, to_torch_tree
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _blo_case(seed=41, n_taxa=10, n_sites=200, pinv=0.15):
    """Tree-signal data (sequences simulated along the tree)."""
    return make_case(seed, n_taxa, n_sites, pinv=pinv, symbols="ACGT")


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("n", [5, 17, 40])
def test_directed_traversal_matches_jax(n, native, monkeypatch):
    if not native:
        monkeypatch.setattr(torch_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    jtree = ref.random_binary_tree(np.random.default_rng(n), n)
    want = jax_blo.DirectedTraversal(jtree)
    got = blo.DirectedTraversal(to_torch_tree(jtree))
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.edge_ref, want.edge_ref)
    np.testing.assert_array_equal(got.edge_mask, want.edge_mask)
    assert got.slot_of == want.slot_of
    for a, b in zip(blo._edge_colors(to_torch_tree(jtree)),
                    jax_blo._edge_colors(jtree), strict=True):
        np.testing.assert_array_equal(a, b)


def test_compile_fused_ops_serial_and_padded_match_jax():
    case = make_case(42, 20, 16)
    ops, (u, v, _) = case.jtree.traversal_ops()
    ops_b, _, _ = clv.bounded_slot_ops(ops, case.tpart.n_tips,
                                       root_refs=(u, v))
    for kw in (dict(serial=True), dict(serial=True, pad_to=40,
                                       n_slots_min=12),
               dict(pad_to=30)):
        src = ops_b if kw.get("serial") else ops
        want = pallas_clv.compile_fused_ops(case.jpart, src, **kw)
        got = fused.compile_fused_ops(case.tpart, src, **kw)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert got[3] == want[3]


def test_directed_table_keeps_last_row_matrices():
    """A directed table has no root row: pair_pmats(root_row=False)
    leaves its last row (P(t_e1), P(t_e2)); root_row=True would put
    (diag(freqs), P) there."""
    case = make_case(43, 9, 32)
    trav = blo.DirectedTraversal(case.tree)
    idx8, e1, e2, _ = fused.compile_fused_ops(case.tpart, trav.ops)
    e1, e2 = torch.as_tensor(e1), torch.as_tensor(e2)
    brl = torch.as_tensor(case.tree.lengths, dtype=torch.float32)
    P5 = fused.pair_pmats(case.tpart, brl, e1, e2, root_row=False)
    P = case.tpart.prob_matrices(brl).to(torch.float32)
    assert torch.equal(P5[-1, 0], P[e1[-1]])
    assert torch.equal(P5[-1, 1], P[e2[-1]])
    rooted = fused.pair_pmats(case.tpart, brl, e1, e2, root_row=True)
    assert torch.equal(rooted[:-1], P5[:-1])
    assert not torch.equal(rooted[-1, 0], P5[-1, 0])


def test_fused_walk_out_keeps_unwritten_slots():
    """fused_walk(out=...) writes in place and leaves the slots the
    table does not write as they were (the bounded sweep's carried
    buffer)."""
    case = make_case(44, 9, 32)
    trav = blo.DirectedTraversal(case.tree)
    tabs = blo._compile_tables(case.tpart, trav)
    brl = torch.as_tensor(case.tree.lengths, dtype=torch.float32)
    clvs, scalers = blo._directed_clvs(case.tpart, tabs, brl)
    half = tabs.idx8[: len(tabs.idx8) // 2]
    prior = (torch.full_like(clvs, 7.0), torch.full_like(scalers, 3))
    P5 = fused.pair_pmats(case.tpart, brl, tabs.e1[:len(half)],
                          tabs.e2[:len(half)], root_row=False)
    out = fused.fused_walk(half, P5, case.tpart.tip_states, tabs.codetab,
                           tabs.n_slots, out=prior)
    assert out[0] is prior[0] and out[1] is prior[1]
    written = half[:, 6].long()
    assert torch.equal(prior[0][written], clvs[written])
    keep = torch.ones(tabs.n_slots, dtype=torch.bool)
    keep[written] = False
    assert bool((prior[0][keep] == 7.0).all())
    assert bool((prior[1][keep] == 3).all())


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def test_blo_matches_jax():
    """The float32 kernel pipeline (plain versions on the CPU) reaches at
    least the JAX package's optimum (XLA path), with the fused Newton and
    with minimize_newton_multi over kernel 9; its logL is the float64
    serial engine's at the returned lengths (1e-5). The float64 plain
    path reaches the same optimum."""
    case = _blo_case()
    _, l_jax = jax_blo.optimize_branch_lengths(
        case.jpart, case.jtree.copy(), max_sweeps=24, tolerance=1e-8)
    part64 = to_torch(case.jpart64)
    for fused_newton in (True, False):
        tree = case.tree.copy()
        stats = {}
        _, l_got = blo.optimize_branch_lengths(
            case.tpart, tree, max_sweeps=24, tolerance=1e-8,
            fused_newton=fused_newton, stats=stats)
        assert l_got >= l_jax - 1e-4 * abs(l_jax)
        l64 = float(engine.tree_loglikelihood(part64, tree, schedule="scan"))
        assert abs(l_got - l64) / abs(l64) < 1e-5
        assert stats["sweeps"] >= 2 and stats["sub_sweeps"] > stats["sweeps"]
        assert (stats["newton_edges"] > 0) == fused_newton
    b64, l64 = blo.optimize_branch_lengths(part64, case.tree.copy(),
                                           max_sweeps=24, tolerance=1e-8)
    assert b64.dtype == torch.float64
    assert abs(l64 - l_jax) / abs(l_jax) < 1e-5


def test_blo_safe_and_local_modes():
    """SAFE never ends below the start; a local BLO (``edges=`` or
    ``around_edge=``) moves only its edges."""
    case = _blo_case(seed=46, n_taxa=8, n_sites=96)
    start = float(engine.tree_loglikelihood(case.tpart, case.tree,
                                            schedule="scan"))
    tree = case.tree.copy()
    _, l_safe = blo.optimize_branch_lengths(case.tpart, tree, safe=True)
    assert l_safe >= start
    clipped = np.clip(case.tree.lengths, 1e-4, 100.0)
    for kw, moved in ((dict(edges=[0, 3, 5]), {0, 3, 5}),
                      (dict(around_edge=4, radius=1),
                       set(blo._edges_within_radius(case.tree, 4, 1)))):
        tree = case.tree.copy()
        br, l_loc = blo.optimize_branch_lengths(case.tpart, tree, **kw)
        still = [e for e in range(len(clipped)) if e not in moved]
        np.testing.assert_array_equal(tree.lengths[still],
                                      clipped.astype(np.float32)[still])
        assert l_loc >= start


# ---------------------------------------------------------------------------
# the reference's goldens through the port (test_reference_parity)
# ---------------------------------------------------------------------------
def _fixture_partition():
    return create_partition(["ACGT", "ACGT", "ACGT"], states=4,
                            n_rate_cats=4, alpha=ALPHA, subst_rates=SUBST,
                            freqs=FREQS4, compress=False,
                            dtype=torch.float64, device="cpu").cache_eigen()


def _pad_clv(part, clv_):
    out = np.ones((part.n_patterns_padded, 4, 4))
    out[:4] = clv_
    return torch.as_tensor(out)


def _star_lnl(part, brlens):
    init = torch.stack([_pad_clv(part, t) for t in (TIP1, TIP2, TIP3, TIP1)])
    ops = np.asarray([[-1, 0, 0, 0, 0]] * 3 + [[3, 3, 0, 4, 1]], np.int32)
    P = part.prob_matrices(brlens)
    clvs, scalers = clv.update_partials(part, P, ops, init_clvs=init)
    return float(lk.edge_loglikelihood(part, clvs, scalers, 6, 5, P[2]))


def _star_blo(part, tips, brlens, n_sweeps=6, tol=1e-5):
    """Per-branch bracketed Newton on the 3-branch star through the
    port's derivatives and Newton."""
    eigen = part.eigen()
    brlens = np.array(brlens, float)
    zeros = torch.zeros(part.n_patterns_padded, dtype=torch.int32)
    for _ in range(n_sweeps):
        for i in range(3):
            j, k = [x for x in range(3) if x != i]
            P = part.prob_matrices(brlens)
            rj = torch.einsum("cij,pcj->pci", P[j], tips[j])
            rk = torch.einsum("cij,pcj->pci", P[k], tips[k])
            st = derivatives.sumtable(part, rj * rk, tips[i], eigen)

            def deriv_fn(x):
                _, df, ddf = derivatives.edge_derivatives(part, st, zeros,
                                                          x[0], eigen)
                return df[None], ddf[None]

            t_new = minimize_newton_multi(
                deriv_fn, torch.tensor([brlens[i]], dtype=torch.float64),
                1e-4, 1e3, tol=tol, max_iters=32)
            brlens[i] = float(t_new[0])
    return brlens


def test_blo_matches_reference_golden():
    part = _fixture_partition()
    assert _star_lnl(part, BRLENS) == pytest.approx(LOGL_INITIAL, abs=1e-6)
    tips = [_pad_clv(part, t) for t in (TIP1, TIP2, TIP3)]
    opt = _star_blo(part, tips, BRLENS)
    assert opt[0] > 10.0                         # 92.854094 in reference
    assert opt[1] < 5e-4 and opt[2] < 5e-4       # 0.000110
    assert _star_lnl(part, opt) == pytest.approx(LOGL_OPTIMIZED, abs=1e-3)


def _fixture5():
    cmap = torch_charmap.custom(5, ODD5, name="odd5")
    subst5 = np.array([1.452176, 0.937951, 0.462880, 0.617729, 1.745312,
                       0.937951, 0.462880, 0.617729, 1.745312, 1.0])
    part = create_partition(["DABC", "DAEC", "DEEC"], charmap=cmap,
                            n_rate_cats=4, alpha=ALPHA, subst_rates=subst5,
                            freqs=np.full(5, 0.2), compress=False,
                            dtype=torch.float64, device="cpu")
    return part.cache_eigen()


def _star5_eval(part, brlens):
    P = part.prob_matrices(brlens)
    clvs, scalers = clv.update_partials(
        part, P, np.asarray([[0, 0, 0, 1, 1]], np.int32))
    return float(lk.edge_loglikelihood(part, clvs, scalers, 3, 2, P[2]))


def test_5state_initial_logl_matches_golden():
    assert _star5_eval(_fixture5(), BRLENS) == pytest.approx(LOGL5_INITIAL,
                                                             abs=1e-6)


def test_5state_logl_at_reference_optimum():
    assert _star5_eval(_fixture5(), BRLENS5_OPT) == pytest.approx(
        LOGL5_OPTIMIZED, abs=1e-5)


def test_5state_blo_matches_or_beats_golden():
    part = _fixture5()
    tips = [clv.tip_clv(part, i)[:, None, :].expand(-1, 4, -1)
            for i in range(3)]
    opt = _star_blo(part, tips, BRLENS)
    assert _star5_eval(part, opt) >= LOGL5_OPTIMIZED - 1e-6
    np.testing.assert_allclose(opt, BRLENS5_OPT, atol=0.05)


# ---------------------------------------------------------------------------
# the memory-bounded sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,segs", [(12, (16, 4)), (33, (64, 16))])
def test_bounded_schedule_matches_jax(n, segs):
    case = make_case(47 + n, n, 16)
    want = jax_bounded.BoundedSweepSchedule(case.jtree, *segs)
    got = blo_bounded.BoundedSweepSchedule(case.tree, *segs)
    for f in ("seg_ops", "seg_edges", "seg_refs", "seg_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.n_slots, got.n_rows, got.n_emits) == \
        (want.n_slots, want.n_rows, want.n_emits)
    blo_bounded.validate_schedule(got, case.tree)
    for g, w in zip(got.compile_tables(case.tpart),
                    want.compile_tables(case.jpart), strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("colored", [True, False])
def test_bounded_blo_matches_full(colored):
    """The bounded sweep reaches the full driver's optimum (the JAX
    package's bar, 0.05) and reports the logL of its lengths."""
    case = make_case(48, 10, 128, symbols="ACGT")
    tree0 = case.tree.copy()
    tree0.lengths = np.clip(tree0.lengths * 2.5 + 0.03, 1e-4, 10.0)
    _, l_full = blo.optimize_branch_lengths(case.tpart, tree0.copy(),
                                            tolerance=1e-6)
    t_b = tree0.copy()
    _, l_b = blo_bounded.optimize_branch_lengths_bounded(
        case.tpart, t_b, seg_rows=16, seg_emits=4, tolerance=1e-6,
        colored=colored)
    assert l_b == pytest.approx(l_full, abs=0.05)
    l_check = float(engine.tree_loglikelihood(case.tpart, t_b,
                                              schedule="scan"))
    assert l_check == pytest.approx(l_b, rel=2e-6)


def test_mem_budget_routes_to_bounded(monkeypatch):
    """Whole-tree smoothing past ``mem_budget`` runs the bounded sweep;
    a local BLO and a float64 partition never do."""
    case = make_case(50, 10, 32)
    calls = []
    monkeypatch.setattr(blo_bounded, "optimize_branch_lengths_bounded",
                        lambda *a, **k: calls.append(k) or (None, 0.0))
    blo.optimize_branch_lengths(case.tpart, case.tree.copy(), mem_budget=1,
                                fused_newton=False)
    assert len(calls) == 1 and calls[0]["fused_newton"] is False
    blo.optimize_branch_lengths(case.tpart, case.tree.copy(), max_sweeps=1,
                                edges=[0, 1], mem_budget=1)
    assert len(calls) == 1
    assert blo._bounded_blo_auto(case.tpart, case.tree, 1)
    assert not blo._bounded_blo_auto(case.tpart, case.tree,
                                     blo.BLO_MEM_BUDGET)
    assert not blo._bounded_blo_auto(to_torch(case.jpart64), case.tree, 1)


def test_loglikelihood_bounded_fused_matches_scan():
    case = make_case(49, 30, 64, pinv=0.2)
    got, n_slots = engine.loglikelihood_bounded_fused(case.tpart, case.tree)
    want = float(engine.tree_loglikelihood(to_torch(case.jpart64), case.tree,
                                           schedule="scan"))
    assert abs(float(got) - want) / abs(want) < 1e-6
    assert n_slots < case.tree.n_tips // 2
