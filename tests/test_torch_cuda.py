"""The CUDA kernels on the card, against their plain versions: the walk
and sumtable kernels bit for bit (both round every product and sum
separately, in the same order); the derivative and Newton kernels, whose
pattern sums run in another order, to 2e-6 relative on logL and 2e-5 on
the derivatives, and 5e-4 on the Newton lengths.

JAX-free, so it runs on a machine that has the card and not the JAX
package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test here skips (the check runs in a fixture,
never at import)."""

import pytest
import torch

from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import _build, deriv, engine, fused, resident
from pllmod_tpu_torch.optimize import blo, blo_bounded

pytestmark = pytest.mark.cuda

# (states, cats): C·S = 16, 4, 80 (the main path's shapes), then the other
# register tiles (S ≤ 8, 16, 32, 64) and pattern tiles (C = 8: 32 patterns,
# C = 32: 8 patterns)
SHAPES = [(4, 4), (4, 1), (20, 4), (5, 4), (10, 4), (16, 8), (32, 2),
          (64, 4), (4, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _example(states, cats, cuda, n_taxa=24, n_sites=512):
    """The flagship recipe at ``states`` (a multistate alphabet beyond
    DNA and protein); p-inv 0.1 exercises the epilogue's mixture
    branch."""
    part, tree = flagship.example(n_taxa, n_sites, seed=40 + states + cats,
                                  states=states, n_rate_cats=cats,
                                  prop_invar=0.1, device="cpu")
    return part.cache_eigen().to(cuda), tree


def _brl(tree, part):
    return torch.as_tensor(tree.lengths, dtype=torch.float32,
                           device=part.device)


@pytest.mark.parametrize("states,cats", SHAPES)
def test_resident_kernel_matches_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    idx8, e1, e2, ns = resident.compile_resident(part, tree)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, fused.code_table(part), ns)
    before = resident.LAUNCHES
    prod_k, sc_k = resident.resident_walk(*args)
    assert resident.LAUNCHES == before + 1
    prod_p, sc_p = resident.resident_walk_plain(*args)
    assert torch.equal(prod_k, prod_p)
    assert torch.equal(sc_k, sc_p)


@pytest.mark.parametrize("states,cats", SHAPES)
def test_fused_kernel_matches_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    idx8, e1, e2, _, ns = fused.compile_fused(part, tree, fuse_root=True)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, fused.code_table(part), ns)
    before = fused.LAUNCHES
    clv_k, sc_k = fused.fused_walk(*args)
    assert fused.LAUNCHES == before + 1
    clv_p, sc_p = fused.fused_walk_plain(*args)
    assert torch.equal(clv_k, clv_p)
    assert torch.equal(sc_k, sc_p)


@pytest.mark.parametrize("states,cats", SHAPES)
def test_auto_schedule_matches_float64_scan(cuda, states, cats):
    """``auto`` runs a kernel for every float32 shape (never the serial
    engine) and agrees with the float64 scan."""
    part, tree = _example(states, cats, cuda)
    want = float(engine.tree_loglikelihood(part.to(dtype=torch.float64),
                                           tree, schedule="scan"))
    before = resident.LAUNCHES + fused.LAUNCHES
    got = float(engine.tree_loglikelihood(part, tree))
    assert resident.LAUNCHES + fused.LAUNCHES == before + 1
    assert abs(got - want) / abs(want) < 1e-6


@pytest.mark.parametrize("resident_walk", [True, False])
@pytest.mark.parametrize("states,cats,n_slots", [
    (4, 4, 10), (20, 4, 4), (20, 4, 10), (64, 4, 4), (4, 32, 17), (5, 1, 9)])
def test_smem_formula_matches_library(cuda, states, cats, n_slots,
                                      resident_walk):
    """The shared memory the routing rule counts is what a launch
    requests."""
    T = _build.pattern_tile(cats)
    n_codes = 16
    want = _build.load().pllmod_walk_smem_bytes(
        cats, states, n_codes, n_slots, T, int(resident_walk))
    assert _build.walk_smem_bytes(cats, states, n_codes, n_slots,
                                  resident_walk) == want


def test_cuda_tensors_never_take_the_plain_path(cuda):
    """A CUDA input the kernel rejects raises; it is not rerouted."""
    part, tree = _example(4, 4, cuda)
    idx8, e1, e2, ns = resident.compile_resident(part, tree)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    with pytest.raises(ValueError, match="float32"):
        resident.resident_walk(idx8, P5.double(), part.tip_states,
                               fused.code_table(part), ns)
    with pytest.raises(ValueError, match="CUDA device"):
        resident.resident_walk(idx8, P5, part.tip_states.cpu(),
                               fused.code_table(part), ns)
    with pytest.raises(PllModError, match="float32"):
        engine.tree_loglikelihood(part.to(dtype=torch.float64), tree,
                                  schedule="fused")
    wide, wtree = _example(64, 4, cuda)
    idx8, e1, e2, _ = resident.compile_resident(wide, wtree)
    P5 = fused.pair_pmats(wide, _brl(wtree, wide), e1, e2, root_row=True)
    with pytest.raises(ValueError, match="shared memory"):
        resident.resident_walk(idx8, P5, wide.tip_states,
                               fused.code_table(wide), 10)


def _directed(part, tree):
    """The directed-CLV buffers of ``tree`` at its lengths (fused kernel)
    and the BLO tables."""
    tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
    clvs, scalers = blo._directed_clvs(part, tabs, _brl(tree, part))
    return tabs, clvs, scalers


def _rel(got, want, floor):
    return float(((got - want).abs() / want.abs().clamp(min=floor)).max())


@pytest.mark.parametrize("states,cats", SHAPES)
def test_deriv_kernels_match_plain(cuda, states, cats):
    """Kernels 8, 9 and 10 at every register and pattern tile."""
    part, tree = _example(states, cats, cuda)
    tabs, clvs, scalers = _directed(part, tree)
    live = torch.as_tensor(blo.DirectedTraversal(tree).edge_mask,
                           device=cuda)
    args = (part, clvs, scalers, tabs.eref6, tabs.basis)
    before = dict(deriv.LAUNCHES)
    st, sc = deriv.edge_sumtables(*args)
    st_p, sc_p = deriv.edge_sumtables_plain(*args)
    assert torch.equal(st[live], st_p[live])
    assert torch.equal(sc[live], sc_p[live])
    t = _brl(tree, part)
    kw = dict(lw=tabs.lw, lnB=tabs.lnB)
    got = deriv.edge_derivatives_k(part, st, sc, t, **kw)
    want = deriv.edge_derivatives_plain(part, st, sc, t, **kw)
    assert _rel(got[0][live], want[0][live], 1e-3) < 2e-6
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g[live], w[live], 1.0) < 2e-5
    nk = deriv.newton_edges(part, st, sc, t, 1e-4, 100.0, 1e-4, 10, **kw)
    npl = deriv.newton_edges_plain(part, st, sc, t, 1e-4, 100.0, 1e-4, 10,
                                   **kw)
    torch.cuda.synchronize()
    assert _rel(nk[0][live], npl[0][live], 1e-4) < 5e-4
    assert _rel(nk[1][live], npl[1][live], 1e-2) < 2e-6
    assert {k: deriv.LAUNCHES[k] - before[k] for k in before} == \
        {"edge_sumtables": 1, "edge_derivatives": 1, "newton_edges": 1}


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (5, 4)])
def test_blo_on_card_matches_float64(cuda, states, cats):
    """The BLO's float32 kernel pipeline on the card: its logL is the
    float64 serial engine's at the returned lengths, and every kernel of
    the path launched."""
    part, tree = _example(states, cats, cuda)
    start = float(engine.tree_loglikelihood(part, tree))
    before = dict(deriv.LAUNCHES), fused.LAUNCHES
    _, lnl = blo.optimize_branch_lengths(part, tree)
    assert lnl >= start
    want = float(engine.tree_loglikelihood(part.to(dtype=torch.float64),
                                           tree, schedule="scan"))
    assert abs(lnl - want) / abs(want) < 1e-6
    assert all(deriv.LAUNCHES[k] > before[0][k] for k in before[0])
    assert fused.LAUNCHES > before[1]


@pytest.mark.parametrize("mode", ["safe", "local", "iterative", "bounded"])
def test_blo_modes_on_card(cuda, mode):
    """SAFE, local (only the edges around one move) and iterative-Newton
    BLO and the bounded sweep on the card: each ends at or above its
    start and reports the float64 engine's logL at its lengths."""
    part, tree = _example(4, 4, cuda)
    start = float(engine.tree_loglikelihood(part, tree))
    tr = tree.copy()
    if mode == "bounded":
        _, lnl = blo_bounded.optimize_branch_lengths_bounded(
            part, tr, seg_rows=16, seg_emits=4)
    else:
        kw = {"safe": dict(safe=True), "iterative": dict(fused_newton=False),
              "local": dict(around_edge=3, radius=1)}[mode]
        _, lnl = blo.optimize_branch_lengths(part, tr, **kw)
    assert lnl >= start
    want = float(engine.tree_loglikelihood(part.to(dtype=torch.float64), tr,
                                           schedule="scan"))
    assert abs(lnl - want) / abs(want) < 1e-6
    if mode == "local":
        moved = blo._edges_within_radius(tree, 3, 1)
        keep = [e for e in range(len(tree.lengths)) if e not in moved]
        start_len = torch.as_tensor(tree.lengths).clamp(1e-4, 100.0).float()
        assert torch.equal(torch.as_tensor(tr.lengths)[keep].float(),
                           start_len[keep])


def test_deriv_kernels_raise_on_bad_cuda_inputs(cuda):
    part, tree = _example(4, 4, cuda)
    tabs, clvs, scalers = _directed(part, tree)
    with pytest.raises(ValueError, match="float32"):
        deriv.edge_sumtables(part, clvs.double(), scalers, tabs.eref6)
    st, sc = deriv.edge_sumtables(part, clvs, scalers, tabs.eref6)
    with pytest.raises(ValueError, match="CUDA device"):
        deriv.edge_derivatives_k(part, st, sc.cpu(), _brl(tree, part))
    with pytest.raises(ValueError, match="max_iters"):
        deriv.newton_edges(part, st, sc, _brl(tree, part), 1e-4, 100.0,
                           1e-4, 0)
