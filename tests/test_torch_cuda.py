"""The CUDA kernels on the card, against their plain versions (bit for
bit: both round every product and sum separately, in the same order).

JAX-free, so it runs on a machine that has the card and not the JAX
package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test here skips (the check runs in a fixture,
never at import)."""

import pytest
import torch

from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import _build, engine, fused, resident

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
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2)
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
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2)
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
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2)
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
    P5 = fused.pair_pmats(wide, _brl(wtree, wide), e1, e2)
    with pytest.raises(ValueError, match="shared memory"):
        resident.resident_walk(idx8, P5, wide.tip_states,
                               fused.code_table(wide), 10)
