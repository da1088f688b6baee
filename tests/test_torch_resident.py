"""The resident path of the port (ops/resident.py) against the JAX
package's ``pallas_resident``: the same compiled table, and the plain
version of the CUDA kernel against the Pallas kernel in interpret mode
(float32, exact split=False contract) and against the float64 scan.
Tolerance: 1e-6 relative on logL (float32 summation order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_resident
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import fused, resident
from tests.torch_cases import lengths, make_case, rel_err
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

LOGL_RTOL = 1e-6


@pytest.mark.parametrize("seed,n_taxa,root_edge,n_slots_min", [
    (1, 9, None, None), (2, 31, 5, None), (3, 48, 0, 12), (4, 17, 3, None)])
def test_compile_resident_matches_jax(seed, n_taxa, root_edge, n_slots_min):
    case = make_case(seed, n_taxa, 16)
    want = pallas_resident.compile_resident(case.jpart, case.jtree,
                                            root_edge, n_slots_min)
    got = resident.compile_resident(case.tpart, case.tree, root_edge,
                                    n_slots_min)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]
    assert resident.resident_slot_bound(n_taxa) == \
        pallas_resident.resident_slot_bound(n_taxa)


@pytest.mark.parametrize("seed,n_taxa,n_sites,states,pinv", [
    (7, 24, 256, 4, 0.0), (8, 12, 128, 20, 0.2)])
def test_plain_resident_matches_jax_kernel(seed, n_taxa, n_sites, states,
                                           pinv):
    case = make_case(seed, n_taxa, n_sites, states=states, pinv=pinv)
    brl = case.jtree.lengths
    idx8, e1, e2, ns = pallas_resident.compile_resident(case.jpart,
                                                        case.jtree)
    tip_hi = pallas_resident.expanded_tip_planes(case.jpart)
    want = float(pallas_resident.loglikelihood_resident(
        case.jpart, idx8, jnp.asarray(brl, jnp.float32), (e1, e2), tip_hi,
        ns, True, False))
    t_idx8, t_e1, t_e2, t_ns = resident.compile_resident(case.tpart,
                                                         case.tree)
    got = resident.loglikelihood_resident(case.tpart, t_idx8, lengths(
        case.tree), (t_e1, t_e2), t_ns)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < LOGL_RTOL


@pytest.mark.parametrize("states,pinv", [(4, 0.0), (4, 0.25), (20, 0.0),
                                         (20, 0.25)])
def test_plain_resident_matches_jax_f64_scan(states, pinv):
    case = make_case(20 + states, 16, 192, states=states, pinv=pinv)
    want = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                               schedule="scan"))
    idx8, e1, e2, ns = resident.compile_resident(case.tpart, case.tree)
    got = resident.loglikelihood_resident(case.tpart, idx8,
                                          lengths(case.tree), (e1, e2), ns)
    assert rel_err(got, want) < LOGL_RTOL


def test_resident_walk_outputs():
    """The wrapper's outputs on the CPU: the root row's product [C·S,
    Ppad] float32, exactly rescaled (each site's max in [0.5, 1)), and
    its total scaler row [1, Ppad] int32."""
    case = make_case(31, 10, 128)
    idx8, e1, e2, ns = resident.compile_resident(case.tpart, case.tree)
    P5 = fused.pair_pmats(case.tpart, lengths(case.tree), e1, e2,
                          root_row=True)
    prod, sc = resident.resident_walk(idx8, P5, case.tpart.tip_states,
                                      fused.code_table(case.tpart), ns)
    assert prod.shape == (16, case.tpart.n_patterns_padded)
    assert sc.shape == (1, case.tpart.n_patterns_padded)
    assert sc.dtype == torch.int32
    assert torch.isfinite(prod).all() and (prod >= 0).all()
    # every site's root product was rescaled into [0.5, 1) at its max
    top = prod.amax(dim=0)
    assert ((top >= 0.5) & (top < 1.0)).all()


def test_resident_rejects_float64():
    case = make_case(32, 8, 64, dtype=jnp.float64)
    idx8, e1, e2, ns = resident.compile_resident(case.tpart, case.tree)
    with pytest.raises(PllModError, match="float32"):
        resident.loglikelihood_resident(case.tpart, idx8,
                                        lengths(case.tree), (e1, e2), ns)

