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
from pllmod_tpu_torch.ops import _build, fused, resident
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



# the resident walk's launch configuration (pure Python, the mirror of
# csrc/pruning.cu walk_config that the card tests hold to the library)
def test_resident_tile_fills_the_card_at_protein():
    """At the protein cell's shape (512 taxa: up to 12 live slots, 4096
    patterns, 20 states +G4) the tile gives at least 95 % of 132 SMs a
    CTA and its slots fit; at the flagship's (128 taxa, 16384 patterns,
    DNA +G4) two CTAs an SM."""
    for ns in range(6, resident.resident_slot_bound(512) + 1):
        T = _build.resident_tile(4, 20, 21, ns, 4096)
        cf = _build.resident_config(4, 20, 21, ns, T)
        assert T in (32, 16) and cf["kind"] == "tile"
        k = min(2, _build.ctas_per_sm(cf["threads"], cf["smem"]))
        assert -(-4096 // T) >= 0.95 * _build.SMS * k
    ns = resident.resident_slot_bound(128)
    T = _build.resident_tile(4, 4, 5, ns, 16384)
    cf = _build.resident_config(4, 4, 5, ns, T)
    assert cf["kind"] == "tile" and cf["RP"] == 2
    assert 16384 // T >= 0.95 * _build.SMS * 2


@pytest.mark.parametrize("states", [2, 4, 5, 8, 10, 16, 20, 32, 64])
def test_resident_config_across_the_state_ladder(states):
    """Every configuration fits a block (threads and shared memory), and
    its shared memory is the sum of its parts: the ring's mbarriers and
    idx8 rows, four ring entries, the category maxima and the slots with
    their scaler rows; a ring entry holds the row's two tables and its tip
    codes (the tile kind) or the codes alone (the global kind)."""
    seen = set()
    for cats in (1, 4, 8, 32):
        for ns in (3, 9, 12):
            for T in _build.TILES:
                cf = _build.resident_config(cats, states, states + 1, ns, T)
                if cf is None:
                    continue
                seen.add(cf["kind"])
                # the global kind at the widest tile only
                assert cf["kind"] == "tile" or T == _build.pattern_tile(cats)
                assert cf["threads"] <= _build.MAX_THREADS
                assert cf["smem"] <= _build.SMEM_PER_BLOCK
                assert cf["threads"] == cats * T // cf["RP"]
                codes = -(-2 * T // 4) * 4
                assert cf["ring"] == codes + (2 * cf["Q"]
                                              if cf["kind"] == "tile" else 0)
                fixed = (8 + 128 + -(-2 * cats * T // 4) * 4
                         + ns * (cats * states + 1) * T)
                assert cf["smem"] == 4 * (fixed + 4 * cf["ring"])
    assert "tile" in seen and seen <= {"tile", "global"}
    # a slot set that fits no tile is refused, not rerouted
    assert _build.resident_tile(4, states, states + 1, 4000, 4096) is None


def test_walk_launch_config_is_cached_per_shape():
    """The wrappers' tile and configuration come from one cached call a
    shape (the bounded sweep issues hundreds of short walks a call)."""
    _build.walk_launch_config.cache_clear()
    for _ in range(3):
        T, cf = _build.walk_launch_config("pllmod_resident_walk", 4, 4, 5, 9,
                                          16384)
        Tf, cff = _build.walk_launch_config("pllmod_fused_walk", 4, 4, 5, 9,
                                            16384)
    info = _build.walk_launch_config.cache_info()
    assert (info.hits, info.misses) == (4, 2)
    assert T == _build.resident_tile(4, 4, 5, 9, 16384)
    assert Tf == _build.fused_tile(4, 4, 5, 16384)
    with pytest.raises(ValueError, match="shared memory"):
        _build.walk_launch_config("pllmod_resident_walk", 4, 64, 65, 4000,
                                  4096)
