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



# the resident walk's launch configuration (csrc/configs.h walk_config,
# read through the host library) and its tile rule
def test_resident_tile_fills_the_card_at_protein():
    """At the protein cell's shape (512 taxa: up to 12 live slots, 4096
    patterns, 20 states +G4) the tile gives at least 95 % of 132 SMs a
    CTA and its slots fit; at the flagship's (128 taxa, 16384 patterns,
    DNA +G4) the thread kind gives 95 % of them a CTA in one wave."""
    for ns in range(6, resident.resident_slot_bound(512) + 1):
        T = _build.resident_tile(4, 20, 21, ns, 4096)
        cf = _build.resident_config(4, 20, 21, ns, T)
        assert T in (32, 16) and cf["kind"] == "split"
        k = min(2, _build.ctas_per_sm(cf["threads"], cf["smem"]))
        assert -(-4096 // T) >= 0.95 * _build.SMS * k
    ns = resident.resident_slot_bound(128)
    T = _build.resident_tile(4, 4, 5, ns, 16384)
    cf = _build.resident_config(4, 4, 5, ns, T)
    assert cf["kind"] == "thread" and cf["RP"] == _build.RESIDENT_THREAD_RP
    assert 16384 // T >= 0.95 * _build.SMS
    assert _build.waves(cf, T, 16384) == 1


@pytest.mark.parametrize("ns", [3, 4, 5])
def test_resident_tile_takes_the_split_kind_at_the_supermatrix(ns):
    """At the 1KITE supermatrix's shape (144 taxa: 3-5 live slots,
    413,568 padded patterns, 20 states +G4, 21 codes) the split kind
    runs the parent's tile, 64 patterns, in the tile kind's shared
    memory: 256 consumer threads (two a column of two patterns) and a
    producer warp, one CTA an SM in 49 waves; every other launch field is
    the tile kind's."""
    T = _build.resident_tile(4, 20, 21, ns, 413_568)
    cf = _build.resident_config(4, 20, 21, ns, T)
    tile = _tile_kind_config(4, 20, 21, ns, T)
    assert T == 64 == _tile_kind_tile(4, 20, 21, ns, 413_568)
    assert cf["kind"] == "split" and tile["kind"] == "tile"
    assert cf["RP"] == 2 and cf["threads"] == 256 + 32
    assert {k: v for k, v in cf.items() if k not in ("kind", "RP",
                                                     "threads")} == \
        {k: v for k, v in tile.items() if k not in ("kind", "RP",
                                                    "threads")}
    assert _build.ctas_per_sm(cf["threads"], cf["smem"]) == 1
    assert _build.waves(cf, T, 413_568) == 49


def _thread_kind_expected(cats, states):
    return states <= 4 and cats <= 8


@pytest.mark.parametrize("states", [2, 3, 4, 5, 8, 10, 16, 20, 32, 64, 17,
                                    18])
def test_resident_config_across_the_state_ladder(states):
    """Every configuration fits a block (threads and shared memory), and
    its shared memory is the sum of its parts. The tile and global kinds:
    the ring's mbarriers and idx8 rows, four ring entries, the category
    maxima and the slots with their scaler rows; a ring entry holds the
    row's two tables and its tip codes (the tile kind) or the codes alone
    (the global kind). The split kind (the 20-state step, 17 to 20
    states, nowhere else): the tile kind's parts, two patterns a thread,
    two threads a column and a producer warp, where that fills whole
    warps. The thread kind (up to 4 states and
    8 categories, nowhere else): the full and empty mbarriers of its
    ring entries, the entries (an idx8 row, two tables, two rows of
    codes) and the slots with their scaler rows, whole consumer warps
    and a producer warp."""
    seen = set()
    split = _ladder(states) == 20
    for cats in (1, 2, 4, 8, 9, 32):
        for ns in (1, 3, 9, 12):
            for T in _build.TILES:
                cf = _build.resident_config(cats, states, states + 1, ns, T)
                if cf is None:
                    continue
                seen.add(cf["kind"])
                assert (cf["kind"] == "thread") == \
                    _thread_kind_expected(cats, states)
                assert cf["threads"] <= _build.MAX_THREADS + (
                    32 if cf["kind"] == "split" else 0)
                assert cf["smem"] <= _build.SMEM_PER_BLOCK
                if cf["kind"] == "thread":
                    rp, nb = cf["RP"], 4
                    assert rp == _build.RESIDENT_THREAD_RP
                    assert T % (32 * rp) == 0
                    assert cf["threads"] == T // rp + 32
                    assert cf["SP"] == 4
                    assert cf["Q"] == cats * (states + 1) * 4
                    assert cf["ring"] == 8 + 2 * cf["Q"] + 2 * T
                    assert cf["smem"] == 4 * (4 * nb + nb * cf["ring"]
                                              + ns * (cats * states + 1) * T)
                    continue
                # the global kind at the widest tile only
                assert cf["kind"] != "global" or T == _build.pattern_tile(cats)
                if cf["kind"] == "split":
                    assert split and cf["RP"] == 2
                    assert T % 2 == 0 and cats * T % 32 == 0
                    assert cf["threads"] == 2 * cats * T // 2 + 32
                else:
                    assert cf["threads"] == cats * T // cf["RP"]
                    assert cf["kind"] != "tile" or not split or \
                        T % 2 or cats * T % 32
                codes = -(-2 * T // 4) * 4
                assert cf["ring"] == codes + (2 * cf["Q"]
                                              if cf["kind"] != "global"
                                              else 0)
                fixed = (8 + 128 + -(-2 * cats * T // 4) * 4
                         + ns * (cats * states + 1) * T)
                assert cf["smem"] == 4 * (fixed + 4 * cf["ring"])
    assert seen & {"tile", "split"}
    assert seen <= {"tile", "global", "thread", "split"}
    assert ("thread" in seen) == (states <= 4)
    assert ("split" in seen) == split
    # a slot set that fits no tile is refused, not rerouted
    assert _build.resident_tile(4, states, states + 1, 4000, 4096) is None


# the resident walk's configuration and tile rule before the thread kind,
# copied here: every shape beyond 4 states or 8 categories keeps them
def _ladder(S):
    """The register tile that holds S states (the kernels' state ladder)."""
    return next(m for m in (4, 8, 16, 20, 32, 64) if S <= m)


def _tile_kind_config(C, S, n_codes, n_slots, T):
    maxs = _ladder(S)
    rp = 2 if maxs <= 4 else 1
    if T % rp or C * (T // rp) > 256:
        return None
    q = C * max(S, n_codes) * maxs
    fixed = (8 + 128 + -(-2 * C * T // 4) * 4 + n_slots * C * S * T
             + n_slots * T)
    codes = -(-2 * T // 4) * 4
    base = dict(RP=rp, SP=maxs, threads=C * (T // rp), Q=q)
    smem = 4 * (fixed + 4 * (2 * q + codes))
    if smem <= 232_448:
        return dict(kind="tile", ring=2 * q + codes, smem=smem, **base)
    smem = 4 * (fixed + 4 * codes)
    if T != _build.pattern_tile(C) or smem > 232_448:
        return None
    return dict(kind="global", ring=codes, smem=smem, **base)


def _tile_kind_tile(C, S, n_codes, n_slots, Ppad, config=None):
    config = config or _tile_kind_config
    staged = [(T, cf) for T in (128, 64, 32, 16, 8, 4, 2, 1)
              if (cf := config(C, S, n_codes, n_slots, T))
              and cf["kind"] in ("tile", "split")]
    for T, cf in staged:
        k = min(2, 2048 // cf["threads"], 233_472 // (cf["smem"] + 1024))
        if -(-Ppad // T) >= 0.95 * 132 * k:
            return T
    if staged:
        return staged[-1][0]
    T = _build.pattern_tile(C)
    return T if config(C, S, n_codes, n_slots, T) else None


def _split_kind_config(C, S, n_codes, n_slots, T):
    """At the 20-state step: where the tile kind fits and its C·T threads
    fill whole warps (T even), its configuration with two patterns a
    thread, two threads a column and a producer warp; else the
    configuration before the split kind."""
    cf = _tile_kind_config(C, S, n_codes, n_slots, T)
    if cf is None or cf["kind"] != "tile" or T % 2 or C * T % 32:
        return cf
    return dict(cf, kind="split", RP=2, threads=C * T + 32)


@pytest.mark.parametrize("states", [5, 8, 16, 20, 32, 64, 2, 4, 12, 17, 18,
                                    24])
def test_other_shapes_keep_the_tile_rule(states):
    """Beyond 4 states, and beyond 8 categories at up to 4 states, the
    configuration at every tile and the tile at every width are those of
    the tile and global kinds as they were before the thread kind. At
    the 20-state step (17 to 20 states) the split kind takes the tile
    kind's place wherever it fills whole warps, in the same shared
    memory, and the tile is the one the tile kind had."""
    want = _split_kind_config if states in (17, 18, 19, 20) \
        else _tile_kind_config
    for cats in ((1, 4, 8, 32) if states > 4 else (9, 16, 32)):
        for n_codes in (states + 1, 16):
            for ns in (3, 7, 12):
                for T in _build.TILES:
                    assert _build.resident_config(cats, states, n_codes, ns,
                                                  T) == \
                        want(cats, states, n_codes, ns, T)
                for Ppad in (128, 4096, 16384, 100_096):
                    T = _build.resident_tile(cats, states, n_codes, ns, Ppad)
                    assert T == _tile_kind_tile(cats, states, n_codes, ns,
                                                Ppad, want)
                    assert T == _tile_kind_tile(cats, states, n_codes, ns,
                                                Ppad)


@pytest.mark.parametrize("n_codes,n_slots", [(5, 7), (5, 6), (16, 7)])
def test_resident_tile_two_waves_at_capacity(n_codes, n_slots):
    """At 10,000 taxa × 100,096 padded patterns (DNA +G4; the capacity
    cell's five codes, or the sixteen of an IUPAC code table) the thread
    kind runs in two waves, each all but full: three CTAs of 128 patterns
    an SM, 782 CTAs, 1.97 of the 132 × 3 a wave holds."""
    T = _build.resident_tile(4, 4, n_codes, n_slots, 100_096)
    cf = _build.resident_config(4, 4, n_codes, n_slots, T)
    assert cf["kind"] == "thread" and T == 128
    k = _build.ctas_per_sm(cf["threads"], cf["smem"])
    assert k == 3 and _build.waves(cf, T, 100_096) == 2
    assert 100_096 / T / (_build.SMS * k) > 1.95
    # no tile of the thread kind takes fewer waves
    assert all(_build.waves(c, t, 100_096) >= 2 for t in _build.TILES
               if (c := _build.resident_config(4, 4, n_codes, n_slots, t)))


@pytest.mark.parametrize("Ppad,want", [(4480, 32), (16384, 128), (128, 32),
                                       (100, 32)])
def test_resident_tile_thread_kind_fills_the_card(Ppad, want):
    """In one wave the thread kind takes the widest tile whose grid gives
    95 % of the SMs a CTA, else the narrowest (the 246 × 4465 cell's 4480
    patterns: 140 CTAs of 32)."""
    assert _build.resident_tile(4, 4, 16, 7, Ppad) == want


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
