"""``engine.tree_loglikelihood`` of the port, every schedule, against the
JAX float64 scan and the numpy brute force of ``tests/reference_impl``:
1e-6 relative for the float32 kernel schedules (their plain versions on
the CPU), 1e-10 for the float64 scan. Plus virtual-root invariance, the
reference's 5-state and blopt-minimal goldens, the bounded engine at 1k
taxa and the ``auto`` routing rule."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import _build, charmap, engine
from pllmod_tpu_torch.ops import clv as clv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree
from tests import reference_impl as ref
from tests.test_reference_parity import (ALPHA, BRLENS, FREQS4,
                                         LOGL5_INITIAL, LOGL5_OPTIMIZED,
                                         LOGL_INITIAL, SUBST, TIP1, TIP2,
                                         TIP3, BRLENS5_OPT)
from tests.torch_cases import make_case, rel_err, to_torch, to_torch_tree
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

F32_RTOL = 1e-6
F64_RTOL = 1e-10
ODD5 = {"A": 0x01, "B": 0x02, "C": 0x04, "D": 0x08, "E": 0x0c,
        "-": 0x1f, "?": 0x1f}
# (states, cats): C·S = 16 (DNA+Γ4), 4 (DNA), 20 (5-state+Γ4), 80 (AA+Γ4),
# 256 (the widest multistate alphabet +Γ4), 128 (DNA, 32 categories)
SHAPES = [(4, 4), (4, 1), (5, 4), (20, 4), (64, 4), (4, 32)]


def _case(states, cats, pinv=0.0, seed=None, n_taxa=10, n_sites=96):
    cmap = {5: jax_charmap.custom(5, ODD5, "odd5"),
            64: jax_charmap.multistate(64)}.get(states)
    return make_case(seed if seed is not None else 100 + states + cats,
                     n_taxa, n_sites, states=states, cats=cats, pinv=pinv,
                     charmap=cmap)


@pytest.fixture(scope="module")
def f64_cases():
    """(case, JAX float64 scan logL) per (states, cats), made once a
    module: every schedule of a shape is held against the same numbers."""
    cache = {}

    def get(states, cats):
        if (states, cats) not in cache:
            case = _case(states, cats, pinv=0.1)
            cache[states, cats] = (case, float(jax_engine.tree_loglikelihood(
                case.jpart64, case.jtree, schedule="scan")))
        return cache[states, cats]
    return get


@pytest.mark.parametrize("schedule", ["auto", "resident", "fused", "pallas",
                                      "levels", "scan"])
@pytest.mark.parametrize("states,cats", SHAPES)
def test_every_schedule_matches_jax_f64(f64_cases, states, cats, schedule):
    case, want = f64_cases(states, cats)
    got = engine.tree_loglikelihood(case.tpart, case.tree, schedule=schedule)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < F32_RTOL
    got64 = engine.tree_loglikelihood(to_torch(case.jpart64), case.tree,
                                      schedule="scan")
    assert got64.dtype == torch.float64
    assert rel_err(got64, want) < F64_RTOL


@pytest.mark.parametrize("pinv", [0.0, 0.3])
def test_matches_brute_force(pinv):
    """DNA+Γ4 on uncompressed sites against the independent recursive
    pruning with scipy matrix exponentials."""
    rng = np.random.default_rng(9)
    jtree = ref.random_binary_tree(rng, 8)
    seqs = ref.random_sequences(rng, 8, 60)
    rates = rng.uniform(0.5, 2.0, 6)
    freqs = rng.dirichlet([6] * 4)
    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=0.9,
                            subst_rates=rates, freqs=freqs, prop_invar=pinv,
                            compress=False, dtype=torch.float64,
                            device="cpu")
    codes, masks = charmap.DNA.encode(seqs)
    want, _ = ref.brute_force_loglh(jtree, masks[codes], rates, freqs,
                                    part.rate_cats.numpy(),
                                    part.rate_weights.numpy(), pinv)
    tree = to_torch_tree(jtree)
    assert rel_err(engine.tree_loglikelihood(part, tree), want) < F64_RTOL
    part32 = part.to(dtype=torch.float32)
    for schedule in ("resident", "fused"):
        got = engine.tree_loglikelihood(part32, tree, schedule=schedule)
        assert rel_err(got, want) < F32_RTOL


@pytest.mark.parametrize("schedule", ["resident", "fused", "scan"])
def test_virtual_root_invariance(schedule):
    """Any virtual-root edge (tip edges included) gives the same logL
    (pulley principle)."""
    case = _case(4, 4, pinv=0.05, seed=17, n_taxa=12)
    part = case.tpart if schedule != "scan" else to_torch(case.jpart64)
    rtol = F64_RTOL if schedule == "scan" else F32_RTOL
    vals = [float(engine.tree_loglikelihood(part, case.tree, root_edge=e,
                                            schedule=schedule))
            for e in range(len(case.tree.lengths))]
    np.testing.assert_allclose(vals, vals[0], rtol=rtol, atol=0)


def test_blopt_minimal_initial_logl_golden():
    """The reference's blopt-minimal fixture (literal tip CLVs injected
    as starting buffers; masked rows skipped)."""
    part = create_partition(["ACGT", "ACGT", "ACGT"], states=4,
                            n_rate_cats=4, alpha=ALPHA, subst_rates=SUBST,
                            freqs=FREQS4, compress=False,
                            dtype=torch.float64, device="cpu")
    P = part.prob_matrices(BRLENS)

    def pad(clv):
        out = torch.ones((part.n_patterns_padded, 4, 4), dtype=torch.float64)
        out[:4] = torch.as_tensor(clv)
        return out

    init = torch.stack([pad(TIP1), pad(TIP2), pad(TIP3), pad(TIP1)])
    ops = np.asarray([[-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0],
                      [3, 3 + 0, 0, 3 + 1, 1]], np.int32)
    clvs, scalers = clv_mod.update_partials(part, P, ops, init_clvs=init)
    logl = float(lk_mod.edge_loglikelihood(part, clvs, scalers, 3 + 3,
                                           3 + 2, P[2]))
    assert logl == pytest.approx(LOGL_INITIAL, abs=1e-6)


@pytest.mark.parametrize("brlens,golden,tol", [
    (BRLENS, LOGL5_INITIAL, 1e-6), (BRLENS5_OPT, LOGL5_OPTIMIZED, 1e-5)])
def test_5state_goldens(brlens, golden, tol):
    """The reference's blopt-5states fixture (odd state count, an
    ambiguity code), at its initial and its optimized branch lengths."""
    part = create_partition(
        ["DABC", "DAEC", "DEEC"], charmap=charmap.custom(5, ODD5, "odd5"),
        n_rate_cats=4, alpha=ALPHA,
        subst_rates=np.array([1.452176, 0.937951, 0.462880, 0.617729,
                              1.745312, 0.937951, 0.462880, 0.617729,
                              1.745312, 1.0]),
        freqs=np.full(5, 0.2), compress=False, dtype=torch.float64,
        device="cpu")
    P = part.prob_matrices(brlens)
    clvs, scalers = clv_mod.update_partials(
        part, P, np.asarray([[0, 0, 0, 1, 1]], np.int32))
    logl = float(lk_mod.edge_loglikelihood(part, clvs, scalers, 3 + 0, 2,
                                           P[2]))
    assert logl == pytest.approx(golden, abs=tol)


def test_bounded_1k_taxa():
    """1000 taxa: the slot-recycled serial engine holds ≤ ⌈log2 n⌉+3 CLV
    slots and equals the JAX bounded engine and the full scan."""
    rng = np.random.default_rng(23)
    n = 1000
    jtree = ref.random_binary_tree(rng, n)
    seqs = ref.random_sequences(rng, n, 48)
    jpart = jax_create(seqs, states=4, n_rate_cats=4, alpha=0.9,
                       prop_invar=0.1, dtype=jnp.float64)
    want, want_slots = jax_engine.loglikelihood_bounded(jpart, jtree)
    part, tree = to_torch(jpart), to_torch_tree(jtree)
    got, n_slots = engine.loglikelihood_bounded(part, tree)
    assert n_slots == want_slots
    assert n_slots <= int(np.ceil(np.log2(n))) + 3
    assert rel_err(got, float(want)) < F64_RTOL
    full = engine.tree_loglikelihood(part, tree, schedule="scan")
    assert rel_err(got, full) < F64_RTOL


def _alignment(states, n_taxa, cmap=None):
    """n_taxa copies of one row holding every state once."""
    syms = {4: "ACGT", 20: charmap.AA_ORDER}.get(
        states, charmap.MULTI_SYMBOLS[:states])
    return create_partition([syms] * n_taxa, states=states, charmap=cmap,
                            n_rate_cats=4, alpha=0.5, device="cpu")


def test_auto_routing_rule():
    """Resident while the tree's live slots and a ring of its row tables
    fit a block's shared memory at some pattern tile, fused beyond them,
    the serial engine for float64; never the serial engine for a float32
    partition, however wide."""
    for states in (4, 5, 20):
        case = _case(states, 4)
        ev = engine.compile_fast_eval(case.tpart, case.tree)
        assert ev.schedule == "resident"
    ev = engine.compile_fast_eval(to_torch(case.jpart64), case.tree)
    assert ev.schedule == "scan"
    prot = _alignment(20, 512, charmap.AA)
    tree = Tree.from_newick(flagship.random_newick(
        512, np.random.default_rng(3)))
    assert engine.compile_fast_eval(prot, tree).schedule == "resident"
    wide = _alignment(64, 8, charmap.multistate(64))
    assert engine.auto_schedule(wide, n_slots=4) == "fused"
    for part, ns in ((prot, 6), (prot, 12), (wide, 2), (wide, 4)):
        shape = (part.n_cats, part.states, part.code_clv.shape[0], ns)
        T = _build.resident_tile(*shape, part.n_patterns_padded)
        fits = T is not None and \
            _build.resident_config(*shape, T)["kind"] in ("tile", "split")
        assert fits == (engine.auto_schedule(part, ns) == "resident")


@pytest.mark.parametrize("cell,want", [
    (dict(n_taxa=128, n_sites=16384, seed=3), "resident"),     # flagship
    (dict(n_taxa=512, n_sites=4096, seed=5, states=20), "resident"),
    (dict(n_taxa=128, n_sites=4096, seed=7, states=64), "fused"),
], ids=["flagship", "protein", "64-state"])
def test_routing_rule_at_the_cells(cell, want):
    """``auto`` at the shapes of the three cells (their trees' own live
    slot counts, +G4, patterns padded to 128): the walk that the routing
    sweep measured faster there (PERF.md)."""
    from types import SimpleNamespace
    from pllmod_tpu_torch.ops import resident
    states = cell.get("states", 4)
    _, newick, _, _ = flagship.example_data(**cell)
    tree = Tree.from_newick(newick)
    part = SimpleNamespace(
        n_tips=cell["n_taxa"], device="cpu", n_cats=4, states=states,
        code_clv=torch.zeros(states + 1, states), dtype=torch.float32,
        n_patterns_padded=-(-cell["n_sites"] // 128) * 128)
    n_slots = resident.compile_resident(part, tree)[3]
    assert engine.fast_eval_schedule(part, n_slots) == want
    assert engine.auto_schedule(part, n_slots) == want


# the routing sweep's shapes (chip_smoke.py, PERF.md): (states,
# categories, live slots, padded patterns) and the walk measured faster
SWEEP_ROUTES = [
    (4, 4, 4, 16384, "resident"), (20, 4, 4, 16384, "resident"),
    (32, 4, 4, 16384, "resident"), (64, 4, 4, 16384, "fused"),
    (4, 1, 3, 4096, "resident"), (32, 4, 3, 4096, "resident"),
    (16, 4, 6, 4096, "resident"), (16, 4, 9, 4096, "resident"),
    (16, 4, 10, 4096, "resident"), (16, 4, 12, 4096, "resident"),
    (20, 4, 6, 4096, "resident"), (20, 4, 12, 4096, "resident"),
    (32, 4, 5, 4096, "resident"), (32, 4, 6, 4096, "fused"),
    (32, 4, 7, 4096, "fused"), (32, 4, 11, 4096, "fused"),
    (32, 4, 12, 4096, "fused"), (64, 1, 6, 4096, "resident"),
    (64, 1, 11, 4096, "resident"), (64, 1, 12, 4096, "fused"),
    (64, 4, 3, 4096, "fused"),
]


@pytest.mark.parametrize("states,cats,n_slots,ppad,want", SWEEP_ROUTES)
def test_routing_rule_at_the_sweep_shapes(states, cats, n_slots, ppad,
                                          want):
    """``auto`` at the routing sweep's shapes, the slot counts that
    change the resident walk's tile included: resident where its ring
    fits and its grid is one wave or keeps 4 warps an SM, else fused."""
    from types import SimpleNamespace
    part = SimpleNamespace(n_cats=cats, states=states,
                           code_clv=torch.zeros(states + 1, states),
                           dtype=torch.float32, n_patterns_padded=ppad)
    assert engine.fast_eval_schedule(part, n_slots) == want
    assert engine.auto_schedule(part, n_slots) == want


@pytest.mark.parametrize("states", [2, 3, 4])
@pytest.mark.parametrize("cats", [1, 2, 4, 8])
def test_routing_takes_the_thread_kind_as_resident(states, cats):
    """Kernel 1's thread kind (up to 4 states and 8 categories) routes to
    the resident walk at every width from a few patterns to the capacity
    cell's 100,096 (two waves), its tree's slots up to the 12-slot bound
    of 512 taxa."""
    from types import SimpleNamespace
    for ppad in (128, 4480, 16384, 100_096):
        part = SimpleNamespace(n_cats=cats, states=states,
                               code_clv=torch.zeros(states + 1, states),
                               dtype=torch.float32, n_patterns_padded=ppad)
        for n_slots in (1, 7, 12):
            T = _build.resident_tile(cats, states, states + 1, n_slots,
                                     ppad)
            cf = _build.resident_config(cats, states, states + 1, n_slots,
                                        T)
            assert cf["kind"] == "thread"
            assert engine.fast_eval_schedule(part, n_slots) == "resident"


def _tile_kind_route(C, S, n_slots, ppad):
    """The routing rule as it read the tile kind at 17 to 20 states, before
    the split kind: C·T threads a CTA at the same tile and shared memory."""
    T = _build.resident_tile(C, S, S + 1, n_slots, ppad)
    cf = None if T is None else _build.resident_config(C, S, S + 1,
                                                       n_slots, T)
    if cf is None or cf["kind"] == "global":
        return "fused"
    threads = C * T if cf["kind"] == "split" else cf["threads"]
    k = min(32, 2048 // threads,
            _build.SMEM_PER_SM // (cf["smem"] + 1024))
    one_wave = -(-ppad // T) <= _build.SMS * k
    return ("resident" if one_wave or -(-threads // 32) * k >= 4
            else "fused")


@pytest.mark.parametrize("states", [17, 18, 19, 20])
def test_routing_at_the_split_kind_keeps_the_tile_rule(states):
    """At the 20-state step, where the split kind replaces the tile kind,
    ``auto`` routes every shape as the rule routed the tile kind: the
    split kind's producer warp is not counted among the warps that hide
    the row chain's latency."""
    from types import SimpleNamespace
    for cats in (1, 2, 4, 6, 8, 16):
        for n_slots in (1, 3, 5, 9, 12, 19, 30):
            for ppad in (128, 1024, 4096, 16384, 131_072, 413_568):
                part = SimpleNamespace(
                    n_cats=cats, states=states,
                    code_clv=torch.zeros(states + 1, states),
                    dtype=torch.float32, n_patterns_padded=ppad)
                assert engine.fast_eval_schedule(part, n_slots) == \
                    _tile_kind_route(cats, states, n_slots, ppad)


# The benchmark cells' launch decisions (phylobench/configs), recorded from
# the configuration functions as they stood when csrc/configs.h became
# their one home: each launch keeps its kind, tile, threads, shared memory
# and table strides. dna10k.eval: 10,000 taxa, 100,096 padded patterns,
# the five codes of the array loader, the live slots of the cell's own
# tree (7 for seed 1; 8 for some seeds); aa144.eval: 144 taxa, 413,568
# padded patterns, the text loader's 21 codes, 3 to 5 slots; dna246.blo:
# 246 × 4465 through the text loader (16 codes, 4480 padded patterns),
# kernel 2's walk, kernel 8 over all 489 edges and over the edge-colour
# classes of a 246-taxon tree, kernel 10 for one partition.
DNA10K_THREAD = dict(kind="thread", RP=1, SP=4, threads=160, Q=80, ring=424)
AA144_SPLIT = dict(kind="split", RP=2, SP=20, threads=288, Q=1680,
                   ring=3488)
DNA10K_PINS = {7: dict(DNA10K_THREAD, smem=67776),
               8: dict(DNA10K_THREAD, smem=76480)}
AA144_PINS = {3: dict(AA144_SPLIT, smem=120608),
              4: dict(AA144_SPLIT, smem=141344),
              5: dict(AA144_SPLIT, smem=162080)}
DNA246_FUSED = dict(kind="thread", RI=4, RP=2, IG=1, SP=4, NB=3, threads=32,
                    Q=256, smem=6912, depth=2, lookback=2)
DNA246_SUMTABLE = dict(T=128, RI=4, IG=1, SP=4, threads=128, smem=39680)
DNA246_NEWTON = dict(kind="cluster", N=2, smem=172160)


def _eval_cell_pins(states, n_codes, ppad, tile, pins):
    from types import SimpleNamespace
    for n_slots, want in pins.items():
        part = SimpleNamespace(n_cats=4, states=states,
                               code_clv=torch.zeros(n_codes, states),
                               dtype=torch.float32, n_patterns_padded=ppad)
        T = _build.resident_tile(4, states, n_codes, n_slots, ppad)
        assert T == tile
        assert _build.resident_config(4, states, n_codes, n_slots, T) == want
        assert _build.walk_launch_config("pllmod_resident_walk", 4, states,
                                         n_codes, n_slots, ppad) == (T, want)
        assert engine.fast_eval_schedule(part, n_slots) == "resident"
        assert engine.auto_schedule(part, n_slots) == "resident"


@pytest.mark.parametrize("cell", ["dna10k.eval", "aa144.eval",
                                  "dna246.blo"])
def test_launch_decisions_at_the_benchmark_cells(cell):
    """Each benchmark cell's kernels launch in the configurations they had
    when the configurations moved to csrc/configs.h: kernel 1's thread
    kind at T 128 for dna10k.eval, its split kind at T 64 (256 consumers
    and a producer warp) for aa144.eval, and for dna246.blo kernel 2's
    thread walk at T 16, kernel 8's tiled kernel at T 128 and kernel 10's
    two-CTA cluster."""
    from types import SimpleNamespace
    if cell == "dna10k.eval":
        from phylobench.data import seed63
        from phylobench.model import random_binary_tree
        from pllmod_tpu_torch.ops import resident
        n = 10_000
        edges, lengths = random_binary_tree(
            np.random.default_rng(seed63(1)), n, 0.02, 0.4)
        tree = Tree(n, [f"t{i}" for i in range(n)], edges, lengths,
                    n_nodes=2 * n - 2)
        assert resident.compile_resident(
            SimpleNamespace(n_tips=n, device="cpu"), tree)[3] == 7
        _eval_cell_pins(4, 5, 100_096, 128, DNA10K_PINS)
    elif cell == "aa144.eval":
        _eval_cell_pins(20, 21, 413_568, 64, AA144_PINS)
    else:
        assert _build.fused_tile(4, 4, 16, 4480) == 16
        assert _build.walk_launch_config("pllmod_fused_walk", 4, 4, 16, 500,
                                         4480) == (16, DNA246_FUSED)
        for E in (489, 182, 153, 141, 13):
            assert _build.sumtable_config(4, 4, 16, 4480, E) == \
                DNA246_SUMTABLE
        from pllmod_tpu_torch.ops import deriv
        assert deriv.newton_config([16], [4480]) == DNA246_NEWTON
        assert deriv.newton_fits(SimpleNamespace(n_cats=4, states=4,
                                                 n_patterns_padded=4480))


@pytest.mark.parametrize("schedule", ["resident", "fused"])
def test_forced_kernel_on_float64_raises(schedule):
    case = _case(4, 4)
    with pytest.raises(PllModError, match="float32"):
        engine.tree_loglikelihood(to_torch(case.jpart64), case.tree,
                                  schedule=schedule)


def test_compiled_eval_reuses_tables():
    """compile_fast_eval's closure over new branch lengths equals a fresh
    tree_loglikelihood (the timed loop of chip_smoke.py relies on it)."""
    case = _case(4, 4, seed=44)
    ev = engine.compile_fast_eval(case.tpart, case.tree)
    brl = torch.as_tensor(case.tree.lengths * 1.3, dtype=torch.float32)
    assert float(ev(case.tpart, brl)) == float(engine.tree_loglikelihood(
        case.tpart, case.tree, brlens=brl))
    with pytest.raises(ValueError, match="schedule"):
        engine.compile_fast_eval(case.tpart, case.tree, schedule="packed")


@pytest.mark.parametrize("seed,n_taxa", [(1, 12), (2, 40)])
def test_schedulers_match_jax(seed, n_taxa):
    """The copied host schedulers give the JAX package's tables."""
    from pllmod_tpu.ops import clv as jax_clv
    jtree = ref.random_binary_tree(np.random.default_rng(seed), n_taxa)
    ops, (u, v, _) = jtree.traversal_ops()
    js = jax_clv.LevelSchedule(ops, n_taxa)
    ts = clv_mod.LevelSchedule(ops, n_taxa)
    assert (ts.n_slots, ts.offsets, ts.n_levels) == \
        (js.n_slots, js.offsets, js.n_levels)
    np.testing.assert_array_equal(ts.remap, js.remap)
    for a, b in zip(ts.levels, js.levels):
        np.testing.assert_array_equal(a, b)
    assert ts.remap_node(n_taxa + 3) == js.remap_node(n_taxa + 3)
    live = ops[ops[:, 0] >= 0]
    assert clv_mod._su_emission_order(live, n_taxa) == \
        jax_clv._su_emission_order(live, n_taxa)
    got = clv_mod.bounded_slot_ops(ops, n_taxa, root_refs=(u, v))
    want = jax_clv.bounded_slot_ops(ops, n_taxa, root_refs=(u, v))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_serial_engine_buffers_match_jax_f64():
    """update_partials (every CLV and scaler row) and the root/edge logL
    functions against the JAX engine in float64."""
    from pllmod_tpu.ops import clv as jax_clv
    from pllmod_tpu.ops import likelihood as jax_lk
    case = _case(4, 4, pinv=0.2, seed=51, n_taxa=14)
    ops, (u, v, e) = case.jtree.traversal_ops()
    jp = case.jpart64
    jP = jp.prob_matrices(jnp.asarray(case.jtree.lengths))
    jclv, jsc = jax_clv.update_partials(jp, jP, jnp.asarray(ops))
    tp = to_torch(jp)
    tP = tp.prob_matrices(case.tree.lengths)
    tclv, tsc = clv_mod.update_partials(tp, tP, ops)
    n = ops.shape[0]
    np.testing.assert_allclose(tclv.numpy()[:n], np.asarray(jclv)[:n],
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tsc.numpy()[:n], np.asarray(jsc)[:n])
    for node in (u, v):
        want = float(jax_lk.root_loglikelihood(jp, jclv, jsc, node))
        got = lk_mod.root_loglikelihood(tp, tclv, tsc, node)
        assert rel_err(got, want) < F64_RTOL
    want = float(jax_lk.edge_loglikelihood(jp, jclv, jsc, u, v, jP[e]))
    got = lk_mod.edge_loglikelihood(tp, tclv, tsc, u, v, tP[e])
    assert rel_err(got, want) < F64_RTOL
