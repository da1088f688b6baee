"""The CUDA kernels on the card, against their plain versions: the walk,
sumtable, per-level and grouped kernels bit for bit (all round every
product and sum separately, in the same order); the derivative and Newton
kernels, whose
pattern sums run in another order, to 2e-6 relative on logL and 2e-5 on
the derivatives, and 5e-4 on the Newton lengths.

JAX-free, so it runs on a machine that has the card and not the JAX
package's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a card every test here skips (the check runs in a fixture,
never at import)."""

import pytest
import torch

import numpy as np

from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import (_build, charmap, clv, deriv, engine,
                                  fused, grouped, levels, resident)
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.optimize import blo, blo_bounded
from pllmod_tpu_torch.profile import LAUNCHES, RESIDENT_LAUNCHES
from pllmod_tpu_torch.tree.topology import Tree

pytestmark = pytest.mark.cuda

# the registry's keys (profile.LAUNCHES) of kernels 3-5 and 8-10
LEVEL_KERNELS = ("pllmod_child_pass", "pllmod_child2_pass",
                 "pllmod_level_combined")
DERIV_KERNELS = ("pllmod_edge_sumtables", "pllmod_edge_derivs",
                 "pllmod_newton_edges", "pllmod_newton_edges_multi")

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


# kernel 1's split kind (the 20-state step): id -> (states, cats, taxa,
# tree: the example's own, a caterpillar or a balanced tree; live slots
# reserved; patterns kept, for a ragged last tile; tiles forced beside the
# rule's, each of the split kind)
SPLIT_CASES = {
    "split-slots3": (20, 4, 16, "caterpillar", 3, None, (64, 32)),
    "split-slots4": (20, 4, 16, "caterpillar", 4, None, (64, 32)),
    "split-slots5": (20, 4, 16, "caterpillar", 5, None, (64, 32)),
    "split-ragged": (20, 4, 16, "balanced", None, (100, 101), (64, 16)),
    "split-all-tips": (20, 4, 4, "balanced", None, None, (64,)),
    "split-S18": (18, 4, 24, "own", None, None, (64, 32)),
    "split-C1": (20, 1, 24, "own", None, None, (64,)),
    "split-C8": (20, 8, 24, "own", None, None, (32, 8)),
    "split-144": (20, 4, 144, "own", None, (1000,), (64,)),
}


def _split_matches_plain(cuda, states, cats, n_taxa, shape, n_slots, ppads,
                         tiles):
    """Kernel 1 bit for bit against the plain walk at the rule's tile, and
    of the split kind at each of ``tiles``."""
    part, tree = _example(states, cats, cuda, n_taxa=n_taxa,
                          n_sites=max(ppads or (512,)))
    if shape != "own":
        tree = (_caterpillar if shape == "caterpillar" else _balanced)(
            n_taxa)
        tree.lengths[:] = np.linspace(0.02, 0.4, len(tree.lengths))
    idx8, e1, e2, ns = resident.compile_resident(part, tree,
                                                 n_slots_min=n_slots)
    assert n_slots is None or ns == n_slots
    rows = idx8.cpu().numpy()
    if shape == "balanced":
        assert ((rows[:, 2] != 0) & (rows[:, 3] != 0)).any()
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    tab = fused.code_table(part)
    for Ppad in ppads or (part.n_patterns_padded,):
        tc = part.tip_states[:, :Ppad].contiguous()
        _resident_equal(idx8, P5, tc, tab, ns)
        for T in tiles:
            assert _resident_equal(idx8, P5, tc, tab, ns, tile=T) == "split"


@pytest.mark.parametrize("states,cats,split", [
    pytest.param(s, c, None, id=f"{s}-{c}") for s, c in SHAPES] + [
    pytest.param(*case[:2], case, id=name)
    for name, case in SPLIT_CASES.items()])
def test_resident_kernel_matches_plain(cuda, states, cats, split):
    if split is not None:
        _split_matches_plain(cuda, *split)
        return
    part, tree = _example(states, cats, cuda)
    idx8, e1, e2, ns = resident.compile_resident(part, tree)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, fused.code_table(part), ns)
    before = LAUNCHES["pllmod_resident_walk"]
    prod_k, sc_k = resident.resident_walk(*args)
    assert LAUNCHES["pllmod_resident_walk"] == before + 1
    prod_p, sc_p = resident.resident_walk_plain(*args)
    assert torch.equal(prod_k, prod_p)
    assert torch.equal(sc_k, sc_p)


@pytest.mark.parametrize("states,cats", SHAPES)
def test_fused_kernel_matches_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    idx8, e1, e2, _, ns = fused.compile_fused(part, tree, fuse_root=True)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, fused.code_table(part), ns)
    before = LAUNCHES["pllmod_fused_walk"]
    clv_k, sc_k = fused.fused_walk(*args)
    assert LAUNCHES["pllmod_fused_walk"] == before + 1
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
    before = (LAUNCHES["pllmod_resident_walk"]
              + LAUNCHES["pllmod_fused_walk"])
    got = float(engine.tree_loglikelihood(part, tree))
    assert (LAUNCHES["pllmod_resident_walk"]
            + LAUNCHES["pllmod_fused_walk"]) == before + 1
    assert abs(got - want) / abs(want) < 1e-6


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
    before = {k: LAUNCHES[k] for k in DERIV_KERNELS}
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
    assert {k: LAUNCHES[k] - before[k] for k in before} == \
        {"pllmod_edge_sumtables": 1, "pllmod_edge_derivs": 1,
         "pllmod_newton_edges": 1, "pllmod_newton_edges_multi": 0}


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (5, 4)])
def test_blo_on_card_matches_float64(cuda, states, cats):
    """The BLO's float32 kernel pipeline on the card: its logL is the
    float64 serial engine's at the returned lengths, and every kernel of
    the path launched."""
    part, tree = _example(states, cats, cuda)
    start = float(engine.tree_loglikelihood(part, tree))
    before = ({k: LAUNCHES[k] for k in DERIV_KERNELS},
              LAUNCHES["pllmod_fused_walk"])
    _, lnl = blo.optimize_branch_lengths(part, tree)
    assert lnl >= start
    want = float(engine.tree_loglikelihood(part.to(dtype=torch.float64),
                                           tree, schedule="scan"))
    assert abs(lnl - want) / abs(want) < 1e-6
    # kernels 8, 9 and 10 (one partition: its K = 1 form)
    assert all(LAUNCHES[k] > before[0][k] for k in
               ("pllmod_edge_sumtables", "pllmod_edge_derivs",
                "pllmod_newton_edges"))
    assert LAUNCHES["pllmod_fused_walk"] > before[1]


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


# ---------------------------------------------------------------------------
# the per-level kernels (3, 4, 5) and the grouped kernel (7)
# ---------------------------------------------------------------------------
# every register tile (S ≤ 4, 8, 16, 20, 32, 64) at C = 1 and 4
LEVEL_SHAPES = [(s, c) for s in (4, 8, 16, 20, 32, 64) for c in (1, 4)]


def _caterpillar(n):
    """The maximally unbalanced tree: every level of its schedule has one
    row."""
    return Tree.from_newick("(t0:0.1," + "".join(
        f"(t{i}:0.1," for i in range(1, n - 1)) + f"t{n - 1}:0.1"
        + ")" * (n - 2) + ");")


def _tip_edge(tree):
    return next(e for e, (u, v) in enumerate(tree.edge_nodes)
                if int(u) >= 0 and (tree.is_tip(int(u))
                                    or tree.is_tip(int(v))))


def _level_walk_plain(idx, P1, P2, tc, tab, lvls, offsets, n_slots, C, S):
    """Kernels 3 then 4 on every level, their plain versions."""
    Ppad = tc.shape[1]
    clvs = torch.zeros((n_slots, C * S, Ppad), device=tc.device)
    sc = torch.zeros((n_slots, 1, Ppad), dtype=torch.int32, device=tc.device)
    for lv, off in zip(lvls, offsets):
        s = slice(off, off + len(lv))
        left, s1 = levels.child_pass_plain(idx[s], 0, clvs, sc, tc, tab, P1[s])
        levels.child2_pass_plain(idx[s], clvs, sc, tc, tab, P2[s], left, s1,
                                 off)
    return clvs, sc


def _check_level_kernels(part, tree, root_edge=None):
    """Kernels 3, 4 and 5 against their plain versions on every level, and
    the three drivers of update_partials_pallas against the plain walk."""
    lvls, offsets, _, ns = engine.compile_schedule(part, tree, root_edge)
    idx, e1, e2 = levels.level_tables(part, lvls)
    P = part.prob_matrices(_brl(tree, part))
    P1, P2 = P[e1], P[e2]
    tc, tab = part.tip_states, fused.code_table(part)
    C, S = part.n_cats, part.states
    want = _level_walk_plain(idx, P1, P2, tc, tab, lvls, offsets, ns, C, S)
    before = {k: LAUNCHES[k] for k in LEVEL_KERNELS}
    for step in ("child2", "combined"):
        got = levels.update_partials_pallas(part, P, lvls, offsets, ns, step)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for lv, off in zip(lvls, offsets):
        s = slice(off, off + len(lv))
        for side, Pm in ((0, P1[s]), (1, P2[s])):
            got = levels.child_pass(idx[s], side, *want, tc, tab, Pm)
            ref = levels.child_pass_plain(idx[s], side, *want, tc, tab, Pm)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        k5 = [t.clone() for t in want]
        levels.level_update_combined(*k5, idx[s], tc, tab, P1[s], P2[s], off)
        p5 = [t.clone() for t in want]
        levels.level_combined_plain(idx[s], *p5, tc, tab, P1[s], P2[s], off)
        assert torch.equal(k5[0], p5[0]) and torch.equal(k5[1], p5[1])
    n = len(lvls)
    assert {k: LAUNCHES[k] - before[k] for k in before} == \
        {"pllmod_child_pass": 3 * n, "pllmod_child2_pass": n,
         "pllmod_level_combined": 2 * n}


def _check_grouped_kernel(part, tree, root_edge=None, group=0, **walk):
    """Kernel 7 against its plain version on every position a member
    writes (the tip positions of the buffers hold nothing); ``walk``:
    the wrapper's tile= and lanes=."""
    sched = grouped.GroupedSchedule(part, tree, root_edge, group)
    PQ = grouped.grouped_pmats(part, _brl(tree, part), sched.e_sides)
    args = (sched.side_meta, sched.dst_meta, PQ, part.tip_states,
            fused.code_table(part))
    before = LAUNCHES["pllmod_grouped_walk"]
    bufs, sbufs = grouped.grouped_walk(*args, sched.order, sched.windows,
                                       **walk)
    assert LAUNCHES["pllmod_grouped_walk"] == before + 1
    want_b, want_s = grouped.grouped_walk_plain(*args)
    dg, dq = sched.dst_meta[..., 0].long(), sched.dst_meta[..., 1].long()
    assert torch.equal(bufs[dg, dq], want_b[dg, dq])
    assert torch.equal(sbufs[dg, dq], want_s[dg, dq])
    return sched


@pytest.mark.parametrize("states,cats", LEVEL_SHAPES)
def test_level_kernels_match_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    _check_level_kernels(part, tree)


@pytest.mark.parametrize("states,cats", LEVEL_SHAPES)
def test_grouped_kernel_matches_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    _check_grouped_kernel(part, tree)


@pytest.mark.parametrize("case", ["caterpillar", "tip_root", "g16"])
def test_level_and_grouped_kernels_edge_cases(cuda, case):
    """A caterpillar tree (one row a level, one member a group), a root on
    a tip edge (one landing position is a tip) and G = 16 (C·S = 4)."""
    if case == "g16":
        part, tree = _example(4, 1, cuda, n_taxa=40)
        assert _check_grouped_kernel(part, tree).G == 16
        _check_level_kernels(part, tree)
        return
    part, tree = _example(4, 4, cuda, n_taxa=14)
    root_edge = None
    if case == "caterpillar":
        tree = _caterpillar(14)
        tree.lengths[:] = np.linspace(0.02, 0.3, len(tree.lengths))
    else:
        root_edge = _tip_edge(tree)
    _check_level_kernels(part, tree, root_edge)
    _check_grouped_kernel(part, tree, root_edge)


def _level_tiles(mode, C, S, n_codes):
    """Every tile of kernel 4 or 5 where a configuration fits: each one
    the rule can pick."""
    return [T for T in _build.LEVEL_TILES
            if _build.level_config(mode, C, S, n_codes, T)]


def _check_level_tiles(part, tree, root_edge=None, Ppads=(None,)):
    """Kernels 4 and 5 against their plain versions on every level, at
    the rule's tile and every tile that fits, at each pattern count of
    ``Ppads`` (None: the partition's; a count that is no multiple of the
    tile leaves a ragged last tile): the level's slots are poisoned
    before each launch and the whole buffers compared bit for bit."""
    lvls, offsets, _, ns = engine.compile_schedule(part, tree, root_edge)
    idx, e1, e2 = levels.level_tables(part, lvls)
    P = part.prob_matrices(_brl(tree, part))
    P1, P2 = P[e1], P[e2]
    tab = fused.code_table(part)
    C, S, n_codes = part.n_cats, part.states, tab.shape[0]
    want = _level_walk_plain(idx, P1, P2, part.tip_states, tab, lvls,
                             offsets, ns, C, S)
    tiles = {m: [None] + _level_tiles(m, C, S, n_codes)
             for m in _build.LEVEL_MODES}
    for Ppad in Ppads:
        Ppad = Ppad or part.n_patterns_padded
        tc = part.tip_states[:, :Ppad].contiguous()
        bufs = [w[..., :Ppad].contiguous() for w in want]
        for lv, off in zip(lvls, offsets):
            s = slice(off, off + len(lv))

            def fresh():
                out = [b.clone() for b in bufs]
                out[0][s] = float("nan")
                out[1][s] = -999
                return out
            left, s1 = levels.child_pass_plain(idx[s], 0, *bufs, tc, tab,
                                               P1[s])
            ref4 = levels.child2_pass_plain(idx[s], *fresh(), tc, tab, P2[s],
                                            left, s1, off)
            ref5 = levels.level_combined_plain(idx[s], *fresh(), tc, tab,
                                               P1[s], P2[s], off)
            for T in tiles["child2"]:
                got = levels.child2_pass(idx[s], *fresh(), tc, tab, P2[s],
                                         left, s1, off, tile=T)
                assert all(torch.equal(g, r) for g, r in zip(got, ref4)), \
                    ("child2", T, Ppad, off)
            for T in tiles["combined"]:
                got = levels.level_update_combined(*fresh(), idx[s], tc, tab,
                                                   P1[s], P2[s], off, tile=T)
                assert all(torch.equal(g, r) for g, r in zip(got, ref5)), \
                    ("combined", T, Ppad, off)


@pytest.mark.parametrize("states,cats", LEVEL_SHAPES)
def test_level_kernels_every_tile_and_ragged(cuda, states, cats):
    """Kernels 4 and 5 along the state ladder at every tile that fits
    (tiled and simple kernels), at the partition's patterns and at 100
    and 101 (ragged last tiles, the second without 16-byte vectors)."""
    part, tree = _example(states, cats, cuda, n_taxa=14, n_sites=256)
    _check_level_tiles(part, tree, Ppads=(None, 100, 101))


@pytest.mark.parametrize("case", ["caterpillar", "tip_root", "g16"])
def test_level_kernels_every_tile_edge_cases(cuda, case):
    """Kernels 4 and 5 at every tile on a caterpillar (every level one
    row), with the root on a tip edge, and at C·S = 4, with a ragged last
    tile."""
    if case == "g16":
        part, tree = _example(4, 1, cuda, n_taxa=40)
        _check_level_tiles(part, tree, Ppads=(None, 101))
        return
    part, tree = _example(4, 4, cuda, n_taxa=14)
    root_edge = None
    if case == "caterpillar":
        tree = _caterpillar(14)
        tree.lengths[:] = np.linspace(0.02, 0.3, len(tree.lengths))
    else:
        root_edge = _tip_edge(tree)
    _check_level_tiles(part, tree, root_edge, Ppads=(None, 101))


@pytest.mark.parametrize("states,cats,tile", [
    (20, 4, None), (20, 4, 64), (20, 4, 4), (4, 4, None), (4, 4, 256),
    (64, 4, None)])
def test_level_kernels_repeated_launches(cuda, states, cats, tile):
    """Kernels 4 and 5 through their drivers on a 256-taxon tree, 20 times
    each at the rule's tiles or one forced tile, each launch started
    while its pre-pass runs (a programmatic dependent) into one scratch
    shared by every level, as ``update_partials_pallas`` shares it: every
    launch bit for bit with the plain walk, and each counted once a
    level."""
    part, tree = _example(states, cats, cuda, n_taxa=256, n_sites=2048)
    lvls, offsets, _, ns = engine.compile_schedule(part, tree)
    tables = levels.level_tables(part, lvls)
    idx, e1, e2 = tables
    P = part.prob_matrices(_brl(tree, part))
    P1, P2 = P[e1], P[e2]
    tc, tab = part.tip_states, fused.code_table(part)
    want = _level_walk_plain(idx, P1, P2, tc, tab, lvls, offsets, ns, cats,
                             states)
    sl = [slice(o, o + len(lv)) for lv, o in zip(lvls, offsets)]
    scratch = torch.empty(max(
        levels.level_scratch_floats(m, cats, states, tab.shape[0],
                                    part.n_patterns_padded, len(lv), tile)
        for m in _build.LEVEL_MODES for lv in lvls), device=cuda)
    before = {k: LAUNCHES[k] for k in LEVEL_KERNELS}
    for _ in range(20):
        for kernel in ("child2", "combined"):
            clvs = torch.full_like(want[0], float("nan"))
            sc = torch.full_like(want[1], -999)
            for s, off in zip(sl, offsets):
                if kernel == "child2":
                    left, s1 = levels.child_pass(idx[s], 0, clvs, sc, tc,
                                                 tab, P1[s])
                    levels.child2_pass(idx[s], clvs, sc, tc, tab, P2[s],
                                       left, s1, off, tile=tile,
                                       scratch=scratch)
                else:
                    levels.level_update_combined(clvs, sc, idx[s], tc, tab,
                                                 P1[s], P2[s], off, tile=tile,
                                                 scratch=scratch)
            assert torch.equal(clvs, want[0]) and torch.equal(sc, want[1])
    n = 20 * len(sl)
    assert LAUNCHES["pllmod_child2_pass"] - before["pllmod_child2_pass"] == n
    assert (LAUNCHES["pllmod_level_combined"]
            - before["pllmod_level_combined"]) == n


def test_level_scratch_is_checked(cuda):
    """A scratch too small, of another type or on the CPU is refused, not
    written past; one of the right size is taken."""
    part, tree = _example(20, 4, cuda)
    lvls, offsets, _, ns = engine.compile_schedule(part, tree)
    idx, e1, e2 = levels.level_tables(part, lvls)
    P = part.prob_matrices(_brl(tree, part))
    tc, tab = part.tip_states, fused.code_table(part)
    s = slice(offsets[0], offsets[0] + len(lvls[0]))
    bufs = _level_walk_plain(idx, P[e1], P[e2], tc, tab, lvls, offsets, ns,
                             4, 20)
    n = levels.level_scratch_floats("combined", 4, 20, tab.shape[0],
                                    part.n_patterns_padded, len(lvls[0]))
    assert n > 0
    for bad in (torch.empty(n - 1, device=cuda),
                torch.empty(n, dtype=torch.float64, device=cuda),
                torch.empty(n)):
        with pytest.raises(ValueError, match="scratch"):
            levels.level_update_combined(*bufs, idx[s], tc, tab, P[e1][s],
                                         P[e2][s], s.start, scratch=bad)
    want = [b.clone() for b in bufs]
    levels.level_update_combined(*bufs, idx[s], tc, tab, P[e1][s], P[e2][s],
                                 s.start, scratch=torch.empty(n, device=cuda))
    assert all(torch.equal(b, w) for b, w in zip(bufs, want))


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (5, 4)])
def test_level_schedules_on_card_match_float64(cuda, states, cats):
    """The per-level drivers and the grouped walk on the card agree with
    the float64 serial engine, each launching its kernels."""
    part, tree = _example(states, cats, cuda)
    want = float(engine.tree_loglikelihood(part.to(dtype=torch.float64),
                                           tree, schedule="scan"))
    lvls, offsets, ri, ns = engine.compile_schedule(part, tree)
    before = ({k: LAUNCHES[k] for k in LEVEL_KERNELS},
              LAUNCHES["pllmod_grouped_walk"])
    got = [float(engine.tree_loglikelihood(part, tree, schedule="pallas")),
           float(engine.tree_loglikelihood(part, tree, schedule="levels"))]
    for step in ("split", "combined"):
        got.append(float(levels.loglikelihood_pallas(
            part, lvls, _brl(tree, part), offsets, ri, ns, step=step)))
    got.append(float(grouped.loglikelihood_grouped(
        part, _brl(tree, part), grouped.GroupedSchedule(part, tree))))
    for g in got:
        assert abs(g - want) / abs(want) < 1e-6
    assert all(LAUNCHES[k] > before[0][k] for k in before[0])
    assert LAUNCHES["pllmod_grouped_walk"] == before[1] + 1


def test_level_and_grouped_wrappers_raise(cuda):
    """Each wrapper raises on tensors on two devices and beyond 64
    states; none falls back to its plain version."""
    part, tree = _example(4, 4, cuda)
    lvls, offsets, _, ns = engine.compile_schedule(part, tree)
    idx, e1, e2 = levels.level_tables(part, lvls)
    P = part.prob_matrices(_brl(tree, part))
    W = len(lvls[0])
    rows, P1, P2 = idx[:W], P[e1][:W], P[e2][:W]
    Ppad = part.n_patterns_padded
    clvs = torch.zeros((ns, 16, Ppad), device=cuda)
    sc = torch.zeros((ns, 1, Ppad), dtype=torch.int32, device=cuda)
    tab, tc = fused.code_table(part), part.tip_states
    left, s1 = levels.child_pass(rows, 0, clvs, sc, tc, tab, P1)
    calls = [
        lambda tc, P1, P2, tab: levels.child_pass(rows, 0, clvs, sc, tc, tab,
                                                  P1),
        lambda tc, P1, P2, tab: levels.child2_pass(rows, clvs, sc, tc, tab,
                                                   P2, left, s1, 0),
        lambda tc, P1, P2, tab: levels.level_update_combined(
            clvs, sc, rows, tc, tab, P1, P2, 0)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call(tc.cpu(), P1, P2, tab)
    sched = grouped.GroupedSchedule(part, tree)
    PQ = grouped.grouped_pmats(part, _brl(tree, part), sched.e_sides)
    with pytest.raises(ValueError, match="CUDA device"):
        grouped.grouped_walk(sched.side_meta, sched.dst_meta, PQ, tc.cpu(),
                             tab)
    # 65 states: every tensor of the right shape on the card
    S = 65
    P65 = torch.rand((W, 4, S, S), device=cuda)
    tab65 = torch.rand((3, S), device=cuda)
    clv65 = torch.zeros((ns, 4 * S, Ppad), device=cuda)
    left65 = torch.zeros((W, 4 * S, Ppad), device=cuda)
    wide = [lambda: levels.child_pass(rows, 0, clv65, sc, tc, tab65, P65),
            lambda: levels.child2_pass(rows, clv65, sc, tc, tab65, P65,
                                       left65, s1, 0),
            lambda: levels.level_update_combined(clv65, sc, rows, tc, tab65,
                                                 P65, P65, 0),
            lambda: grouped.grouped_walk(
                sched.side_meta, sched.dst_meta,
                torch.rand((sched.nG, sched.Q, 4, S, S), device=cuda), tc,
                tab65)]
    for call in wide:
        with pytest.raises(ValueError, match="64 states"):
            call()


# ---------------------------------------------------------------------------
# the packed walk (kernel 6) and kernel 10 over K partitions
# ---------------------------------------------------------------------------
def _check_packed_kernel(part, tree, root_edge=None, group=0, **walk):
    """Kernel 6 against its plain version on every slot, the dummy rows'
    included, and the packed logL against the float64 serial engine;
    ``walk``: the wrapper's tile= and lanes=."""
    from pllmod_tpu_torch.ops import packed
    sched = packed.PackedSchedule(part, tree, root_edge, group)
    P = part.prob_matrices(_brl(tree, part)).contiguous()
    args = (sched.idxm, sched.e1, sched.e2, P, part.tip_states,
            fused.code_table(part), sched.G)
    before = LAUNCHES["pllmod_packed_walk"]
    clvs, sc = packed.packed_walk(*args, sched.windows, **walk)
    assert LAUNCHES["pllmod_packed_walk"] == before + 1
    want = packed.packed_walk_plain(*args)
    assert torch.equal(clvs, want[0]) and torch.equal(sc, want[1])
    got = float(packed.loglikelihood_packed(part, _brl(tree, part), sched))
    l64 = float(engine.tree_loglikelihood(part.to(dtype=torch.float64), tree,
                                          root_edge=root_edge,
                                          schedule="scan"))
    assert abs(got - l64) / abs(l64) < 1e-6
    return sched


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (64, 4), (4, 1)])
def test_packed_kernel_matches_plain(cuda, states, cats):
    part, tree = _example(states, cats, cuda)
    sched = _check_packed_kernel(part, tree)
    assert sched.G == max(1, 128 // (states * cats))


@pytest.mark.parametrize("case", ["caterpillar", "tip_root", "group"])
def test_packed_kernel_edge_cases(cuda, case):
    """A caterpillar tree (one row a level, so most rows are dummies), a
    root on a tip edge and G = 3 given."""
    part, tree = _example(4, 4, cuda, n_taxa=14)
    if case == "caterpillar":
        tree = _caterpillar(14)
        tree.lengths[:] = np.linspace(0.02, 0.3, len(tree.lengths))
        sched = _check_packed_kernel(part, tree)
        assert sched.n_slots_pad == 8 * sched.n_slots
    elif case == "tip_root":
        _check_packed_kernel(part, tree, root_edge=_tip_edge(tree))
    else:
        assert _check_packed_kernel(part, tree, group=3).G == 3


def test_packed_wrapper_raises(cuda):
    """Kernel 6's wrapper refuses what the kernel does not take; it never
    falls back to the plain version."""
    from pllmod_tpu_torch.ops import packed
    part, tree = _example(4, 4, cuda)
    sched = packed.PackedSchedule(part, tree)
    P = part.prob_matrices(_brl(tree, part)).contiguous()
    tab, tc = fused.code_table(part), part.tip_states
    with pytest.raises(ValueError, match="CUDA device"):
        packed.packed_walk(sched.idxm, sched.e1, sched.e2, P, tc.cpu(), tab,
                           sched.G)
    with pytest.raises(ValueError, match="float32"):
        packed.packed_walk(sched.idxm, sched.e1, sched.e2, P.double(), tc,
                           tab, sched.G)
    with pytest.raises(ValueError, match="multiple of G"):
        packed.packed_walk(sched.idxm[:-1], sched.e1[:-1], sched.e2[:-1], P,
                           tc, tab, sched.G)
    S = 65
    with pytest.raises(ValueError, match="64 states"):
        packed.packed_walk(sched.idxm, sched.e1, sched.e2,
                           torch.rand((P.shape[0], 4, S, S), device=cuda), tc,
                           torch.rand((3, S), device=cuda), sched.G)
    with pytest.raises(PllModError, match="float32"):
        packed.loglikelihood_packed(part.to(dtype=torch.float64),
                                    _brl(tree, part).double(), sched)


@pytest.mark.parametrize("shapes", [((4, 4),), ((4, 4), (20, 4)),
                                    ((4, 1), (20, 4), (5, 4))],
                         ids=["K1", "K2", "K3"])
def test_newton_kernel_over_partitions(cuda, shapes):
    """Kernel 10 over K partitions of mixed C·S on one tree, with
    branch-length scalers, against its plain version. The K = 1
    partition given twice lands on the same lengths in as many
    iterations with twice the logL, bit for bit (every sum doubles
    exactly)."""
    tree = None
    parts, sts, scs = [], [], []
    scalers = (1.0, 0.5, 1.7)[:len(shapes)]
    for k, (states, cats) in enumerate(shapes):
        part, t = _example(states, cats, cuda)
        tree = tree or t
        tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
        clvs, scalers_k = blo._directed_clvs(part, tabs,
                                             _brl(tree, part) * scalers[k])
        st, sc = deriv.edge_sumtables(part, clvs, scalers_k, tabs.eref6,
                                      tabs.basis)
        parts.append(part)
        sts.append(st)
        scs.append(sc)
    live = torch.as_tensor(blo.DirectedTraversal(tree).edge_mask,
                           device=cuda)
    t0 = _brl(tree, parts[0])
    args = (parts, sts, scs, t0, scalers, 1e-4, 100.0, 1e-4, 10)
    key = ("pllmod_newton_edges" if len(parts) == 1
           else "pllmod_newton_edges_multi")
    before = LAUNCHES[key]
    got = deriv.newton_edges_multi(*args)
    assert LAUNCHES[key] == before + 1
    want = deriv.newton_edges_multi_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got[0][live], want[0][live], 1e-4) < 5e-4
    assert _rel(got[1][live], want[1][live], 1e-2) < 2e-6
    if len(parts) == 1:
        twice = deriv.newton_edges_multi(parts * 2, sts * 2, scs * 2, t0,
                                         scalers * 2, 1e-4, 100.0, 1e-4, 10)
        assert torch.equal(twice[0], got[0])
        assert torch.equal(twice[2], got[2])
        assert torch.equal(twice[1], 2 * got[1])
    with pytest.raises(ValueError, match="shared memory"):
        deriv.newton_edges_multi([parts[0]] * 5000, [sts[0]] * 5000,
                                 [scs[0]] * 5000, t0, [1.0] * 5000, 1e-4,
                                 100.0, 1e-4, 10)


@pytest.mark.parametrize("linkage", ["linked", "scaled", "unlinked"])
def test_treeinfo_on_card(cuda, linkage):
    """A two-partition TreeInfo (DNA + protein) on the card: compute_loglh
    through multi_eval, the incremental path after one changed length,
    and the multi-partition BLO, each against the float64 engine."""
    from pllmod_tpu_torch.common import (BRLEN_LINKED, BRLEN_SCALED,
                                         BRLEN_UNLINKED)
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    mode = {"linked": BRLEN_LINKED, "scaled": BRLEN_SCALED,
            "unlinked": BRLEN_UNLINKED}[linkage]
    dna, tree = _example(4, 4, cuda)
    prot = flagship.partition_on_tree(tree, 256, seed=9, states=20,
                                      device=cuda).cache_eigen()
    ti = TreeInfo(tree.copy(), [dna, prot], brlen_linkage=mode)
    if mode == BRLEN_SCALED:
        ti.brlen_scalers[:] = [1.0, 0.5]

    def f64_total():
        return sum(float(engine.tree_loglikelihood(
            p.to(dtype=torch.float64), ti.tree,
            brlens=torch.as_tensor(ti.partition_brlens(i)),
            schedule="scan")) for i, p in enumerate((dna, prot)))

    before = (LAUNCHES["pllmod_resident_walk"]
              + LAUNCHES["pllmod_fused_walk"])
    lnl = ti.compute_loglh()
    assert (LAUNCHES["pllmod_resident_walk"]
            + LAUNCHES["pllmod_fused_walk"]) == before + 2
    assert abs(lnl - f64_total()) / abs(lnl) < 1e-6
    ti.compute_loglh(incremental=True)
    ti.set_branch_length(3, 0.123)
    rows = ti.counters.clv_updates
    inc = ti.compute_loglh(incremental=True)
    assert ti.counters.clv_updates - rows < \
        (tree.n_tips - 2) * (dna.n_patterns + prot.n_patterns)
    assert abs(inc - ti.compute_loglh()) / abs(inc) < 1e-6
    start = ti.compute_loglh()
    before = LAUNCHES["pllmod_newton_edges_multi"]
    lnl = blo.optimize_branch_lengths_treeinfo(ti)
    assert lnl >= start
    assert abs(lnl - f64_total()) / abs(lnl) < 1e-6
    if mode != BRLEN_UNLINKED:
        assert LAUNCHES["pllmod_newton_edges_multi"] > before


# ---------------------------------------------------------------------------
# the redesigned fused walk (kernel 2, csrc/fused.cu) and child pass
# (kernel 3): every table kind, the forwarding hazard, all-tip rows,
# ragged and unaligned pattern counts, and the launch configurations
# ---------------------------------------------------------------------------
FUSED_STATES = (4, 20, 32, 64)
FUSED_CATS = (1, 4, 8)
TABLES = ("dense", "fuse_root", "directed", "incremental")


def _walk_equal(idx8, P5, tc, tab, ns, out=None, tile=None):
    """The fused walk against its plain version, CLVs and scalers bit for
    bit (``out``: prior buffers, written in place by both)."""
    got_out = None if out is None else [t.clone() for t in out]
    want_out = None if out is None else [t.clone() for t in out]
    before = LAUNCHES["pllmod_fused_walk"]
    clv_k, sc_k = fused.fused_walk(idx8, P5, tc, tab, ns, out=got_out,
                                   tile=tile)
    assert LAUNCHES["pllmod_fused_walk"] == before + 1
    clv_p, sc_p = fused.fused_walk_plain(idx8, P5, tc, tab, ns, out=want_out)
    written = torch.unique(idx8[:, 6].long())
    if out is None:     # slots no row writes are unset in the kernel's
        clv_k, clv_p = clv_k[written], clv_p[written]
        sc_k, sc_p = sc_k[written], sc_p[written]
    assert torch.equal(clv_k, clv_p)
    assert torch.equal(sc_k, sc_p)


def _fused_table(part, tree, kind):
    """(idx8, P5, n_slots, prior buffers or None) of a table kind: the
    dense level-ordered table, with the root pseudo-node row, the
    directed (BLO) table written into prior buffers, or three dirty rows
    on a leaf-to-root path written into a full walk's buffers."""
    brl = _brl(tree, part)
    if kind in ("dense", "fuse_root"):
        idx8, e1, e2, _, ns = fused.compile_fused(
            part, tree, fuse_root=kind == "fuse_root")
        P5 = fused.pair_pmats(part, brl, e1, e2,
                              root_row=kind == "fuse_root")
        return idx8, P5, ns, None
    tab = fused.code_table(part)
    if kind == "directed":
        tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
        P5 = fused.pair_pmats(part, brl, tabs.e1, tabs.e2, root_row=False)
        prior = fused.fused_walk_plain(tabs.idx8, P5, part.tip_states, tab,
                                       tabs.n_slots)
        return tabs.idx8, P5, tabs.n_slots, prior
    ops, _ = tree.traversal_ops(None)
    ops = np.asarray(ops)
    full, e1, e2, ns = fused.compile_fused_ops(part, ops)
    prior = fused.fused_walk_plain(
        torch.as_tensor(full, device=part.device),
        _pmats(part, brl, e1, e2), part.tip_states, tab, ns)
    # a row and its next two ancestors (each reads the last): the rows a
    # changed length below them dirties
    parent = {int(c): k for k, r in enumerate(ops) if r[0] >= 0
              for c in (r[1], r[3])}
    chain = next(
        [k, parent[ref], parent[int(ops[parent[ref], 0]) + part.n_tips]]
        for k, r in enumerate(ops)
        if r[0] >= 0 and (ref := int(r[0]) + part.n_tips) in parent
        and int(ops[parent[ref], 0]) + part.n_tips in parent)
    idx8, e1, e2, _ = fused.compile_fused_ops(part, ops[chain],
                                              n_slots_min=ns)
    return (torch.as_tensor(idx8, device=part.device),
            _pmats(part, brl, e1, e2), ns, prior)


def _pmats(part, brl, e1, e2):
    """pair_pmats of a numpy table's edge columns (no root row)."""
    return fused.pair_pmats(part, brl, torch.as_tensor(e1).to(part.device),
                            torch.as_tensor(e2).to(part.device),
                            root_row=False)


def _swapped(idx8, P5):
    """The same table with each row's two children swapped (a row's
    product commutes, so the plain walk gives the same CLVs)."""
    return (idx8[:, [1, 0, 3, 2, 5, 4, 6, 7]].contiguous(),
            P5[:, [1, 0]].contiguous())


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("cats", FUSED_CATS)
@pytest.mark.parametrize("states", FUSED_STATES)
def test_fused_walk_tables_match_plain(cuda, states, cats, kind):
    """Kernel 2 bit for bit on every table kind at S in {4, 20, 32, 64}
    and C in {1, 4, 8}; the pre-pass bit for bit with its plain form."""
    part, tree = _example(states, cats, cuda, n_taxa=16, n_sites=256)
    idx8, P5, ns, prior = _fused_table(part, tree, kind)
    tab = fused.code_table(part)
    _walk_equal(idx8, P5, part.tip_states, tab, ns, out=prior)
    T = _build.fused_tile(cats, states, tab.shape[0],
                          part.n_patterns_padded)
    assert torch.equal(fused.walk_tables(idx8, P5, tab, T),
                       fused.walk_tables_plain(idx8, P5, tab, T))


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (64, 4), (4, 1)])
@pytest.mark.parametrize("case", ["serial", "caterpillar", "incremental"])
def test_fused_walk_forwards_the_previous_rows_child(cuda, states, cats,
                                                     case):
    """Tables where a row's child is the row before's output (the
    prefetch hazard): the slot-recycled serial table of the bounded
    evaluation, a caterpillar tree's dense table, three dirty rows; each
    has such children at the kernel's pipeline depth."""
    part, tree = _example(states, cats, cuda, n_taxa=14, n_sites=256)
    tab = fused.code_table(part)
    prior = None
    if case == "serial":
        ops, root_info = tree.traversal_ops(None)
        u, v, _ = (int(x) for x in root_info)
        ops_b, _, _ = clv.bounded_slot_ops(ops, part.n_tips,
                                           root_refs=(u, v))
        idx8, e1, e2, ns = fused.compile_fused_ops(part, ops_b, serial=True)
        idx8 = torch.as_tensor(idx8, device=cuda)
        P5 = _pmats(part, _brl(tree, part), e1, e2)
    elif case == "caterpillar":
        tree = _caterpillar(14)
        tree.lengths[:] = np.linspace(0.02, 0.3, len(tree.lengths))
        idx8, P5, ns, prior = _fused_table(part, tree, "fuse_root")
    else:
        idx8, P5, ns, prior = _fused_table(part, tree, "incremental")
    cf = _build.fused_config(cats, states, tab.shape[0], _build.fused_tile(
        cats, states, tab.shape[0], part.n_patterns_padded))
    assert cf["depth"] >= 1
    flagged = 0
    for i8, p5 in ((idx8, P5), _swapped(idx8, P5)):
        flagged += int(fused.forwarded_children(i8, ns, cf["depth"],
                                                cf["lookback"]).sum())
        _walk_equal(i8, p5, part.tip_states, tab, ns, out=prior)
    assert flagged


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (64, 4)])
def test_fused_walk_all_tip_rows_and_ragged_tiles(cuda, states, cats):
    """All-tip rows (a table of the cherries, and dummy rows padding a
    table), then the dense table at other tiles and at pattern counts
    that no tile divides (100, a multiple of 4: 16-byte copies with a
    ragged last tile; 101: 4-byte copies)."""
    part, tree = _example(states, cats, cuda, n_taxa=16, n_sites=256)
    tab = fused.code_table(part)
    brl = _brl(tree, part)
    ops, _ = tree.traversal_ops(None)
    ops = np.asarray(ops)
    cherries = ops[(ops[:, 0] >= 0) & (ops[:, 1] < part.n_tips)
                   & (ops[:, 3] < part.n_tips)]
    for table in (fused.compile_fused_ops(part, cherries),
                  fused.compile_fused_ops(part, ops, pad_to=len(ops) + 5)):
        idx8, e1, e2, ns = table
        _walk_equal(torch.as_tensor(idx8, device=cuda),
                    _pmats(part, brl, e1, e2), part.tip_states, tab, ns)
    idx8, P5, ns, _ = _fused_table(part, tree, "fuse_root")
    for Ppad in (256, 100, 101):
        tc = part.tip_states[:, :Ppad].contiguous()
        tiles = {_build.fused_tile(cats, states, tab.shape[0], Ppad)} | {
            T for T in (4, 8, 16, 32, 64)
            if (cf := _build.fused_config(cats, states, tab.shape[0], T))
            and cf["kind"] != "fallback"}
        for T in sorted(tiles):
            _walk_equal(idx8, P5, tc, tab, ns, tile=T)


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (64, 4), (64, 8),
                                         (4, 64), (20, 64), (64, 64),
                                         (8, 256)])
def test_fused_walk_fallback_and_deep_configs(cuda, states, cats):
    """Every walk kind and pipeline depth where the shape takes them, bit
    for bit: the thread walk with its tables in shared memory or (8
    states, 256 categories) in device memory, the tile walk's rings of
    1-3 stage buffers and the fallback tile (matrices in device memory,
    one thread a category and pattern)."""
    part, tree = _example(states, cats, cuda, n_taxa=10, n_sites=128)
    tab = fused.code_table(part)
    idx8, P5, ns, _ = _fused_table(part, tree, "fuse_root")
    seen = set()
    for T in _build.TILES:
        cf = _build.fused_config(cats, states, tab.shape[0], T)
        if cf and (cf["kind"], cf["NB"]) not in seen:
            seen.add((cf["kind"], cf["NB"]))
            _walk_equal(idx8, P5, part.tip_states, tab, ns, tile=T)
    assert seen


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (64, 4), (5, 1),
                                         (16, 8), (4, 32)])
def test_child_pass_every_level_tile_and_ragged(cuda, states, cats):
    """Kernel 3 on both sides of every level (W = 1 levels included, on a
    caterpillar), at its default tile and forced ones, with tip children
    looked up or multiplied, and at 100 and 101 patterns."""
    part, tree = _example(states, cats, cuda, n_taxa=14, n_sites=256)
    tab = fused.code_table(part)
    for tr in (tree, _caterpillar(14)):
        lvls, offsets, _, ns = engine.compile_schedule(part, tr)
        idx, e1, e2 = levels.level_tables(part, lvls)
        P = part.prob_matrices(_brl(tr, part))
        P1, P2 = P[e1], P[e2]
        C, S = part.n_cats, part.states
        want = _level_walk_plain(idx, P1, P2, part.tip_states, tab, lvls,
                                 offsets, ns, C, S)
        for Ppad in (part.n_patterns_padded, 100, 101):
            tc = part.tip_states[:, :Ppad].contiguous()
            bufs = [want[0][..., :Ppad].contiguous(),
                    want[1][..., :Ppad].contiguous()]
            for lv, off in zip(lvls, offsets):
                s = slice(off, off + len(lv))
                for side, Pm in ((0, P1[s]), (1, P2[s])):
                    ref = levels.child_pass_plain(idx[s], side, *bufs, tc,
                                                  tab, Pm)
                    for T in (None, 4, 32, 128):
                        if T and not _build.child_config(C, S, tab.shape[0],
                                                         T):
                            continue
                        got = levels.child_pass(idx[s], side, *bufs, tc,
                                                tab, Pm, tile=T)
                        assert torch.equal(got[0], ref[0])
                        assert torch.equal(got[1], ref[1])


def test_tip_lookup_on_card_matches_expanded_tips(cuda):
    """The tip tables the kernels build equal their plain form, and a
    lookup the product on expanded tips (20 states, 4 categories)."""
    part, _ = _example(20, 4, cuda)
    P = part.prob_matrices(torch.tensor([0.1, 0.3], device=cuda))
    tab = fused.code_table(part)
    PT = fused.tip_tables_plain(P, tab)
    codes = part.tip_states[0]
    x = tab[codes.long()].T[None].expand(4, 20, codes.shape[0])
    assert torch.equal(fused.tip_lookup_plain(PT[1], codes),
                       clv.apply_pmat(P[1], x))


# ---------------------------------------------------------------------------
# the resident walk's shapes and tiles (kernel 1), kernel 10's designs
# ---------------------------------------------------------------------------
RESIDENT_STATES = (4, 5, 10, 16, 20, 32)


def _balanced(n):
    """A balanced tree on t0..t{n-1} (n a power of two), three subtrees
    at the root."""
    def sub(lo, hi):
        if hi - lo == 1:
            return f"t{lo}:0.1"
        mid = (lo + hi) // 2
        return f"({sub(lo, mid)},{sub(mid, hi)}):0.05"
    q = n // 4
    return Tree.from_newick(f"({sub(0, 2 * q)},{sub(2 * q, 3 * q)},"
                            f"{sub(3 * q, n)});")


def _resident_equal(idx8, P5, tc, tab, ns, tile=None):
    """Kernel 1 against its plain version: the root product and the
    scaler row bit for bit, launched once, of the kind its configuration
    names (the thread kind up to 4 states and 8 categories, the split
    kind only from 17 to 20 states). Returns that kind."""
    _, _, C, S, _ = P5.shape
    T, cf = _build.walk_launch_config("pllmod_resident_walk", C, S,
                                      tab.shape[0], ns, tc.shape[1], tile)
    assert (cf["kind"] == "thread") == (S <= 4 and C <= 8)
    assert cf["kind"] != "split" or 17 <= S <= 20
    before = LAUNCHES["pllmod_resident_walk"]
    kinds = RESIDENT_LAUNCHES.copy()
    prod_k, sc_k = resident.resident_walk(idx8, P5, tc, tab, ns, tile=tile)
    assert LAUNCHES["pllmod_resident_walk"] == before + 1
    kinds[cf["kind"]] += 1
    assert RESIDENT_LAUNCHES == kinds
    prod_p, sc_p = resident.resident_walk_plain(idx8, P5, tc, tab, ns)
    assert torch.equal(prod_k, prod_p)
    assert torch.equal(sc_k, sc_p)
    return cf["kind"]


@pytest.mark.parametrize("cats", (1, 2, 4, 8))
@pytest.mark.parametrize("states", RESIDENT_STATES + (2, 3))
def test_resident_walk_trees_tiles_and_ragged(cuda, states, cats):
    """Kernel 1 bit for bit on a caterpillar (the most live slots) and a
    balanced tree, at its own tile and every other tile where the slots
    fit, and at 100 and 101 patterns (bulk copies of the tip codes with a
    ragged last tile, and the threads' own loads); the thread kind at up
    to 4 states (S < 4: the guarded state loops)."""
    part, _ = _example(states, cats, cuda, n_taxa=16, n_sites=256)
    tab = fused.code_table(part)
    n_codes = tab.shape[0]
    for tree in (_caterpillar(16), _balanced(16)):
        tree.lengths[:] = np.linspace(0.02, 0.4, len(tree.lengths))
        idx8, e1, e2, ns = resident.compile_resident(part, tree)
        P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
        for Ppad in (part.n_patterns_padded, 100, 101):
            tc = part.tip_states[:, :Ppad].contiguous()
            T0 = _build.resident_tile(cats, states, n_codes, ns, Ppad)
            tiles = {T for T in _build.TILES
                     if _build.resident_config(cats, states, n_codes, ns, T)}
            assert (T0 is None) == (not tiles)
            for T in ([None] + sorted(tiles)) if tiles else ():
                _resident_equal(idx8, P5, tc, tab, ns, tile=T)


@pytest.mark.parametrize("cats", (1, 2, 4, 8))
@pytest.mark.parametrize("states", (2, 3, 4))
def test_resident_thread_kind_slots(cuda, states, cats):
    """Kernel 1's thread kind bit for bit from 1 live slot (3 to 6 taxa)
    to the 12-slot bound of 512 taxa (a 64-taxon tree's rows with more
    slots reserved), out slots aliasing a child's slot (slot recycling),
    at 256 and a ragged 200 patterns (a last tile of 8 patterns)."""
    trees = []
    for n in (3, 4, 5, 6, 64):
        part, tree = _example(states, cats, cuda, n_taxa=n, n_sites=256)
        trees += [(part, tree, None)]
    trees += [(part, tree, ns) for ns in (5, 9, 12)]
    slots, aliased = set(), 0
    for part, tree, ns_min in trees:
        tab = fused.code_table(part)
        idx8, e1, e2, ns = resident.compile_resident(part, tree,
                                                     n_slots_min=ns_min)
        rows = idx8[:-1].cpu().numpy()
        aliased += int(sum(((r[2] == 0) & (r[0] == r[6]))
                           | ((r[3] == 0) & (r[1] == r[6])) for r in rows))
        slots.add(ns)
        P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
        for Ppad in (256, 200):
            tc = part.tip_states[:, :Ppad].contiguous()
            assert _resident_equal(idx8, P5, tc, tab, ns) == "thread"
    assert {1, 5, 9, 12} <= slots and aliased > 0


def test_resident_thread_kind_wide(cuda):
    """Kernel 1's thread kind bit for bit at 3,000 taxa × 2,048 patterns
    (DNA +G4, the capacity cell's five codes drawn on the card), at its
    own tile and every tile where it fits."""
    part, _ = _example(4, 4, cuda)
    rng = np.random.default_rng(5)
    tree = flagship.random_binary_tree(rng, 3000, 0.02, 0.4)
    from types import SimpleNamespace
    idx8, e1, e2, ns = resident.compile_resident(
        SimpleNamespace(n_tips=3000, device=cuda), tree)
    P5 = fused.pair_pmats(part, _brl(tree, part), e1, e2, root_row=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    tc = torch.randint(0, 5, (3000, 2048), dtype=torch.int32, device=cuda,
                       generator=gen)
    tab = torch.cat([torch.ones(1, 4), torch.eye(4)]).to(cuda)
    tiles = [T for T in _build.TILES
             if _build.resident_config(4, 4, 5, ns, T)]
    assert tiles
    for T in [None] + tiles:
        assert _resident_equal(idx8, P5, tc, tab, ns, tile=T) == "thread"


def _newton_case(shapes, cuda, n_sites=512):
    """(parts, sts, scs, t0, scalers, live) of ``shapes`` on one tree."""
    tree = None
    parts, sts, scs = [], [], []
    scalers = (1.0, 0.5, 1.7)[:len(shapes)]
    for k, (states, cats) in enumerate(shapes):
        part, t = _example(states, cats, cuda, n_sites=n_sites)
        tree = tree or t
        tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
        clvs, sc_k = blo._directed_clvs(part, tabs,
                                        _brl(tree, part) * scalers[k])
        st, sc = deriv.edge_sumtables(part, clvs, sc_k, tabs.eref6,
                                      tabs.basis)
        parts.append(part)
        sts.append(st)
        scs.append(sc)
    live = torch.as_tensor(blo.DirectedTraversal(tree).edge_mask,
                           device=cuda)
    return parts, sts, scs, _brl(tree, parts[0]), scalers, live


@pytest.mark.parametrize("shapes,n_sites", [
    (((4, 4),), 512), (((4, 4), (20, 4)), 512), (((4, 4),), 8192)],
    ids=["K1", "K2", "K1-wide"])
def test_newton_every_design_matches_plain(cuda, shapes, n_sites):
    """Kernel 10 in every design that holds the shape (the streaming CTA
    and clusters of 2, 4, 8 and 16 CTAs an edge) within the derivative
    tolerance of its plain version (at 8192 sites a thread sums 1, 2 or
    4 patterns at once, by the cluster size); the one partition given
    twice lands on the same lengths with twice the logL, bit for bit, in
    every design."""
    parts, sts, scs, t0, scalers, live = _newton_case(shapes, cuda, n_sites)
    args = (parts, sts, scs, t0, scalers, 1e-4, 100.0, 1e-4, 10)
    want = deriv.newton_edges_multi_plain(*args)
    cs = [p.n_cats * p.states for p in parts]
    ppads = [p.n_patterns_padded for p in parts]
    seen = []
    for force in (1,) + deriv.NEWTON_CLUSTERS:
        if deriv.newton_config(cs, ppads, force) is None:
            continue
        got = deriv.newton_edges_multi(*args, force=force)
        torch.cuda.synchronize()
        assert _rel(got[0][live], want[0][live], 1e-4) < 5e-4
        assert _rel(got[1][live], want[1][live], 1e-2) < 2e-6
        if len(parts) == 1 and deriv.newton_config(cs * 2, ppads * 2,
                                                    force):
            twice = deriv.newton_edges_multi(
                parts * 2, sts * 2, scs * 2, t0, scalers * 2, 1e-4, 100.0,
                1e-4, 10, force=force)
            assert torch.equal(twice[0], got[0])
            assert torch.equal(twice[2], got[2])
            assert torch.equal(twice[1], 2 * got[1])
        seen.append(force)
    # every design at 512 sites; at 8192 the edge needs 4 CTAs or more
    assert seen == ([1, 2, 4, 8, 16] if n_sites == 512 else [1, 4, 8, 16])
    with pytest.raises(ValueError, match="cluster of 3"):
        deriv.newton_edges_multi(*args, force=3)


# ---------------------------------------------------------------------------
# kernel 8: the tiled sumtable kernel's shapes, tiles and rings, and the
# simple kernel the rule keeps for the shapes it does not take
# ---------------------------------------------------------------------------
SUMTABLE_STATES = (4, 5, 8, 16, 20, 32, 61, 64)


def _sumtable_occupancy(C, S, n_codes, Ppad, E):
    """The CTAs an SM the card holds of kernel 8's tiled kernel at the
    rule's configuration (-1 where there is none)."""
    return _build.load().pllmod_sumtable_occupancy(C, S, n_codes, Ppad, E,
                                                   0)


def _sumtables_equal(part, clvs, scalers, eref, basis, **force):
    before = LAUNCHES["pllmod_edge_sumtables"]
    st, sc = deriv.edge_sumtables(part, clvs, scalers, eref, basis, **force)
    st_p, sc_p = deriv.edge_sumtables_plain(part, clvs, scalers, eref, basis)
    torch.cuda.synchronize()
    assert torch.equal(st, st_p), force
    assert torch.equal(sc, sc_p), force
    assert LAUNCHES["pllmod_edge_sumtables"] == before + 1


def _n_codes(part):
    return part.code_clv.shape[0]


@pytest.mark.parametrize("cats", [1, 4, 8])
@pytest.mark.parametrize("states", SUMTABLE_STATES)
def test_sumtable_kernel_state_ladder(cuda, states, cats):
    """Kernel 8 bit for bit on every edge row (dead rows are tip/tip
    dummies) at the state ladder's shapes: by the rule, the simple kernel
    forced, and the tiled kernel at every tile it takes (none at 61 and
    64 states of 4 and 8 categories, whose tables exceed a block)."""
    part, tree = _example(states, cats, cuda, n_taxa=10, n_sites=512)
    tabs, clvs, scalers = _directed(part, tree)
    args = (part, clvs, scalers, tabs.eref6, tabs.basis)
    _sumtables_equal(*args)
    _sumtables_equal(*args, simple=True)
    Ppad, E = part.n_patterns_padded, tabs.eref6.shape[0]
    tiles = [T for T in _build.SUMTABLE_TILES if _build.sumtable_config(
        cats, states, _n_codes(part), Ppad, E, T)]
    assert (not tiles) == (states > 32 and cats > 1)
    for T in tiles:
        _sumtables_equal(*args, tile=T)


def test_sumtable_kernel_tip_tip_rows(cuda):
    """A 3-taxon tree (every edge joins a tip to the inner node) and rows
    that join two tips, in the tiled and the simple kernel."""
    part, tree = _example(20, 4, cuda, n_taxa=3, n_sites=512)
    tabs, clvs, scalers = _directed(part, tree)
    tiptip = torch.tensor([[0, 0, 1, 1, 0, 1], [0, 0, 1, 1, 2, 2]],
                          dtype=torch.int32, device=cuda)
    eref = torch.cat([tabs.eref6, tiptip])
    for force in ({}, {"simple": True}, {"tile": 4}, {"tile": 32}):
        _sumtables_equal(part, clvs, scalers, eref, tabs.basis, **force)


@pytest.mark.parametrize("states,cats", [(20, 4), (4, 4)])
def test_sumtable_kernel_more_items_than_the_grid(cuda, states, cats):
    """Persistent CTAs that loop: E = grid + 1 rows (the live edges over
    and over, so that neither E nor the work items are a multiple of the
    persistent grid) at the rule's tile and at the smallest pattern tile
    (4 patterns)."""
    part, tree = _example(states, cats, cuda, n_taxa=24, n_sites=512)
    tabs, clvs, scalers = _directed(part, tree)
    live = torch.nonzero(torch.as_tensor(
        blo.DirectedTraversal(tree).edge_mask)).flatten().to(cuda)
    n_codes, Ppad = _n_codes(part), part.n_patterns_padded
    cf = _build.sumtable_config(cats, states, n_codes, Ppad, 10 ** 4)
    occ = _sumtable_occupancy(cats, states, n_codes, Ppad, 10 ** 4)
    assert occ >= 1
    grid = occ * torch.cuda.get_device_properties(cuda).multi_processor_count
    E = grid + 1
    eref = tabs.eref6[live[torch.arange(E, device=cuda) % len(live)]]
    assert (E * (Ppad // cf["T"])) % grid != 0
    assert _build.sumtable_config(cats, states, n_codes, Ppad, E) == cf
    for force in ({}, {"tile": 4}):
        _sumtables_equal(part, clvs, scalers, eref, tabs.basis, **force)


def test_sumtable_kernel_table_beyond_shared_memory(cuda):
    """A custom alphabet of 230 ambiguity codes over 32 states: the tip
    tables of 4 categories (2 · 4 · 231 · 32 floats) do not fit a block
    beside the bases, so the rule takes the simple kernel, which reads
    them from device memory; bit for bit all the same. Random CLVs and
    scalers, the BLO's edge rows."""
    S, C = 32, 4
    rng = np.random.default_rng(8)
    chars = [chr(c) for c in range(1, 256) if chr(c) != "-"][:230]
    masks = rng.choice(np.arange(1, 2 ** 20), 230, replace=False)
    masks = [int(m) << int(rng.integers(0, 12)) for m in masks]
    cmap = charmap.custom(S, dict(zip(chars, masks)) | {"-": 2 ** S - 1},
                          "many", case_insensitive=False)
    n_taxa = 8
    seqs = [bytes(ord(c) for c in rng.choice(chars, 512)) for _ in
            range(n_taxa)]
    tree = Tree.from_newick(flagship.random_newick(n_taxa, rng))
    part = create_partition(
        seqs, charmap=cmap, n_rate_cats=C, alpha=0.75,
        subst_rates=rng.uniform(0.5, 2.0, S * (S - 1) // 2),
        freqs=rng.dirichlet([10] * S), compress=False, device="cpu")
    part = part.cache_eigen().to(cuda)
    n_codes, Ppad = _n_codes(part), part.n_patterns_padded
    tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
    assert n_codes > 200
    assert _build.sumtable_config(C, S, n_codes, Ppad,
                                  tabs.eref6.shape[0]) is None
    n_slots = int(tabs.eref6[:, :2].max()) + 1
    gen = torch.Generator(device=cuda).manual_seed(3)
    clvs = torch.rand((n_slots, C * S, Ppad), device=cuda, generator=gen)
    scalers = torch.randint(-4, 4, (n_slots, 1, Ppad), dtype=torch.int32,
                            device=cuda, generator=gen)
    _sumtables_equal(part, clvs, scalers, tabs.eref6, tabs.basis)


def test_sumtable_wrapper_refuses_forced_configs(cuda):
    """A forced tile that the tiled kernel does not take raises; it is
    never swapped for another or for the simple kernel."""
    part, tree = _example(20, 4, cuda)
    tabs, clvs, scalers = _directed(part, tree)
    args = (part, clvs, scalers, tabs.eref6, tabs.basis)
    with pytest.raises(ValueError, match="no configuration"):
        deriv.edge_sumtables(*args, tile=256)     # 1280 threads
    with pytest.raises(ValueError, match="no configuration"):
        deriv.edge_sumtables(*args, tile=3)


# ---------------------------------------------------------------------------
# the group-window walk (kernels 6 and 7, csrc/group_walk.cuh)
# ---------------------------------------------------------------------------
# the state ladder (every register tile and both walk designs) at C = 1,
# 4 and 8
GROUP_LADDER = [(s, c) for s in (4, 5, 8, 16, 20, 32, 64) for c in (1, 4, 8)]


def _fitting(C, S, n_codes, lanes=(1, 2, 3, 4, 8)):
    """Every (tile, lanes) whose group-walk configuration fits."""
    return [(T, R) for R in lanes for T in _build.TILES
            if _build.group_walk_config(C, S, n_codes, T, R)]


@pytest.mark.parametrize("states,cats", GROUP_LADDER)
def test_group_walks_state_ladder(cuda, states, cats):
    """Kernels 6 and 7 bit for bit with their plain versions along the
    state ladder, at the rule's tile and lanes and at the widest tile
    that fits with two lanes (windows of several steps)."""
    part, tree = _example(states, cats, cuda)
    _check_packed_kernel(part, tree)
    _check_grouped_kernel(part, tree)
    n_codes = part.code_clv.shape[0]
    T, R = next((T, R) for T, R in _fitting(cats, states, n_codes, (2,)))
    _check_packed_kernel(part, tree, tile=T, lanes=R)
    _check_grouped_kernel(part, tree, tile=T, lanes=R)


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4)])
def test_group_walks_every_tile_and_lane_count(cuda, states, cats):
    """Both walks at every (tile, lanes) that fits, three lanes among
    them: windows longer than a step (the 24-taxon tree's first window
    holds 8 rows and more) and steps with idle lanes."""
    part, tree = _example(states, cats, cuda)
    for T, R in _fitting(cats, states, part.code_clv.shape[0]):
        _check_packed_kernel(part, tree, tile=T, lanes=R)
        _check_grouped_kernel(part, tree, tile=T, lanes=R)


@pytest.mark.parametrize("case", ["caterpillar", "tip_root", "group3",
                                  "g16"])
def test_group_walks_edge_cases(cuda, case):
    """A caterpillar (every level narrower than G: one row, the packed
    walk's other rows dummies, and windows of one row), a root on a tip
    edge, G = 3 given, and G = 16 (C·S = 4), each at a narrow and a
    wide configuration."""
    part, tree = _example(4, 4, cuda, n_taxa=14)
    root_edge, group = None, 0
    if case == "caterpillar":
        tree = _caterpillar(14)
        tree.lengths[:] = np.linspace(0.02, 0.3, len(tree.lengths))
    elif case == "tip_root":
        root_edge = _tip_edge(tree)
    elif case == "group3":
        group = 3
    else:
        part, tree = _example(4, 1, cuda, n_taxa=40)
    for walk in ({}, dict(tile=64, lanes=4)):
        sched = _check_packed_kernel(part, tree, root_edge, group, **walk)
        gs = _check_grouped_kernel(part, tree, root_edge, group, **walk)
    if case == "caterpillar":
        assert len(sched.windows) - 1 == 12 and len(gs.windows) - 1 == 12
    if case == "g16":
        assert gs.G == 16


def test_group_walks_protein_code_table(cuda):
    """A protein alphabet's code table (21 codes, beyond the 20 states)
    through the tip lookups of both walks, tile and wide kinds."""
    part, tree = _example(20, 4, cuda, n_taxa=32)
    assert part.code_clv.shape[0] >= 21
    for walk in ({}, dict(tile=32, lanes=2), dict(tile=128, lanes=1)):
        _check_packed_kernel(part, tree, **walk)
        _check_grouped_kernel(part, tree, **walk)


def test_group_walks_more_ctas_than_sms(cuda):
    """More CTAs than the card has SMs (4096 patterns at tile 4 and 8)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for states in (4, 20):
        part, tree = _example(states, 4, cuda, n_taxa=16, n_sites=4096)
        for T in (4, 8):
            assert part.n_patterns_padded // T > n_sm
            _check_packed_kernel(part, tree, tile=T, lanes=2)
            _check_grouped_kernel(part, tree, tile=T, lanes=2)


@pytest.mark.parametrize("tile,lanes", [(4, 8), (8, 8), (4, 4)])
def test_group_walks_repeated_launches(cuda, tile, lanes):
    """The tile walk with tensor copies (20 states) at many lanes a CTA,
    where a lane's threads span warps and most steps' copies were issued
    a step ahead (one barrier a step), launched 20 times each on a
    256-taxon tree: every launch bit for bit with the plain version. (A
    lane's next step writing the category maxima that a slower thread
    still read showed in 5 to 8 launches of 20 at the protein cell.)"""
    from pllmod_tpu_torch.ops import packed
    part, tree = _example(20, 4, cuda, n_taxa=256, n_sites=2048)
    n_codes = part.code_clv.shape[0]
    assert _build.group_walk_config(4, 20, n_codes, tile, lanes)["kind"] \
        == "tile"
    tab, tc = fused.code_table(part), part.tip_states
    ps = packed.PackedSchedule(part, tree)
    P = part.prob_matrices(_brl(tree, part)).contiguous()
    pargs = (ps.idxm, ps.e1, ps.e2, P, tc, tab, ps.G)
    pwant = packed.packed_walk_plain(*pargs)
    gs = grouped.GroupedSchedule(part, tree)
    PQ = grouped.grouped_pmats(part, _brl(tree, part), gs.e_sides)
    gargs = (gs.side_meta, gs.dst_meta, PQ, tc, tab)
    dg, dq = gs.dst_meta[..., 0].long(), gs.dst_meta[..., 1].long()
    gwant = [w[dg, dq] for w in grouped.grouped_walk_plain(*gargs)]
    for _ in range(20):
        got = packed.packed_walk(*pargs, ps.windows, tile=tile, lanes=lanes)
        assert all(torch.equal(g, w) for g, w in zip(got, pwant))
        got = grouped.grouped_walk(*gargs, gs.order, gs.windows, tile=tile,
                                   lanes=lanes)
        assert all(torch.equal(g[dg, dq], w) for g, w in zip(got, gwant))


def test_group_walk_wrappers_raise(cuda):
    """Kernels 6 and 7 refuse what no configuration takes and tables off
    the card; neither falls back to its plain version."""
    from pllmod_tpu_torch.ops import packed
    part, tree = _example(4, 4, cuda)
    ps = packed.PackedSchedule(part, tree)
    P = part.prob_matrices(_brl(tree, part)).contiguous()
    tab, tc = fused.code_table(part), part.tip_states
    pargs = (ps.idxm, ps.e1, ps.e2, P, tc, tab, ps.G)
    gs = grouped.GroupedSchedule(part, tree)
    PQ = grouped.grouped_pmats(part, _brl(tree, part), gs.e_sides)
    gargs = (gs.side_meta, gs.dst_meta, PQ, tc, tab)
    before = LAUNCHES["pllmod_packed_walk"], LAUNCHES["pllmod_grouped_walk"]
    with pytest.raises(ValueError, match="no launch configuration"):
        packed.packed_walk(*pargs, ps.windows, tile=128, lanes=8)
    with pytest.raises(ValueError, match="no launch configuration"):
        grouped.grouped_walk(*gargs, gs.order, gs.windows, tile=128,
                             lanes=8)
    with pytest.raises(ValueError, match="CUDA device"):
        packed.packed_walk(*pargs, ps.windows.cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        grouped.grouped_walk(*gargs, gs.order.cpu(), gs.windows)
    assert (LAUNCHES["pllmod_packed_walk"],
            LAUNCHES["pllmod_grouped_walk"]) == before


# ---------------------------------------------------------------------------
# model-parameter optimization (algorithm/opt_model.py)
# ---------------------------------------------------------------------------
def _decomp_vg(part, tree, build, x):
    from pllmod_tpu_torch.optimize import edge_grad as eg
    et = eg.edge_tables(part, tree)
    xt = torch.tensor(x, dtype=torch.float64, device=part.device,
                      requires_grad=True)
    f = eg.edge_decomp_neg_loglh(build(part)(xt), _brl(tree, part).to(
        part.dtype), et)
    g, = torch.autograd.grad(f, xt)
    return float(f.detach()), g.cpu().numpy()


def _decomp_families():
    from pllmod_tpu_torch.optimize import edge_grad as eg

    def rates(p):
        R = p.states * (p.states - 1) // 2
        return lambda z: eg.with_rates(p, eg.expand_sym(
            z, torch.arange(R, device=p.device), R - 1))
    return {"rates": rates,
            "freqs": lambda p: lambda z: eg.with_freq_ratios(p, z),
            "alpha_pinv": lambda p: lambda z: eg.with_alpha_pinv(p, z),
            "cats": lambda p: lambda z: eg.with_cats(p, z)}


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (5, 4)])
def test_edge_decomposition_on_card_matches_float64(cuda, states, cats):
    """The four gradient families' (value, grad) on the card: float32
    through kernel 2's directed walk against float64 through the serial
    engine, to tools/tpu_parity.py's bar (relative f < 1e-6, relative
    g < 1e-3); every float32 evaluation launches kernel 2."""
    part, tree = _example(states, cats, cuda)
    part64 = part.to(dtype=torch.float64).with_model_params()
    part = part.with_model_params()
    R, S = states * (states - 1) // 2, states
    points = {"rates": np.linspace(0.7, 1.8, R - 1),
              "freqs": np.linspace(0.8, 1.3, S - 1),
              "alpha_pinv": np.array([0.6, 0.15]),
              "cats": np.linspace(0.2, 2.0, cats)}
    for name, build in _decomp_families().items():
        before = LAUNCHES["pllmod_fused_walk"]
        f32, g32 = _decomp_vg(part, tree, build, points[name])
        assert LAUNCHES["pllmod_fused_walk"] == before + 1, name
        f64, g64 = _decomp_vg(part64, tree, build, points[name])
        assert abs(f32 - f64) / abs(f64) < 1e-6, name
        rel_g = np.abs(g32 - g64) / (np.abs(g64) + 1e-2 * np.abs(g64).max())
        assert rel_g.max() < 1e-3, name


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4)])
def test_em_estep_on_card_matches_serial_engine(cuda, states, cats):
    """The EM E-step's per-site per-category likelihoods from kernel 2's
    walk over the op table (float32) against the serial engine
    (float64) on the card: the site mixtures' logs, the posterior
    category shares and the EM weights of both."""
    from pllmod_tpu_torch.algorithm import opt_model as om
    from pllmod_tpu_torch.optimize.em import em_rates_weights
    part, tree = _example(states, cats, cuda)
    out = {}
    for p in (part, part.to(dtype=torch.float64)):
        before = LAUNCHES["pllmod_fused_walk"]
        with torch.no_grad():
            lh, sc = om.site_cat_likelihood(p, tree, _brl(tree, p).to(
                p.dtype))
        assert LAUNCHES["pllmod_fused_walk"] == \
            before + (p.dtype == torch.float32)
        mix = lh.double()[:p.n_patterns] * p.rate_weights.double()
        site = mix.sum(1)
        ln = torch.log(site) + sc.double()[:p.n_patterns] * clv.LN2
        w = em_rates_weights(lh.cpu().double(), p.pattern_weights.cpu(),
                             p.rate_weights.cpu())
        out[p.dtype] = (ln, mix / site[:, None], w.double())
    (a, pa, wa), (b, pb, wb) = out[torch.float32], out[torch.float64]
    assert float((a - b).abs().max()) < 1e-5
    assert float((pa - pb).abs().max()) < 1e-5
    assert float((wa - wb).abs().max()) < 1e-5


def test_model_functions_on_cuda_tensors(cuda):
    """The P-matrix and alpha Functions on CUDA tensors: the P-matrix
    forward and backward on the card equal the CPU's, finite at the JC
    spectrum; the alpha discretization's result and gradient land on
    the card."""
    from pllmod_tpu_torch.ops import eigen, gamma
    rng = np.random.default_rng(3)
    for rates, freqs in ((rng.uniform(0.5, 2.0, (1, 6)),
                          rng.dirichlet([5] * 4, 1)),
                         (np.ones((1, 6)), np.full((1, 4), 0.25))):
        args = [rates, freqs, rng.uniform(0.05, 0.5, 9),
                np.array([0.3, 0.8, 1.2, 1.7]), np.array([0.1])]
        grads = {}
        for dev in ("cpu", cuda):
            ts = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in args]
            P = eigen.prob_matrices_params(
                ts[0], ts[1], ts[2], ts[3],
                torch.zeros(4, dtype=torch.int64, device=dev), ts[4])
            assert P.device.type == torch.device(dev).type
            cot = torch.linspace(-1, 1, P.numel(), dtype=torch.float64,
                                 device=dev).view_as(P)
            grads[str(dev)] = [P.detach().cpu()] + [
                g.cpu() for g in torch.autograd.grad(P, ts, cot)]
        for g, h in zip(grads["cpu"], grads[str(cuda)]):
            assert torch.isfinite(h).all()
            assert torch.allclose(g, h, rtol=1e-10, atol=1e-12)
    a = torch.tensor(0.7, dtype=torch.float32, device=cuda,
                     requires_grad=True)
    r = gamma.compute_gamma_cats(a, 4)
    assert r.device.type == "cuda" and r.dtype == torch.float32
    g, = torch.autograd.grad(r @ torch.arange(4.0, device=cuda), a)
    assert g.device.type == "cuda"
    want = gamma.gamma_cats_alpha_grad(0.7, 4) @ np.arange(4.0)
    assert float(g) == pytest.approx(want, rel=1e-5)


def test_opt_model_on_card_matches_float64(cuda):
    """One opt_model round on the card (float32: kernels 1, 2 and 8-10):
    its logL is at or above its start and is the float64 serial
    engine's at the returned parameters and lengths; kernel 2 launched
    for the gradients."""
    from pllmod_tpu_torch.algorithm import opt_model as om
    from pllmod_tpu_torch.common import PARAM_ALL
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    part, tree = _example(4, 4, cuda)
    ti = TreeInfo(tree.copy(), [part], params_to_optimize=PARAM_ALL)
    start = ti.compute_loglh()
    before = (LAUNCHES["pllmod_fused_walk"],
              LAUNCHES["pllmod_resident_walk"])
    lnl = om.opt_model(ti)
    assert lnl >= start
    assert LAUNCHES["pllmod_fused_walk"] > before[0]
    assert LAUNCHES["pllmod_resident_walk"] > before[1]
    p64 = ti.partitions[0].to(dtype=torch.float64).with_model_params()
    want = float(engine.tree_loglikelihood(p64, ti.tree, schedule="scan"))
    assert abs(lnl - want) / abs(want) < 1e-6


def _spr_batch(part, tree, K):
    """The first K candidates' concatenated remainder table of an SPR
    batch (``algorithm/spr.py``) with its kernel-2 table and matrices."""
    from pllmod_tpu_torch.algorithm import spr
    builds = []
    for e, j in spr._prune_candidates(tree):
        b = spr._build_candidate(tree, e, j, 1, 10)
        if b is not None:
            builds.append(b[0])
        if len(builds) == K:
            break
    stride = 3 * (tree.n_tips - 2) + 2
    tabs = spr._batch_tables(tree, builds, stride)
    wt = blo.walk_tables(part, tabs["ops_cat"], K * stride)
    brl = torch.as_tensor(tabs["brl_cat"], dtype=part.dtype,
                          device=part.device)
    P5 = fused.pair_pmats(part, brl, wt.e1, wt.e2, root_row=False)
    return wt.idx8, P5, wt.n_slots


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4)])
def test_spr_batch_table_matches_plain(cuda, states, cats):
    """Kernel 2 over a K-candidate SPR table (16 remainder trees, K·stride
    slots) equals its plain walk bit for bit, every slot."""
    part, tree = _example(states, cats, cuda, n_taxa=40, n_sites=256)
    idx8, P5, ns = _spr_batch(part, tree, 16)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded

    def zeros():
        return (torch.zeros((ns, C * S, Ppad), device=cuda),
                torch.zeros((ns, 1, Ppad), dtype=torch.int32, device=cuda))
    args = (idx8, P5, part.tip_states, fused.code_table(part), ns)
    before = LAUNCHES["pllmod_fused_walk"]
    k_clv, k_sc = fused.fused_walk(*args, out=zeros())
    assert LAUNCHES["pllmod_fused_walk"] == before + 1
    p_clv, p_sc = fused.fused_walk_plain(*args, out=zeros())
    assert ns == 16 * (3 * (40 - 2) + 2)
    assert torch.equal(k_clv, p_clv)
    assert torch.equal(k_sc, p_sc)


@pytest.mark.parametrize("thorough", [False, True])
def test_spr_batch_limit_follows_free_memory(cuda, monkeypatch, thorough):
    """The auto batch limit is the power of two below half the card's
    free bytes over a candidate's bytes (uncapped here), and 16 with the
    cap. The free bytes count the blocks the caching allocator holds
    unused: 8 GiB freed but kept reserved leave the limit as it was."""
    from pllmod_tpu_torch.algorithm import spr
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    part, tree = flagship.example(128, 16384, seed=3, device="cuda")
    ti = TreeInfo(tree, [part])
    E = len(tree.edge_nodes)
    stride = 3 * (tree.n_tips - 2) + 2
    slot = part.n_cats * part.states * part.n_patterns_padded * 4
    rows = (spr.THOROUGH_ROW_SLOTS * spr._window_bound(E) if thorough
            else 4 * E)
    monkeypatch.setattr(spr, "SPR_BATCH_MAX", None)
    monkeypatch.setattr(spr, "SPR_BATCH_CAP", 1 << 30)

    def free():
        return (torch.cuda.mem_get_info(cuda)[0]
                + torch.cuda.memory_reserved(cuda)
                - torch.cuda.memory_allocated(cuda))

    def want(free):
        n = max(1, free // 2 // ((stride + rows) * slot))
        return 1 << (n.bit_length() - 1)
    free0 = free()
    k = spr._spr_batch_limit(ti, E, stride, thorough)
    free1 = free()
    assert k in (want(free0), want(free1)) and k >= 2
    held = torch.empty(8 << 30, dtype=torch.uint8, device=cuda)
    del held                       # freed, still reserved
    assert torch.cuda.memory_reserved(cuda) - torch.cuda.memory_allocated(
        cuda) >= 8 << 30
    assert spr._spr_batch_limit(ti, E, stride, thorough) in (
        want(free0), want(free1), want(free()))
    torch.cuda.empty_cache()
    monkeypatch.setattr(spr, "SPR_BATCH_CAP", 16)
    assert spr._spr_batch_limit(ti, E, stride, thorough) == min(16, k)


def test_spr_round_on_card_matches_float64(cuda, monkeypatch):
    """One fast SPR round at 32 taxa on the card (float32: kernel 2 for
    every directed CLV, kernels 1 and 8-10) against the same round in
    float64 on the card (the serial engine): the same final topology,
    each logL at or above its start, the float32 logL within 1e-6 of the
    float64 serial engine at its tree and lengths. No plain walk runs."""
    from pllmod_tpu_torch.algorithm import spr
    from pllmod_tpu_torch.tree import splits
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    part, truth = flagship.simulated(32, 1024, seed=9, device="cuda")
    start = truth.copy()
    flagship.random_spr(start, 4, np.random.default_rng(1))
    out = {}
    for dt in (torch.float32, torch.float64):
        p = part.to(dtype=dt).with_model_params().cache_eigen()
        ti = TreeInfo(start.copy(), [p])
        lnl0 = ti.compute_loglh()
        if dt == torch.float32:
            def no_plain(*a, **k):
                raise AssertionError("a plain walk ran on the card")
            monkeypatch.setattr(clv, "walk_rows_plain", no_plain)
            before = (LAUNCHES["pllmod_fused_walk"],
                      LAUNCHES["pllmod_newton_edges"])
        lnl, n, _ = spr.spr_round(ti)
        if dt == torch.float32:
            monkeypatch.undo()
            assert LAUNCHES["pllmod_fused_walk"] > before[0]
            assert LAUNCHES["pllmod_newton_edges"] > before[1]
        assert lnl >= lnl0 and n > 0
        out[dt] = (lnl, ti)
    lnl32, ti32 = out[torch.float32]
    lnl64, ti64 = out[torch.float64]
    assert splits.rf_distance(ti32.tree, ti64.tree) == 0
    p64 = ti32.partitions[0].to(dtype=torch.float64).with_model_params()
    want = float(engine.tree_loglikelihood(p64, ti32.tree, schedule="scan"))
    assert abs(lnl32 - want) / abs(want) < 1e-6
    assert abs(lnl32 - lnl64) / abs(lnl64) < 1e-6


def test_checkpointed_search_and_resume_on_card(cuda, tmp_path):
    """A checkpointed ``ml_search`` at 24 taxa on the card (float32: the
    kernels; a fast round, then the thorough stage) and its resume from
    the checkpoint after round 1 into a fresh TreeInfo: each round at or
    above the best before it, the end within 1e-6 of the float64 serial
    engine; the resumed run keeps round 1 and ends at or above the full
    run's end less 0.1; a checkpoint loaded onto the card holds the
    file's arrays, bit for bit those loaded onto the CPU."""
    import shutil
    from pllmod_tpu_torch.algorithm.search import ml_search
    from pllmod_tpu_torch.binary import load_treeinfo
    from pllmod_tpu_torch.common import PARAM_ALPHA, PARAM_BRANCHES_ITERATIVE
    from pllmod_tpu_torch.convert import ARRAY_FIELDS
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    part, truth = flagship.simulated(24, 512, seed=9, device="cuda")
    part = part.cache_eigen()
    start = truth.copy()
    flagship.random_spr(start, 3, np.random.default_rng(4))
    mask = PARAM_ALPHA | PARAM_BRANCHES_ITERATIVE
    kw = dict(radius_step=2, radius_max=3, max_rounds=4, lh_epsilon=0.01)
    ck, ck1 = str(tmp_path / "search.ck"), str(tmp_path / "round1.ck")

    def on_round(rec):
        if not seen:
            shutil.copy(ck, ck1)
        seen.append(rec)

    seen = []
    before = (LAUNCHES["pllmod_fused_walk"],
              LAUNCHES["pllmod_newton_edges"])
    ti = TreeInfo(start.copy(), [part], params_to_optimize=mask)
    res = ml_search(ti, checkpoint_path=ck, on_round=on_round, **kw)
    assert LAUNCHES["pllmod_fused_walk"] > before[0]
    assert LAUNCHES["pllmod_newton_edges"] > before[1]
    best = res.start_loglh
    for r in res.rounds:
        assert r.loglh >= best - 1e-3
        best = max(best, r.loglh)
    assert res.loglh > res.start_loglh and res.rounds[0].n_applied > 0
    p64 = ti.partitions[0].to(dtype=torch.float64).with_model_params()
    want = float(engine.tree_loglikelihood(p64, ti.tree, schedule="scan"))
    assert abs(res.loglh - want) / abs(want) < 1e-6
    on_card, _ = load_treeinfo(ck1)
    on_cpu, _ = load_treeinfo(ck1, device="cpu")
    for f in ARRAY_FIELDS:
        got = getattr(on_card.partitions[0], f)
        assert got.is_cuda
        assert torch.equal(got.cpu(), getattr(on_cpu.partitions[0], f))
    ti2 = TreeInfo(start.copy(), [part], params_to_optimize=mask)
    res2 = ml_search(ti2, checkpoint_path=ck1, resume=True, **kw)
    assert res2.rounds[0] == res.rounds[0]
    assert res2.loglh >= res.loglh - 0.1
    assert ti2.partitions[0].device.type == "cuda"


# ---------------------------------------------------------------------------
# the site mesh (pllmod_tpu_torch/parallel): four shards on one card, or
# one shard a card
# ---------------------------------------------------------------------------
def _mesh_case(n_taxa=24, n_sites=512, seed=11):
    part, tree = flagship.example(n_taxa, n_sites, seed=seed, device="cpu")
    return part.cache_eigen(), tree


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    return [f"cuda:{i}" for i in range(n)]


@pytest.mark.parametrize("route", ["resident", "fused"])
def test_sharded_walk_matches_plain(cuda, route):
    """Kernel 1 or 2 on each of four shards on one card (the launches
    one a shard), reduced, against the same sharded evaluation on the
    CPU (the plain versions), within 1e-6 relative."""
    from pllmod_tpu_torch.parallel import (loglikelihood_fused_sharded,
                                           loglikelihood_resident_sharded,
                                           make_mesh)
    fn = (loglikelihood_resident_sharded if route == "resident"
          else loglikelihood_fused_sharded)
    kernel = ("pllmod_resident_walk" if route == "resident"
              else "pllmod_fused_walk")
    part, tree = _mesh_case()
    before = LAUNCHES[kernel]
    got = float(fn(part.to(cuda), tree, tree.lengths,
                   make_mesh([cuda] * 4)))
    assert LAUNCHES[kernel] == before + 4
    want = float(fn(part, tree, tree.lengths, make_mesh(["cpu"] * 4)))
    assert abs(got - want) / abs(want) < 1e-6


def test_sharded_blo_sweep_matches_plain(cuda):
    """One sharded Newton sweep (kernels 2, 8 and 9 on each of four
    shards, the derivatives reduced every iteration) against the same
    sweep on the CPU's plain versions: logL within 2e-6, lengths within
    5e-4 relative; kernel 10 does not launch."""
    from pllmod_tpu_torch.parallel import blo_sweep_fast_sharded, make_mesh
    part, tree = _mesh_case()
    before = {k: LAUNCHES[k] for k in DERIV_KERNELS}
    new_k, l_k = blo_sweep_fast_sharded(part.to(cuda), tree, tree.lengths,
                                        make_mesh([cuda] * 4))
    for k in ("pllmod_edge_sumtables", "pllmod_edge_derivs"):
        n = LAUNCHES[k] - before[k]
        assert n > 0 and n % 4 == 0
    assert LAUNCHES["pllmod_newton_edges"] == before["pllmod_newton_edges"]
    new_p, l_p = blo_sweep_fast_sharded(part, tree, tree.lengths,
                                        make_mesh(["cpu"] * 4))
    assert abs(float(l_k) - float(l_p)) / abs(float(l_p)) < 2e-6
    rel = (new_k.cpu() - new_p).abs() / new_p.abs().clamp(min=1e-4)
    assert float(rel.max()) < 5e-4


def test_mesh_treeinfo_on_card_matches_plain(cuda):
    """A TreeInfo sharded four ways on one card: compute_loglh (full,
    incremental, per site) against the same sharded TreeInfo on the
    CPU (plain versions) and the float64 serial engine; the LINKED BLO
    launches kernels 2, 8 and 9 on every shard and kernel 10 never, and
    ends at or above its start within 1e-6 of float64."""
    from pllmod_tpu_torch.optimize import blo
    from pllmod_tpu_torch.parallel import make_mesh, shard_treeinfo
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    part, tree = _mesh_case()
    tis = {d: shard_treeinfo(TreeInfo(tree.copy(), [part.to(d)]),
                             make_mesh([d] * 4)) for d in (cuda, "cpu")}
    want = float(engine.tree_loglikelihood(
        part.to(dtype=torch.float64).with_model_params(), tree,
        schedule="scan"))
    for ti in tis.values():
        assert abs(ti.compute_loglh() - want) / abs(want) < 1e-6
        ti.compute_loglh(incremental=True)
        ti.set_branch_length(5, 0.3)
    inc = {d: ti.compute_loglh(incremental=True) for d, ti in tis.items()}
    assert abs(inc[cuda] - inc["cpu"]) / abs(inc["cpu"]) < 1e-6
    site = {d: ti.compute_loglh_persite()[1][0] for d, ti in tis.items()}
    assert np.allclose(site[cuda], site["cpu"], rtol=1e-5, atol=1e-4)
    ti = tis[cuda]
    start = ti.compute_loglh()
    before = {k: LAUNCHES[k] for k in DERIV_KERNELS}
    lnl = blo.optimize_branch_lengths_treeinfo(ti)
    for k in ("pllmod_edge_sumtables", "pllmod_edge_derivs"):
        n = LAUNCHES[k] - before[k]
        assert n > 0 and n % 4 == 0
    assert LAUNCHES["pllmod_newton_edges"] == before["pllmod_newton_edges"]
    assert LAUNCHES["pllmod_newton_edges_multi"] == before[
        "pllmod_newton_edges_multi"]
    assert lnl >= start
    p64 = part.to(dtype=torch.float64).with_model_params()
    l64 = float(engine.tree_loglikelihood(p64, ti.tree, schedule="scan"))
    assert abs(lnl - l64) / abs(l64) < 1e-6


def test_mesh_over_distinct_cards(cuda):
    """A mesh of one shard a card over two cards: compute_loglh and the
    treeinfo BLO equal the four-shard mesh on one card within 1e-6, and
    the dry run passes (skips on a machine with one card)."""
    from pllmod_tpu_torch import multichip
    from pllmod_tpu_torch.optimize import blo
    from pllmod_tpu_torch.parallel import make_mesh, shard_treeinfo
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    devs = _cards(2)
    part, tree = _mesh_case()
    out = {}
    for name, d in (("cards", devs), ("one", ["cuda:0"] * 2)):
        ti = shard_treeinfo(TreeInfo(tree.copy(), [part.to("cuda:0")]),
                            make_mesh(d))
        assert {str(s.device) for s in ti.partitions[0].shards} == set(d)
        out[name] = (ti.compute_loglh(),
                     blo.optimize_branch_lengths_treeinfo(ti))
    for a, b in zip(out["cards"], out["one"]):
        assert abs(a - b) / abs(b) < 1e-6
    multichip.dryrun_multichip(2, devs)


# ---------------------------------------------------------------------------
# the capacity mode: the chunked BLO's window tables and driver, and a
# bounded evaluation and sweep at 2,000 taxa × 16,384 sites
# ---------------------------------------------------------------------------
def test_chunked_window_table_matches_plain(cuda):
    """Kernel 2 over each window's stacked table (W bounded traversals,
    each in its own slot range) against its plain walk, bit for bit on
    every slot."""
    part, tree = _example(4, 4, cuda, n_taxa=32)
    ops_w, refs_w, _, _, ns = blo.compile_chunked_blo(part, tree, 8)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    for w in range(len(ops_w)):
        tabs = blo._window_tables(part, ops_w[w], refs_w[w], ns)
        P5 = fused.pair_pmats(part, _brl(tree, part), tabs.e1, tabs.e2,
                              root_row=False)
        args = (tabs.idx8, P5, part.tip_states, tabs.codetab, tabs.n_slots)
        outs = [(torch.zeros((tabs.n_slots, C * S, Ppad), device=cuda),
                 torch.zeros((tabs.n_slots, 1, Ppad), dtype=torch.int32,
                             device=cuda)) for _ in range(2)]
        k_clv, k_sc = fused.fused_walk(*args, out=outs[0])
        p_clv, p_sc = fused.fused_walk_plain(*args, out=outs[1])
        assert torch.equal(k_clv, p_clv) and torch.equal(k_sc, p_sc)


def test_chunked_blo_on_card_matches_float64(cuda):
    """The chunked BLO at 32 taxa on the card (kernels 2, 8 and 10; the
    final score on kernel 2) against the same driver in float64 on the
    card (the serial engine): logL within 1e-5, and within 1e-6 of the
    float64 serial engine at its own lengths."""
    part, tree = flagship.simulated(32, 2048, seed=3, sim_seed=11,
                                    device=cuda)
    part = part.cache_eigen()
    part64 = part.to(dtype=torch.float64).with_model_params().cache_eigen()
    before = (LAUNCHES["pllmod_fused_walk"],
              LAUNCHES["pllmod_edge_sumtables"],
              LAUNCHES["pllmod_newton_edges"])
    tr = tree.copy()
    _, lnl = blo.optimize_branch_lengths_chunked(part, tr, window=8)
    after = (LAUNCHES["pllmod_fused_walk"],
             LAUNCHES["pllmod_edge_sumtables"],
             LAUNCHES["pllmod_newton_edges"])
    assert all(a > b for a, b in zip(after, before))
    _, l64 = blo.optimize_branch_lengths_chunked(part64, tree.copy(),
                                                 window=8)
    assert abs(lnl - l64) / abs(l64) < 1e-5
    ops, ri = tr.traversal_ops()
    at = float(engine.loglikelihood(part64, ops, torch.as_tensor(
        tr.lengths, device=cuda), ri))
    assert abs(lnl - at) / abs(at) < 1e-6


def test_bounded_2000_taxa_on_card_matches_float64(cuda):
    """The capacity recipe at 2,000 taxa × 16,384 sites: the auto
    evaluation and the bounded fused evaluation within 1e-6 of the
    float64 bounded evaluation on the card; one bounded whole-tree sweep
    (kernels 2, 8, 10) at or above its start in float64, within 1e-6 of
    float64 at its lengths."""
    seqs, _, tree = flagship.capacity_cell(2000, 16384, seed=3)
    part = create_partition(
        seqs, states=4, alpha=flagship.CAPACITY_ALPHA,
        subst_rates=flagship.CAPACITY_RATES, freqs=flagship.CAPACITY_FREQS,
        device=cuda).cache_eigen()
    part64 = part.to(dtype=torch.float64).with_model_params().cache_eigen()
    l64, _ = engine.loglikelihood_bounded(part64, tree)
    l64 = float(l64)
    for got in (engine.tree_loglikelihood(part, tree),
                engine.loglikelihood_bounded_fused(part, tree)[0]):
        assert abs(float(got) - l64) / abs(l64) < 1e-6
    tr = tree.copy()
    before = {k: LAUNCHES[k] for k in DERIV_KERNELS}
    _, lnl = blo_bounded.optimize_branch_lengths_bounded(part, tr,
                                                         max_sweeps=1)
    assert LAUNCHES["pllmod_newton_edges"] > before["pllmod_newton_edges"]
    s64 = float(engine.loglikelihood_bounded(part64, tr)[0])
    assert s64 >= l64
    assert abs(lnl - s64) / abs(s64) < 1e-6
