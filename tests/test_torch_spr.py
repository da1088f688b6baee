"""The port's SPR round (``algorithm/spr.py``) against the JAX package's,
in float64 on the CPU, on 9 taxa × 150 sites simulated along the tree
and started from that tree after 3 random SPR moves (so that the round
has moves to find). Both packages' trees come from the same edge arrays,
and their partitions carry the same numbers
(``torch_cases.make_case``).

- The scorers: ``_score_regrafts_batch`` and
  ``_score_regrafts_thorough_batch`` against the JAX functions on the
  same tables and subtree CLVs, per candidate: logL within rtol 1e-10,
  the triplet lengths within 1e-8.
- One fast and one thorough ``spr_round`` from the same TreeInfo state
  (one JAX round of each per module): equal ``n_applied``, RF 0, equal
  top-list entries, final logL within 1e-9 relative.
- The batched driver (``SPR_BATCH_MAX`` 8) against the serial one (1).
- The auto batch limit's budget on a card counts the caching
  allocator's unused blocks as free.
- The float32 path (kernel 2's plain walk on the CPU) against float64:
  the scores within 1e-5 relative.
- A constrained round ends on a tree that satisfies its constraint.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.algorithm import spr as jspr
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.algorithm import spr
from pllmod_tpu_torch.optimize.blo import DirectedTraversal
from pllmod_tpu_torch.tree import constraint, splits
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

N_TAXA, N_SITES = 9, 150


def _jax_tree(t):
    return JaxTree(t.n_tips, list(t.labels), t.edge_nodes.copy(),
                   t.lengths.copy(), t.n_nodes)


@pytest.fixture(scope="module")
def case():
    """The simulated case and its perturbed start tree (port Tree)."""
    c = make_case(11, N_TAXA, N_SITES, symbols="ACGT", dtype=jnp.float64)
    start = c.tree.copy()
    flagship.random_spr(start, 3, np.random.default_rng(2))
    return c, start


def _round_key(thorough):
    return dict(radius_min=1, radius_max=5 if thorough else 10,
                thorough=thorough)


@pytest.fixture(scope="module")
def jax_rounds(case):
    """One JAX round of each mode from the start tree: (logL, n_applied,
    top-list entries, final tree)."""
    c, start = case
    out = {}
    for thorough in (False, True):
        jti = JaxTreeInfo(_jax_tree(start), [c.jpart])
        lnl, n, top = jspr.spr_round(jti, **_round_key(thorough))
        out[thorough] = (lnl, n, [(e.prune_edge, e.junction, e.regraft_edge)
                                  for e in top], jti.tree)
    return out


def _port_round(case, thorough, **kw):
    c, start = case
    ti = TreeInfo(start.copy(), [c.tpart])
    lnl, n, top = spr.spr_round(ti, **_round_key(thorough), **kw)
    return lnl, n, [(e.prune_edge, e.junction, e.regraft_edge, e.lnl)
                    for e in top], ti


@pytest.fixture(scope="module")
def port_rounds(case):
    """One round of each mode through the batched driver (batches of
    1, 2, 4, 8): (logL, n_applied, top list (prune_edge, junction,
    regraft_edge, logL), TreeInfo, stats)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spr, "SPR_BATCH_MAX", 8)
        for thorough in (False, True):
            stats = {}
            out[thorough] = _port_round(case, thorough, stats=stats) + (
                stats,)
    return out


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["fast", "thorough"])
def test_spr_round_matches_jax(case, jax_rounds, port_rounds, thorough):
    lnl, n, top, ti, _ = port_rounds[thorough]
    jlnl, jn, jtop, jtree = jax_rounds[thorough]
    assert n == jn and n > 0
    assert [t[:3] for t in top] == jtop
    assert np.array_equal(ti.tree.edge_nodes, jtree.edge_nodes)
    assert splits.rf_distance(ti.tree, Tree(
        jtree.n_tips, jtree.labels, jtree.edge_nodes.copy(),
        jtree.lengths.copy(), jtree.n_nodes)) == 0
    assert abs(lnl - jlnl) <= 1e-9 * abs(jlnl)
    # the moves bring the tree nearer the simulating one
    truth, start = case[0].tree, case[1]
    assert (splits.rf_distance(ti.tree, truth)
            < splits.rf_distance(start, truth))


def _batch(case, K=6):
    """The first K candidates of the start tree, built as a round builds
    them, with their tables and subtree CLVs (float64)."""
    c, start = case
    builds = []
    for e, j in spr._prune_candidates(start):
        b = spr._build_candidate(start, e, j, 1, 10)
        if b is not None:
            builds.append(b[0])
        if len(builds) == K:
            break
    trav = DirectedTraversal(start)
    part = c.tpart
    clvs, scalers, gather = spr.full_tree_clvs(part, start.lengths, trav)
    refs = torch.as_tensor([spr._subtree_ref(start, trav, b)
                            for b in builds])
    cS, sS = gather(part, clvs, scalers, refs)
    stride = 3 * (start.n_tips - 2) + 2
    return builds, cS, sS, stride


def test_fast_scorer_matches_jax(case):
    c, start = case
    builds, cS, sS, stride = _batch(case)
    tb = spr._batch_tables(start, builds, stride)
    got = spr._score_regrafts_batch(
        c.tpart, tb["ops_cat"], torch.as_tensor(tb["brl_cat"]), cS, sS,
        torch.as_tensor(tb["t_s_b"]), torch.as_tensor(tb["eref_cat"]),
        torch.as_tensor(tb["mask_b"]), torch.as_tensor(tb["half_cat"]),
        stride).numpy()
    want = np.asarray(jspr._score_regrafts_batch(
        c.jpart, jnp.asarray(tb["ops_cat"]), jnp.asarray(tb["brl_cat"]),
        jnp.asarray(cS.permute(0, 3, 1, 2).numpy()), jnp.asarray(sS.numpy()),
        jnp.asarray(tb["t_s_b"]), jnp.asarray(tb["eref_cat"], jnp.int32),
        jnp.asarray(tb["mask_b"]), jnp.asarray(tb["half_cat"]),
        stride=stride))
    live = tb["mask_b"]
    assert live.sum() > 20
    assert np.array_equal(np.isfinite(got), live)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-10)


def test_thorough_scorer_matches_jax(case):
    c, start = case
    builds, cS, sS, stride = _batch(case, K=4)
    tb = spr._thorough_tables(start, builds, stride)
    got = spr._score_regrafts_thorough_batch(
        [c.tpart], (1.0,), tb["ops_cat"], torch.as_tensor(tb["brl_cat"]),
        [cS], [sS], torch.as_tensor(tb["t_s_b"]),
        torch.as_tensor(tb["eref_w"]), torch.as_tensor(tb["wmask"]),
        torch.as_tensor(tb["halves_w"]), 1e-4, 100.0, stride)
    want = jspr._score_regrafts_thorough_batch(
        (c.jpart,), (1.0,), jnp.asarray(tb["ops_cat"]),
        jnp.asarray(tb["brl_cat"]),
        (jnp.asarray(cS.permute(0, 3, 1, 2).numpy()),),
        (jnp.asarray(sS.numpy()),), jnp.asarray(tb["t_s_b"]),
        jnp.asarray(tb["eref_w"], jnp.int32), jnp.asarray(tb["wmask"]),
        jnp.asarray(tb["halves_w"]), jnp.asarray(1e-4, jnp.float64),
        jnp.asarray(100.0, jnp.float64), stride=stride)
    live = tb["wmask"]
    assert live.sum() > 10
    lnl, jlnl = got[0].numpy(), np.asarray(want[0])
    assert np.array_equal(np.isfinite(lnl), live)
    np.testing.assert_allclose(lnl[live], jlnl[live], rtol=1e-10)
    for x, jx in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy()[live], np.asarray(jx)[live],
                                   rtol=1e-8)


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["fast", "thorough"])
def test_batched_driver_matches_serial(case, port_rounds, monkeypatch,
                                       thorough):
    """``SPR_BATCH_MAX`` 8 (batches of 1, 2, 4, 8 candidates) against the
    serial driver (1): the same moves, top list and logL."""
    lnl, n, top, ti, stats = port_rounds[thorough]
    assert stats["max_batch"] > 1
    monkeypatch.setattr(spr, "SPR_BATCH_MAX", 1)
    stats1 = {}
    lnl1, n1, top1, ti1 = _port_round(case, thorough, stats=stats1)
    assert stats1["max_batch"] == 1
    assert stats1["batches"] > stats["batches"]
    assert (n, [t[:3] for t in top]) == (n1, [t[:3] for t in top1])
    assert np.array_equal(ti.tree.edge_nodes, ti1.tree.edge_nodes)
    assert abs(lnl - lnl1) <= 1e-12 * abs(lnl1)


def test_batch_budget_counts_reserved_blocks(monkeypatch):
    """On a card the budget is half of the driver's free bytes plus the
    blocks the caching allocator holds unused; on the CPU it is
    ``CPU_BATCH_BYTES``."""
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (10 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: 30 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: 20 * gib)
    assert spr._batch_budget(torch.device("cuda", 0)) == 10 * gib
    assert spr._batch_budget(torch.device("cpu")) == spr.CPU_BATCH_BYTES
    assert spr._batch_budget(None) == spr.CPU_BATCH_BYTES


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["fast", "thorough"])
def test_float32_scores_match_float64(case, thorough):
    """Kernel 2's path (its plain walk on the CPU) and the float32
    scorers against the serial engine in float64, on the first 8
    candidates: scores within 1e-5 relative, thorough lengths within
    1e-3."""
    c, start = case
    cands = spr._prune_candidates(start)[:8]
    out = {}
    for dt in (torch.float64, torch.float32):
        ti = TreeInfo(start.copy(), [c.tpart.to(dtype=dt).cache_eigen()])
        out[dt] = spr.score_candidates(ti, cands, 1, 5 if thorough else 10,
                                       thorough=thorough)
    assert len(out[torch.float64]) == len(out[torch.float32]) > 4
    for r64, r32 in zip(out[torch.float64], out[torch.float32]):
        assert r64[0] == r32[0]
        live = np.isfinite(r64[1])
        assert np.array_equal(live, np.isfinite(r32[1])) and live.any()
        np.testing.assert_allclose(r32[1][live], r64[1][live], rtol=1e-5)
        if thorough:
            for t32, t64 in zip(r32[2], r64[2]):
                np.testing.assert_allclose(t32[live], t64[live], rtol=1e-3,
                                           atol=1e-6)


def test_constrained_round_keeps_constraint(case):
    """A constraint that the start tree satisfies and the simulating tree
    breaks: the round never leaves it (each applied move and each
    top-list re-try is checked), and improves the logL all the same."""
    c, start = case
    truth = c.tree
    s_true = {splits.split_key(s) for s in splits.tree_splits(truth)[0]}
    s_start, ids = splits.tree_splits(start)
    # an inner edge of the start tree that the simulating tree lacks
    k = next(k for k, s in enumerate(s_start)
             if splits.split_key(s) not in s_true)
    side = [t for t in range(start.n_tips)
            if (int(s_start[k][t // 64]) >> (t % 64)) & 1]
    rest = [t for t in range(start.n_tips) if t not in side]
    cons_nw = "((%s),(%s));" % (",".join(start.labels[t] for t in side),
                                ",".join(start.labels[t] for t in rest))
    cons = constraint.Constraint(Tree.from_newick(cons_nw), start.labels)
    assert cons.check_tree(start) and not cons.check_tree(truth)
    ti = TreeInfo(start.copy(), [c.tpart])
    lnl0 = ti.compute_loglh()
    lnl, n, _ = spr.spr_round(ti, 1, 10, constraint=cons)
    assert cons.check_tree(ti.tree)
    assert lnl > lnl0
