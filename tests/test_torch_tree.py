"""The port's tree module (``pllmod_tpu_torch.tree``: ``moves``,
``splits``, ``constraint``, ``utils``, ``rtree``) against the JAX
package's, with results equal exactly. Both packages' trees are built
from the same edge arrays (never from Newick parsed in each package:
the two parsers number edges alike only when both take the native one
or both the Python one), and every move, split set, constraint verdict,
collapse, resolution, blob and rooted tree is compared array for
array, over seeds."""

import numpy as np
import pytest

from pllmod_tpu.common import TreeError as JaxTreeError
from pllmod_tpu.tree import constraint as jconstraint
from pllmod_tpu.tree import moves as jmoves
from pllmod_tpu.tree import rtree as jrtree
from pllmod_tpu.tree import splits as jsplits
from pllmod_tpu.tree import utils as jutils
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu_torch.common import TreeError
from pllmod_tpu_torch.tree import constraint, moves, rtree, splits, utils
from pllmod_tpu_torch.tree.topology import Tree
from tests import reference_impl as ref
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 2, 3]


def _pair(seed, n_tips=14):
    """(port tree, JAX tree) of one random binary tree, from the same
    edge arrays."""
    jt = ref.random_binary_tree(np.random.default_rng(seed), n_tips)
    return (Tree(jt.n_tips, jt.labels, jt.edge_nodes.copy(),
                 jt.lengths.copy(), jt.n_nodes), jt)


def _jax_copy(t):
    return JaxTree(t.n_tips, list(t.labels), t.edge_nodes.copy(),
                   t.lengths.copy(), t.n_nodes)


def _same(t, jt):
    assert np.array_equal(t.edge_nodes, jt.edge_nodes)
    assert np.array_equal(t.lengths, jt.lengths)
    assert t.n_nodes == jt.n_nodes and t.labels == jt.labels


def _both(fn_port, fn_jax):
    """Run a move in both packages: both succeed or both raise (the same
    error code)."""
    try:
        out = fn_port()
    except TreeError as err:
        with pytest.raises(JaxTreeError) as jerr:
            fn_jax()
        assert jerr.value.code == err.code
        return None, None
    return out, fn_jax()


@pytest.mark.parametrize("seed", SEEDS)
def test_moves_match_jax(seed):
    """100 random SPR, NNI and TBR draws (valid or not) on both packages'
    trees; every move's arrays equal, then every rollback's."""
    t, jt = _pair(seed)
    rng = np.random.default_rng(100 + seed)
    undo = []
    for _ in range(100):
        E = len(t.edge_nodes)
        kind = rng.integers(3)
        if kind == 0:
            e, r = (int(x) for x in rng.integers(E, size=2))
            ends = [int(x) for x in t.edge_nodes[e]]
            junction = ends[int(rng.integers(2))]
            rb, jrb = _both(lambda: moves.spr(t, e, r, junction=junction),
                            lambda: jmoves.spr(jt, e, r, junction=junction))
        elif kind == 1:
            e, mt = int(rng.integers(E)), int(rng.integers(1, 3))
            rb, jrb = _both(lambda: moves.nni(t, e, mt),
                            lambda: jmoves.nni(jt, e, mt))
        else:
            b, r1, r2 = (int(x) for x in rng.integers(E, size=3))
            rb, jrb = _both(lambda: moves.tbr(t, b, r1, r2),
                            lambda: jmoves.tbr(jt, b, r1, r2))
        _same(t, jt)
        if rb is not None:
            undo.append((rb, jrb))
            t.check_integrity()
    assert len(undo) >= 10
    for rb, jrb in reversed(undo):
        moves.rollback(t, rb)
        jmoves.rollback(jt, jrb)
        _same(t, jt)
    _same(t, _pair(seed)[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_splits_and_rf_match_jax(seed):
    t, jt = _pair(seed, n_tips=70)      # two words a split
    s, ids = splits.tree_splits(t)
    js, jids = jsplits.tree_splits(jt)
    assert np.array_equal(s, js) and np.array_equal(ids, jids)
    s_all, _ = splits.tree_splits(t, include_tips=True)
    assert np.array_equal(s_all, jsplits.tree_splits(jt,
                                                     include_tips=True)[0])
    rng = np.random.default_rng(seed)
    t2 = t.copy()
    for _ in range(4):
        e = int(rng.integers(len(t2.edge_nodes)))
        try:
            moves.nni(t2, e, moves.NNI_LEFT)
        except TreeError:
            pass
    d = splits.rf_distance(t, t2)
    assert d == jsplits.rf_distance(jt, _jax_copy(t2)) and d > 0
    assert splits.rf_distance(t, t.copy()) == 0
    s2, _ = splits.tree_splits(t2)
    assert (splits.rf_distance_splits(s, s2)
            == jsplits.rf_distance_splits(js, s2) == d)
    assert splits.max_rf_distance(70) == jsplits.max_rf_distance(70)
    for a, b in zip(s[:5], s2[:5]):
        assert (splits.hamming_distance(a, b, 70)
                == jsplits.hamming_distance(a, b, 70))
        assert splits.compatible(a, b, 70) == jsplits.compatible(a, b, 70)
        assert splits.show_split(a, 70) == jsplits.show_split(a, 70)
    ht, jht = splits.SplitHashtable(70), jsplits.SplitHashtable(70)
    for k, ss in enumerate((s, s2)):
        ht.update(ss, tree_index=k)
        jht.update(ss, tree_index=k)
    for x, y in zip(ht.as_arrays(), jht.as_arrays()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_constraint_checks_match_jax(seed):
    """``check_spr`` and ``check_tree`` on 80 random SPRs against a
    constraint on 6 of the 14 taxa, a move that breaks it undone: the
    same verdicts, both kinds seen."""
    t, jt = _pair(seed)
    rng = np.random.default_rng(seed + 7)
    sub = sorted(rng.choice(t.n_tips, 6, replace=False).tolist())
    cons_t = _restricted(t, sub)
    c = constraint.Constraint(cons_t, t.labels)
    jc = jconstraint.Constraint(_jax_copy(cons_t), jt.labels)
    n_seen = [0, 0]
    for _ in range(80):
        E = len(t.edge_nodes)
        e, r = (int(x) for x in rng.integers(E, size=2))
        u, v = (int(x) for x in t.edge_nodes[e])
        junction = v if t.is_tip(u) else u
        if t.is_tip(junction):
            continue
        try:
            ok = c.check_spr(t, e, junction, r)
        except (TreeError, KeyError, ValueError) as err:
            with pytest.raises(type(err)):
                jc.check_spr(jt, e, junction, r)
            continue
        assert ok == jc.check_spr(jt, e, junction, r)
        try:
            rb = moves.spr(t, e, r, junction=junction)
        except TreeError:
            continue
        jrb = jmoves.spr(jt, e, r, junction=junction)
        verdict = c.check_tree(t)
        assert verdict == jc.check_tree(jt)
        n_seen[verdict] += 1
        if not verdict:             # a constrained walk: undo violations
            moves.rollback(t, rb)
            jmoves.rollback(jt, jrb)
    assert min(n_seen) > 0


def _restricted(t, tips):
    """``t`` restricted to the tip ids ``tips`` (a binary tree over their
    labels, degree-2 nodes dissolved), as a new port Tree."""
    keep = set(tips)
    adj = t.adjacency()
    root = tips[0]
    edges, lens = [], []
    ids = {tip: k for k, tip in enumerate(tips)}
    nxt = [len(tips)]

    def walk(node, parent):
        """The id standing for ``node``'s side and its pendant length, or
        None when that side holds no kept tip."""
        if t.is_tip(node) and node != root:
            return (ids[node], 0.0) if node in keep else None
        kids = [walk(n, node) for n, _ in adj[node] if n != parent]
        kids = [k for k in kids if k is not None]
        if not kids:
            return None
        if len(kids) == 1:
            return kids[0]
        me = nxt[0]
        nxt[0] += 1
        for kid, ln in kids:
            edges.append((me, kid))
            lens.append(ln + 0.1)
        return me, 0.0

    (first, _e), = adj[root]
    top, _ = walk(first, root)
    edges.append((top, ids[root]))
    lens.append(0.1)
    return Tree(len(tips), [t.labels[i] for i in tips],
                np.asarray(edges, np.int32), np.asarray(lens), nxt[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_utils_match_jax(seed):
    """collapse → resolve → serialize → expand, and the rooting,
    distance and scaling helpers: equal arrays."""
    t, jt = _pair(seed, n_tips=16)
    rng = np.random.default_rng(seed)
    t.lengths[rng.choice(len(t.lengths), 6, replace=False)] = 1e-3
    jt.lengths[:] = t.lengths
    col = utils.collapse_short_branches(t, 0.01)
    jcol = jutils.collapse_short_branches(jt, 0.01)
    _same(col, jcol)
    res = utils.resolve_multifurcations(col, seed=seed, default_brlen=0.05)
    jres = jutils.resolve_multifurcations(jcol, seed=seed,
                                          default_brlen=0.05)
    _same(res, jres)
    blob = utils.serialize_tree(res)
    assert blob == jutils.serialize_tree(jres)
    _same(utils.expand_tree(blob), jutils.expand_tree(blob))
    s, ids = splits.tree_splits(t)
    tips = [i for i in range(t.n_tips)
            if (int(s[0][i // 64]) >> (i % 64)) & 1]
    out = [t.labels[i] for i in tips]
    assert utils.outgroup_edge(t, out) == jutils.outgroup_edge(jt, out)
    for node in (t.n_tips, t.n_tips + 3):
        assert (utils.nodes_at_node_dist(t, node, 1, 3)
                == jutils.nodes_at_node_dist(jt, node, 1, 3))
    assert (utils.nodes_at_edge_dist(t, int(ids[0]), 0, 2)
            == jutils.nodes_at_edge_dist(jt, int(ids[0]), 0, 2))
    utils.scale_subtree_branches(t, int(ids[0]), int(t.edge_nodes[ids[0],
                                                                  0]), 1.5)
    jutils.scale_subtree_branches(jt, int(ids[0]),
                                  int(jt.edge_nodes[ids[0], 0]), 1.5)
    utils.scale_branches(t, 0.5)
    jutils.scale_branches(jt, 0.5)
    _same(t, jt)
    sup = {int(e): 0.1 * k for k, e in enumerate(ids)}
    assert (utils.newick_with_support(t, sup)
            == jutils.newick_with_support(jt, sup))


@pytest.mark.parametrize("seed", SEEDS)
def test_rtree_matches_jax(seed):
    """Root on an edge, rooted SPRs (valid or not) and their rollbacks,
    the distance query, export and unrooting: equal arrays and text."""
    t, jt = _pair(seed, n_tips=12)
    e = int(np.random.default_rng(seed).integers(len(t.edge_nodes)))
    rt = rtree.RTree.from_unrooted(t, e, position=0.3)
    jrt = jrtree.RTree.from_unrooted(jt, e, position=0.3)

    def same():
        assert np.array_equal(rt.parent, jrt.parent)
        assert np.array_equal(rt.lengths, jrt.lengths)
        assert rt.root == jrt.root

    same()
    rng = np.random.default_rng(seed + 1)
    snaps = []
    for _ in range(30):
        a, b = (int(x) for x in rng.integers(rt.n_nodes, size=2))
        before, jbefore = rt.snapshot(), jrt.snapshot()
        snap, jsnap = _both(lambda: rt.spr(a, b), lambda: jrt.spr(a, b))
        same()
        if snap is None:        # a refused regraft may leave a half move
            rt.restore(before)
            jrt.restore(jbefore)
        else:
            snaps.append((snap, jsnap))
    assert snaps
    assert rt.nodes_at_node_dist(rt.root, 1, 4) == \
        jrt.nodes_at_node_dist(jrt.root, 1, 4)
    assert rt.to_newick() == jrt.to_newick()
    _same(rt.to_unrooted(), jrt.to_unrooted())
    for snap, jsnap in reversed(snaps):
        rt.rollback(snap)
        jrt.rollback(jsnap)
        same()
    nw = rt.to_newick()
    back, jback = rtree.RTree.from_newick(nw), jrtree.RTree.from_newick(nw)
    assert np.array_equal(back.parent, jback.parent)
    assert back.labels == jback.labels


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_matches_test_helper(seed):
    """``flagship.simulate`` (the port's own Q and Γ categories) draws the
    same sequences as ``tests/torch_cases.simulate`` (the reference
    implementation's) from the same generator."""
    from pllmod_tpu_torch import flagship
    from tests.torch_cases import simulate
    t, jt = _pair(seed, n_tips=16)
    rates = np.random.default_rng(seed).uniform(0.5, 2.0, 6)
    freqs = np.array([0.15, 0.25, 0.2, 0.4])
    got = flagship.simulate(np.random.default_rng(seed), t, 400, rates,
                            freqs, "ACGT", alpha=0.6)
    want = simulate(np.random.default_rng(seed), jt, 400, rates, freqs,
                    "ACGT", alpha=0.6)
    assert got == want
    assert len(set(got)) == t.n_tips
