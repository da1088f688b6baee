"""The port's starting trees (``tree/starting.py``) against the JAX
package's, on the CPU: random trees, Fitch scores (ambiguity codes and
gaps included), stepwise-addition parsimony trees on the port's native
path and on its Python fallback, the multi-partition forms, the
parsimony SPR round, tree extension, the parsimony resolution of a
multifurcating tree, and the ``parsimony`` command.

Trees and scores are equal exactly. The JAX package's native library
may fail to load when several test processes build it at once (its
unlocked in-place build), and its Python fallbacks then run; the two
paths build the same topologies (``tests/test_starting.py``), and so a
comparison holds the port to the JAX tree by RF distance 0 and equal
scores, and to the very edge arrays where both took the same path."""

import io
import contextlib

import numpy as np
import pytest

from pllmod_tpu import cli as jcli
from pllmod_tpu import native as jnative
from pllmod_tpu.ops import charmap as jcm
from pllmod_tpu.tree import starting as jst
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu_torch import cli, native
from pllmod_tpu_torch.msa.io import write_fasta
from pllmod_tpu_torch.msa.msa import MSA
from pllmod_tpu_torch.ops import charmap as cm
from pllmod_tpu_torch.tree import starting as st
from pllmod_tpu_torch.tree.splits import rf_distance
from tests import reference_impl as ref
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cases import to_torch_tree

AMBIGUOUS = "ACGTACGTACGTRYKMSWN-"   # the DNA codes, ambiguity and gap


def _seqs(seed, n, sites, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), sites)) for _ in range(n)]


def _same_tree(port, jax, same_path=True):
    """``port`` is the JAX tree: RF 0, the same labels, and the same
    edge arrays and lengths where both packages took the same path."""
    assert port.labels == list(jax.labels)
    assert rf_distance(port, to_torch_tree(jax)) == 0
    if same_path:
        np.testing.assert_array_equal(port.edge_nodes, jax.edge_nodes)
        np.testing.assert_array_equal(port.lengths, jax.lengths)


@pytest.fixture(params=["native", "python"])
def port_path(request, monkeypatch):
    """The port's native library as loaded, or monkeypatched away (its
    Python fallbacks). Yields whether the native path runs."""
    if request.param == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    return request.param == "native"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tree_matches_jax(seed):
    labels = [f"t{i}" for i in range(5 + 6 * seed)]
    _same_tree(st.random_tree(labels, seed=seed, default_brlen=0.2),
               jst.random_tree(labels, seed=seed, default_brlen=0.2))


@pytest.mark.parametrize("seed", [3, 4])
def test_parsimony_score_matches_jax(seed, port_path):
    rng = np.random.default_rng(seed)
    jtree = ref.random_binary_tree(rng, 14)
    seqs = _seqs(seed, 14, 90, AMBIGUOUS)
    w = rng.integers(1, 4, 90).astype(float)
    tree = to_torch_tree(jtree)
    for weights in (None, w):
        want = jst.parsimony_score(jtree, seqs, jcm.DNA, weights)
        assert st.parsimony_score(tree, seqs, cm.DNA, weights) == want
    # the directed Fitch sets of both engines agree with the JAX ones
    masks = st._tip_masks(seqs, cm.DNA)
    A, B = st._directed_fitch_edge_sets(tree, masks)
    jA, jB = jst._directed_fitch_edge_sets(jtree, masks)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_parsimony_stepwise_matches_jax(seed, port_path):
    n = 10 + 7 * (seed - 5)
    labels = [f"t{i}" for i in range(n)]
    seqs = _seqs(seed, n, 60, AMBIGUOUS)
    tree, score = st.parsimony_stepwise(labels, seqs, cm.DNA, seed=seed,
                                        default_brlen=0.3)
    jtree, jscore = jst.parsimony_stepwise(labels, seqs, jcm.DNA,
                                           seed=seed, default_brlen=0.3)
    assert score == jscore
    _same_tree(tree, jtree, port_path == jnative.available())
    tree.check_integrity()
    assert tree.is_binary()


def test_multi_partition_forms_match_jax(port_path):
    n = 12
    labels = [f"t{i}" for i in range(n)]
    parts = [(_seqs(8, n, 40), cm.DNA, None),
             (_seqs(9, n, 25, AMBIGUOUS), cm.DNA, np.arange(1.0, 26.0))]
    jparts = [(s, jcm.DNA, w) for s, _, w in parts]
    tree, score = st.parsimony_tree_multi(labels, parts, seed=3)
    jtree, jscore = jst.parsimony_tree_multi(labels, jparts, seed=3)
    assert score == jscore
    _same_tree(tree, jtree, port_path == jnative.available())
    assert st.parsimony_score_multi(tree, parts) == score
    # a multi-partition SPR round from a random tree: the same moves
    start = jst.random_tree(labels, seed=4)
    got = st.parsimony_spr_round_multi(to_torch_tree(start), parts)
    want = jst.parsimony_spr_round_multi(start.copy(), jparts)
    assert got[1:] == want[1:] and got[2] > 0
    _same_tree(got[0], want[0])


@pytest.mark.parametrize("seed", [10, 11])
def test_parsimony_spr_round_matches_jax(seed, port_path):
    rng = np.random.default_rng(seed)
    jtree = ref.random_binary_tree(rng, 16)
    seqs = _seqs(seed, 16, 70, AMBIGUOUS)
    tree, score, n = st.parsimony_spr_round(to_torch_tree(jtree), seqs,
                                            cm.DNA)
    jt, jscore, jn = jst.parsimony_spr_round(jtree.copy(), seqs, jcm.DNA)
    assert (score, n) == (jscore, jn) and n > 0
    _same_tree(tree, jt)


def test_extend_tree_matches_jax(port_path):
    n = 11
    labels = [f"t{i}" for i in range(n)]
    parts = [(_seqs(12, n, 50), cm.DNA, None),
             (_seqs(13, n, 30), cm.DNA, None)]
    jparts = [(s, jcm.DNA, w) for s, _, w in parts]
    j5 = jst.random_tree(labels[:5], seed=1)
    tree, score = st.extend_tree_parsimony(to_torch_tree(j5), labels[5:],
                                           parts, seed=2,
                                           default_brlen=0.25)
    jtree, jscore = jst.extend_tree_parsimony(j5, labels[5:], jparts,
                                              seed=2, default_brlen=0.25)
    assert score == jscore
    _same_tree(tree, jtree)
    _same_tree(st.extend_tree_random(to_torch_tree(j5), labels[5:], seed=3),
               jst.extend_tree_random(j5, labels[5:], seed=3))


def test_resolve_multi_parsimony_matches_jax(port_path):
    n = 10
    labels = [f"t{i}" for i in range(n)]
    seqs = _seqs(14, n, 80)
    jmulti = JaxTree.from_newick(
        "((t0:1,t1:1,t2:1,t3:1):1,t4:1,(t5:1,t6:1,t7:1,t8:1,t9:1):1);")
    tree, score = st.resolve_multi_parsimony(
        to_torch_tree(jmulti), [(seqs, cm.DNA, None)], seed=5,
        max_spr_rounds=4)
    jtree, jscore = jst.resolve_multi_parsimony(
        jmulti, [(seqs, jcm.DNA, None)], seed=5, max_spr_rounds=4)
    assert score == jscore
    assert tree.labels == labels and tree.is_binary()
    _same_tree(tree, jtree)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_parsimony_command_matches_jax(tmp_path, port_path):
    n = 9
    msa = MSA([f"s{i}" for i in range(n)], _seqs(15, n, 64, AMBIGUOUS))
    path = str(tmp_path / "a.fasta")
    write_fasta(msa, path)
    argv = ["parsimony", "--msa", path, "--seed", "3"]
    got = _stdout(cli.main, argv)
    want = _stdout(jcli.main, argv)
    assert got.splitlines()[0] == want.splitlines()[0]
    if port_path == jnative.available():
        assert got == want
    else:
        from pllmod_tpu_torch.tree.topology import Tree
        assert rf_distance(Tree.from_newick(got.splitlines()[1]),
                           Tree.from_newick(want.splitlines()[1])) == 0
