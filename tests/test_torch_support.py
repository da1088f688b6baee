"""The port's bootstrap support, consensus and display utilities
(``tree/tbe.py``, ``tree/consensus.py``, ``tree/show.py``) and the
``support`` and ``consensus`` commands, against the JAX package's on the
CPU: equal supports (TBE on the native counting traversal and on the
popcount matrix, FBP), equal consensus trees and supports (majority,
strict, MRE, weighted), equal drawings, and equal command output.

The bootstrap trees are the reference tree after a few random SPR moves
each, written as Newick, so that their tip orders differ from the
reference's. The commands parse their tree files with the native Newick
parser or the Python one, which number edges differently; each command
test runs the port on the path the JAX package took (its native library
may fail to load when test processes build it at once)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from pllmod_tpu import cli as jcli
from pllmod_tpu import native as jnative
from pllmod_tpu.tree import consensus as jcons
from pllmod_tpu.tree import show as jshow
from pllmod_tpu.tree import tbe as jtbe
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu_torch import cli, flagship, native
from pllmod_tpu_torch.tree import consensus, show, tbe
from pllmod_tpu_torch.tree.topology import Tree
from tests import reference_impl as ref
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cases import to_torch_tree

N_TIPS, N_BOOT = 18, 12


@pytest.fixture(scope="module")
def trees():
    """(JAX reference tree, the port's copy, bootstrap Newick strings)."""
    rng = np.random.default_rng(51)
    jref = ref.random_binary_tree(rng, N_TIPS, 0.05, 0.5)
    boots = []
    for k in range(N_BOOT):
        t = to_torch_tree(jref)
        flagship.random_spr(t, 1 + k % 4, rng)
        boots.append(t.to_newick())
    return jref, to_torch_tree(jref), boots


@pytest.fixture(params=["native", "python"])
def port_path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    return request.param


@pytest.fixture
def jax_path(monkeypatch):
    """The port on the path the JAX package takes."""
    if not jnative.available():
        monkeypatch.setattr(native, "available", lambda: False)


def test_support_matches_jax(trees, port_path):
    jref, tref, boots = trees
    jboots = [JaxTree.from_newick(s) for s in boots]
    tboots = [Tree.from_newick(s) for s in boots]
    for port_fn, jax_fn in ((tbe.tbe_support, jtbe.tbe_support),
                            (tbe.fbp_support, jtbe.fbp_support)):
        got = port_fn(tref, tboots)
        want = jax_fn(jref, jboots)
        assert got == want and len(got) == N_TIPS - 3
    assert 0 < min(got.values()) < 1
    # the transfer index on both engines (counting traversal, popcount)
    splits, _ = tbe.sp.tree_splits(tref)
    best, p = tbe.transfer_index(splits, tboots[3], N_TIPS)
    jbest, jp = jtbe.transfer_index(splits, jboots[3], N_TIPS)
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("threshold", [1.0, 0.5, 0.3])
def test_consensus_matches_jax(trees, threshold, jax_path):
    _, _, boots = trees
    weights = np.arange(1.0, N_BOOT + 1) / np.arange(1.0, N_BOOT + 1).sum()
    for kw in ({}, {"weights": weights}):
        tree, sup = consensus.consensus(
            [Tree.from_newick(s) for s in boots], threshold, **kw)
        jtree, jsup = jcons.consensus(
            [JaxTree.from_newick(s) for s in boots], threshold, **kw)
        assert sup == jsup
        assert tree.labels == list(jtree.labels)
        np.testing.assert_array_equal(tree.edge_nodes, jtree.edge_nodes)
    got = consensus.consensus_from_newicks(boots, threshold)
    want = jcons.consensus_from_newicks(boots, threshold)
    assert got[1] == want[1]


def test_show_matches_jax(trees):
    jref, tref, _ = trees
    for node in (None, N_TIPS + 3):
        for lengths in (True, False):
            assert show.show_ascii(tref, node, lengths) == \
                jshow.show_ascii(jref, node, lengths)
    rng = np.random.default_rng(52)
    P = rng.random((3, 2, 4, 4))
    clvs, sc = rng.random((5, 6, 2, 4)), rng.integers(0, 3, (5, 6))
    assert show.show_pmatrix(torch.as_tensor(P), 1) == \
        jshow.show_pmatrix(P, 1)
    assert show.show_clv(torch.as_tensor(clvs), torch.as_tensor(sc), 2,
                         sites=4) == jshow.show_clv(clvs, sc, 2, sites=4)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_support_and_consensus_commands_match_jax(trees, tmp_path,
                                                  jax_path):
    _, tref, boots = trees
    best, bfile = tmp_path / "best.nwk", tmp_path / "boots.nwk"
    best.write_text(tref.to_newick() + "\n")
    bfile.write_text("\n".join(boots) + "\n")
    for argv in (["support", "--tree", str(best), str(bfile)],
                 ["support", "--tree", str(best), str(bfile), "--metric",
                  "tbe", "--fraction"],
                 ["consensus", str(bfile)],
                 ["consensus", str(bfile), "--threshold", "0.3"]):
        got = _stdout(cli.main, argv)
        assert got == _stdout(jcli.main, argv) and got
