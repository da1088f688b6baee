"""The port's example drivers (``pllmod_tpu_torch/examples``), each
``main(["--device", "cpu"])`` in process: they print what the JAX
package's demos print (the strings ``tests/test_examples_smoke.py``
asserts), and the consensus and RF demos give the JAX functions' numbers
on the same trees. The search demos are in
``test_torch_examples_search.py`` and ``test_torch_examples_spr.py``."""

import numpy as np
import pytest
import torch

from pllmod_tpu.tree import Tree as JaxTree
from pllmod_tpu.tree.consensus import consensus as jax_consensus
from pllmod_tpu.tree.splits import rf_distance_splits, tree_splits
from pllmod_tpu.tree.topology import set_tip_order
from pllmod_tpu.tree.utils import newick_with_support as jax_newick
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.examples import (consensus_demo,
                                       constrained_search_demo,
                                       genotype_demo, ml_search_demo,
                                       partitioned_demo,
                                       protein_mixture_demo,
                                       rf_distance_demo, spr_round)
from pllmod_tpu_torch.tree.utils import newick_with_support
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]


def test_consensus_demo_matches_jax(capsys):
    tree, supports = consensus_demo.main(CPU)
    out = capsys.readouterr().out
    assert "splits kept" in out
    trees = [JaxTree.from_newick(n) for n in consensus_demo.NEWICKS]
    jtree, jsupp = jax_consensus(trees, 0.5, weights=consensus_demo.WEIGHTS)
    assert newick_with_support(tree, supports, as_fraction=True) == \
        jax_newick(jtree, jsupp, as_fraction=True)
    assert len(supports) == len(jsupp) == 3


def test_rf_distance_demo_matches_jax(capsys):
    mat = rf_distance_demo.main(CPU)
    assert "max RF = 4" in capsys.readouterr().out
    trees = [JaxTree.from_newick(n) for n in rf_distance_demo.NEWICKS]
    splits = [tree_splits(t if t.labels == trees[0].labels
                          else set_tip_order(t, trees[0].labels))[0]
              for t in trees]
    want = np.array([[rf_distance_splits(a, b) for b in splits]
                     for a in splits])
    np.testing.assert_array_equal(mat, want)


def test_rf_distance_demo_reads_a_file(tmp_path, capsys):
    path = tmp_path / "trees.nwk"
    path.write_text("\n".join(rf_distance_demo.NEWICKS[:2]) + "\n")
    mat = rf_distance_demo.main([str(path)] + CPU)
    assert mat.tolist() == [[0, 2], [2, 0]]
    assert "2 trees, 5 taxa" in capsys.readouterr().out


@pytest.mark.parametrize("demo,strings", [
    (genotype_demo, ("model GT10: 10 states", "parsimony starting tree",
                     "optimized logL")),
    (protein_mixture_demo, ("37 models", "LG4X: start", "incremental:",
                            "bounded")),
    (partitioned_demo, ("parsimony starting tree: score", "optimized logL",
                        "TBE supports", "RF(ML, consensus) =")),
], ids=["genotype", "protein_mixture", "partitioned"])
def test_demo_prints_what_the_jax_demo_prints(demo, strings, capsys):
    demo.main(CPU)
    out = capsys.readouterr().out
    for s in strings:
        assert s in out


@pytest.mark.parametrize("demo", [genotype_demo, ml_search_demo,
                                  constrained_search_demo, partitioned_demo,
                                  protein_mixture_demo, spr_round],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_demos_default_to_the_card(demo, monkeypatch):
    """Without ``--device`` a demo runs on the CUDA card, and raises
    where there is none (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PllModError):
        demo.main([])
