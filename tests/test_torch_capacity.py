"""The capacity mode's pieces on the CPU: the memory-bounded evaluations
at 10,000 taxa (the JAX package's ``test_bounded_10k_taxa`` at 64
patterns standing in for 100,000), the capacity cell's recipe
(``flagship.random_binary_tree`` draw for draw the JAX package's test
tree, ``flagship.simulate``'s memory-light loop equal to the loop it
replaced) and ``create_partition``'s blocked invariant-site mask and
step timings at more tips than a block."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import GAMMA_RATES_MEAN
from pllmod_tpu_torch.ops import eigen as eigen_mod
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.ops import gamma as gamma_mod
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree
from tests import reference_impl as ref
from tests.torch_cases import rel_err, to_torch, to_torch_tree
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def test_bounded_10k_taxa():
    """A 10,000-taxon tree evaluates with at most ⌈log2 n⌉ + 3 = 17
    slots on the serial engine and on kernel 2's serial table (its plain
    version here), within 2e-6 of the level schedule and of the JAX
    package's bounded evaluation."""
    n = 10_000
    rng = np.random.default_rng(42)
    jtree = ref.random_binary_tree(rng, n)
    seqs = ref.random_sequences(rng, n, 64)
    jpart = jax_create(seqs, states=4, n_rate_cats=4, alpha=0.9,
                       prop_invar=0.1, dtype=jnp.float32)
    part, tree = to_torch(jpart), to_torch_tree(jtree)
    want_jax, _ = jax_engine.loglikelihood_bounded(jpart, jtree)
    levels = float(engine.tree_loglikelihood(part, tree, schedule="levels"))
    l_b, n_slots = engine.loglikelihood_bounded(part, tree)
    l_f, n_slots_f = engine.loglikelihood_bounded_fused(part.cache_eigen(),
                                                        tree)
    bound = int(np.ceil(np.log2(n))) + 3
    assert n_slots <= bound and n_slots_f <= bound + 1   # + scratch slot
    for got in (l_b, l_f):
        assert np.isfinite(float(got))
        assert rel_err(got, levels) < 2e-6
        assert rel_err(got, want_jax) < 2e-6


def _simulate_loop(rng, tree, n_sites, rates, freqs, symbols, alpha=0.7,
                   cats=4):
    """``flagship.simulate`` as it was: an int64 state array kept for
    every node, one matrix exponential an edge."""
    freqs = np.asarray(freqs, np.float64)
    Q = eigen_mod.build_q(torch.as_tensor(rates, dtype=torch.float64),
                          torch.as_tensor(freqs))
    cat_rates = torch.as_tensor(gamma_mod.compute_gamma_cats_host(
        alpha, cats, GAMMA_RATES_MEAN))
    site_cat = rng.integers(0, cats, n_sites)
    adj = tree.adjacency()
    seqs = {tree.n_tips: rng.choice(len(freqs), n_sites, p=freqs)}
    stack = [(tree.n_tips, -1)]
    while stack:
        node, parent = stack.pop()
        for nbr, e in adj[node]:
            if nbr == parent:
                continue
            t = float(tree.lengths[e]) * cat_rates
            cum = torch.linalg.matrix_exp(Q * t[:, None, None]) \
                .cumsum(-1).numpy()
            rows = cum[site_cat, seqs[node]]
            seqs[nbr] = np.minimum((rng.random((n_sites, 1)) > rows)
                                   .sum(1), len(freqs) - 1)
            stack.append((nbr, node))
    chars = np.array(list(symbols))
    return ["".join(chars[seqs[t]]) for t in range(tree.n_tips)]


@pytest.mark.parametrize("seed,states", [(11, 4), (12, 20), (13, 64)])
def test_simulate_matches_the_loop_it_replaced(seed, states):
    _, newick, rates, freqs = flagship.example_data(30, 8, seed, states)
    tree = Tree.from_newick(newick)
    sym = flagship._symbols(states)
    want = _simulate_loop(np.random.default_rng(seed), tree, 700, rates,
                          freqs, sym, alpha=0.6)
    got = flagship.simulate(np.random.default_rng(seed), tree, 700, rates,
                            freqs, sym, alpha=0.6)
    assert got == want


def test_flagship_simulated_data_unchanged():
    """The simulated cells of the card's phases (the flagship recipe at
    a test size): the same sequences as the loop it replaced."""
    seqs, newick, rates, freqs = flagship.simulated_data(20, 300, 3, 11)
    tree = Tree.from_newick(newick)
    want = _simulate_loop(np.random.default_rng(11), tree, 300, rates,
                          freqs, "ACGT", alpha=0.75)
    by_tip = [seqs[int(label[1:])] for label in tree.labels[:20]]
    assert by_tip == want


def test_capacity_cell_recipe():
    """The capacity cell at a test size: the JAX package's test tree for
    the seed (U(0.02, 0.4) lengths), and DNA simulated along it after
    the tree's draws."""
    seqs, labels, tree = flagship.capacity_cell(50, 400, seed=3)
    want = ref.random_binary_tree(np.random.default_rng(3), 50, 0.02, 0.4)
    np.testing.assert_array_equal(tree.edge_nodes, want.edge_nodes)
    np.testing.assert_array_equal(tree.lengths, want.lengths)
    assert labels == [f"t{i}" for i in range(50)]
    assert len(seqs) == 50 and {len(s) for s in seqs} == {400}
    rng = np.random.default_rng(3)
    flagship.random_binary_tree(rng, 50, 0.02, 0.4)
    assert seqs == flagship.simulate(
        rng, tree, 400, flagship.CAPACITY_RATES, flagship.CAPACITY_FREQS,
        "ACGT", alpha=flagship.CAPACITY_ALPHA)


def test_create_partition_blocks_and_timings():
    """More tips than the invariant mask's block of 256, gaps and
    ambiguity codes: the port's arrays equal the JAX package's, and the
    timings name every step."""
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT-NRY"), 90, p=[.3, .3, .1, .1,
                                                        .05, .05, .05, .05]))
            for _ in range(600)]
    seqs[:300] = [s[:10] + "A" * 20 + s[30:] for s in seqs[:300]]
    seqs[300:] = [s[:10] + "A" * 10 + "-" * 10 + s[30:] for s in seqs[300:]]
    jpart = jax_create(seqs, states=4, n_rate_cats=4, alpha=0.5,
                       prop_invar=0.2, dtype=jnp.float64)
    timings = {}
    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=0.5,
                            prop_invar=0.2, dtype=torch.float64,
                            device="cpu", timings=timings)
    for f in ("tip_states", "inv_indicator", "pattern_weights", "code_clv"):
        np.testing.assert_array_equal(getattr(part, f).numpy(),
                                      np.asarray(getattr(jpart, f)))
    assert part.inv_indicator[:, 0].sum() > 0
    assert sorted(timings) == ["compress_s", "encode_s", "tables_s",
                               "upload_s"]
    assert all(v >= 0 for v in timings.values())
