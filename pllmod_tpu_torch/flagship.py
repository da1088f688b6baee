"""The flagship example: a random alignment and tree under GTR+Γ4.

A port of the JAX package's ``__graft_entry__._example`` /
``_random_newick``: for ``states=4`` the same seed gives the same
sequences, Newick string and model as there. ``states=20`` draws a
protein alignment (+Γ4, C·S = 80) from the same recipe, and any other
state count (2..64) a multistate one (symbols of
:func:`~pllmod_tpu_torch.ops.charmap.multistate`).

:func:`simulate` evolves an alignment along a tree under the model
(:func:`simulated` lays one on :func:`example`'s own tree): tree-signal
data, whose likelihood has interior optima and one best topology, where
i.i.d. random characters leave the optima on their bounds and every
topology about as bad as every other. :func:`random_spr` perturbs a tree
by seeded random SPR moves, so that an SPR round has moves to find.
:func:`search_cell` is the data of the full-search cell (246 × 4465
GTR+Γ4, the JAX package's ``tools/probe_search246.py`` recipe): a random
tree, a model and an alignment simulated along that tree.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import GAMMA_RATES_MEAN, TreeError
from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops import eigen as eigen_mod
from pllmod_tpu_torch.ops import gamma as gamma_mod
from pllmod_tpu_torch.ops.charmap import AA_ORDER
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree import moves
from pllmod_tpu_torch.tree.topology import Tree

_ALPHABETS = {4: b"ACGT", 20: AA_ORDER.encode()}


def example_data(n_taxa=12, n_sites=256, seed=7, states=4):
    """(sequences, newick, subst_rates, freqs) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    alphabet = _ALPHABETS.get(states, charmap.MULTI_SYMBOLS[:states].encode())
    chars = np.frombuffer(alphabet, np.uint8)
    mat = chars[rng.integers(0, states, size=(n_taxa, n_sites))]
    seqs = [bytes(row).decode() for row in mat]
    newick = random_newick(n_taxa, rng)
    rates = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.dirichlet([10] * states)
    return seqs, newick, rates, freqs


def example(n_taxa=12, n_sites=256, seed=7, dtype=torch.float32,
            device="cuda", states=4, n_rate_cats=4, prop_invar=0.0):
    """(partition, tree) of the flagship model on ``device``: uncompressed
    patterns, ``n_rate_cats`` Γ categories (alpha 0.75), random
    exchangeabilities and frequencies."""
    seqs, newick, rates, freqs = example_data(n_taxa, n_sites, seed, states)
    tree = Tree.from_newick(newick)
    cmap = None if states in _ALPHABETS else charmap.multistate(states)
    partition = create_partition(
        seqs, states=states, charmap=cmap, n_rate_cats=n_rate_cats,
        alpha=0.75, subst_rates=rates, freqs=freqs, prop_invar=prop_invar,
        compress=False, dtype=dtype, device=device)
    return partition, tree


def partition_on_tree(tree, n_sites=4096, seed=5, states=20,
                      dtype=torch.float32, device="cuda", n_rate_cats=4):
    """A partition of :func:`example_data`'s alignment (``tree.n_tips``
    taxa, ``n_sites`` sites, ``seed``, ``states``) laid on ``tree``: tip
    ``i`` holds the sequence of taxon ``tree.labels[i]`` (``t<k>`` takes
    row ``k``), with the model of :func:`example`. A second partition of
    a partitioned analysis over the flagship tree."""
    seqs, _, rates, freqs = example_data(tree.n_tips, n_sites, seed, states)
    ordered = [seqs[int(label[1:])] for label in tree.labels]
    cmap = None if states in _ALPHABETS else charmap.multistate(states)
    return create_partition(
        ordered, states=states, charmap=cmap, n_rate_cats=n_rate_cats,
        alpha=0.75, subst_rates=rates, freqs=freqs, compress=False,
        dtype=dtype, device=device)


def random_newick(n_taxa, rng):
    """Random bifurcating topology by sequential random joins."""
    leaves = [f"t{i}" for i in range(n_taxa)]
    nodes = [f"{lb}:{rng.uniform(0.02, 0.4):.4f}" for lb in leaves]
    while len(nodes) > 3:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        merged = f"({nodes[i]},{nodes[j]}):{rng.uniform(0.02, 0.4):.4f}"
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [merged]
    return f"({nodes[0]},{nodes[1]},{nodes[2]});"


def _symbols(states):
    alphabet = _ALPHABETS.get(states)
    return (alphabet.decode() if alphabet is not None
            else charmap.MULTI_SYMBOLS[:states])


def simulate(rng, tree, n_sites, rates, freqs, symbols, alpha=0.7, cats=4):
    """Sequences (one a tip, in tip order) evolved along ``tree`` under
    the reversible model (``rates``, ``freqs``) + Γ(``alpha``, ``cats``
    mean-rate categories), state i written as ``symbols[i]``; every draw
    comes from the numpy generator ``rng``.

    Each site takes one category and a root state at the first inner
    node (π); down every edge a child's state is drawn from the row of
    P(t·r_c) = exp(Q·t·r_c) of its parent's state. Q is
    :func:`~pllmod_tpu_torch.ops.eigen.build_q` (mean rate 1) and the
    category rates :func:`~pllmod_tpu_torch.ops.gamma.compute_gamma_cats_host`,
    both in float64."""
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
                .cumsum(-1).numpy()                             # [C, S, S]
            rows = cum[site_cat, seqs[node]]                    # [sites, S]
            seqs[nbr] = np.minimum((rng.random((n_sites, 1)) > rows)
                                   .sum(1), len(freqs) - 1)
            stack.append((nbr, node))
    chars = np.array(list(symbols))
    return ["".join(chars[seqs[t]]) for t in range(tree.n_tips)]


def simulated_data(n_taxa=12, n_sites=256, seed=7, sim_seed=11, states=4,
                   n_rate_cats=4, alpha=0.75):
    """(sequences, newick, subst_rates, freqs): the Newick string and
    model of :func:`example_data` at the same (``n_taxa``, ``n_sites``,
    ``seed``), with sequences simulated (:func:`simulate`) along that
    tree at Γ shape ``alpha`` from ``sim_seed`` in place of the random
    ones; row k belongs to taxon ``t<k>``."""
    _, newick, rates, freqs = example_data(n_taxa, n_sites, seed, states)
    tree = Tree.from_newick(newick)
    seqs = simulate(np.random.default_rng(sim_seed), tree, n_sites, rates,
                    freqs, _symbols(states), alpha=alpha, cats=n_rate_cats)
    by_taxon = [None] * n_taxa
    for tip, label in enumerate(tree.labels):
        by_taxon[int(label[1:])] = seqs[tip]
    return by_taxon, newick, rates, freqs


def simulated(n_taxa=12, n_sites=256, seed=7, sim_seed=11,
              dtype=torch.float32, device="cuda", states=4, n_rate_cats=4,
              alpha=0.75):
    """(partition, tree) of :func:`simulated_data`: :func:`example`'s
    tree, exchangeabilities and frequencies with an alignment simulated
    along that tree (uncompressed patterns, as :func:`example`). The
    partition holds the simulating model."""
    seqs, newick, rates, freqs = simulated_data(
        n_taxa, n_sites, seed, sim_seed, states, n_rate_cats, alpha)
    tree = Tree.from_newick(newick)
    ordered = [seqs[int(label[1:])] for label in tree.labels]
    cmap = None if states in _ALPHABETS else charmap.multistate(states)
    partition = create_partition(
        ordered, states=states, charmap=cmap, n_rate_cats=n_rate_cats,
        alpha=alpha, subst_rates=rates, freqs=freqs, compress=False,
        dtype=dtype, device=device)
    return partition, tree


def random_spr(tree, n_moves, rng):
    """Apply ``n_moves`` random valid SPR moves to ``tree`` in place
    (prune edge, junction and regraft edge drawn from ``rng``; a draw
    that :func:`~pllmod_tpu_torch.tree.moves.spr` refuses is redrawn).
    Returns the (prune_edge, junction, regraft_edge) of each move."""
    done = []
    while len(done) < n_moves:
        live = np.nonzero(tree.edge_nodes[:, 0] >= 0)[0]
        e, r = (int(x) for x in rng.choice(live, 2, replace=False))
        ends = [int(x) for x in tree.edge_nodes[e] if not tree.is_tip(int(x))]
        if not ends:
            continue
        junction = ends[int(rng.integers(len(ends)))]
        try:
            moves.spr(tree, e, r, junction=junction)
        except TreeError:
            continue
        tree.invalidate()
        done.append((e, junction, r))
    return done


def search_cell(seed=246, n_taxa=246, n_sites=4465):
    """(sequences, labels, tree) of the search cell: a random binary
    topology on ``t0..t{n_taxa-1}``
    (:func:`~pllmod_tpu_torch.tree.starting.random_tree`) with lengths
    U(0.02, 0.6), and an alignment of ``n_sites`` simulated along it
    (:func:`simulate`) under GTR rates U(0.5, 2.5), frequencies
    Dirichlet(12, 9, 9, 12) and Γ4 shape 0.9, every draw from
    ``np.random.default_rng(seed)``. Sequence i belongs to ``labels[i]``,
    tip i of the simulating ``tree``."""
    from pllmod_tpu_torch.tree.starting import random_tree
    rng = np.random.default_rng(seed)
    labels = [f"t{i}" for i in range(n_taxa)]
    tree = random_tree(labels, seed=int(rng.integers(2**31)))
    tree.lengths = rng.uniform(0.02, 0.6, len(tree.lengths))
    rates = rng.uniform(0.5, 2.5, 6)
    freqs = rng.dirichlet([12, 9, 9, 12])
    seqs = simulate(rng, tree, n_sites, rates, freqs, "ACGT", alpha=0.9)
    return seqs, labels, tree
