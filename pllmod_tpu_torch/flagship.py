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
:func:`capacity_cell` is the capacity mode's cell (10,000 taxa ×
100,000 sites GTR+Γ4, after ``tools/probe_capacity_eval.py``): DNA
simulated along a :func:`random_binary_tree`.
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
    P(t·r_c) = exp(Q·t·r_c) of its parent's state: the count of that
    row's cumulative probabilities a uniform draw exceeds, S − 1 at
    most. Q is :func:`~pllmod_tpu_torch.ops.eigen.build_q` (mean rate 1)
    and the category rates
    :func:`~pllmod_tpu_torch.ops.gamma.compute_gamma_cats_host`, both in
    float64.

    States are held as uint8, and an inner node's states are dropped
    once its children are drawn, so that the live host memory is the
    tips' states and a path's worth of inner nodes (10,000 taxa ×
    100,000 sites: 1 GB of tip states, where an int64 array a node would
    hold 16 GB)."""
    freqs = np.asarray(freqs, np.float64)
    S = len(freqs)
    Q = eigen_mod.build_q(torch.as_tensor(rates, dtype=torch.float64),
                          torch.as_tensor(freqs))
    cat_rates = torch.as_tensor(gamma_mod.compute_gamma_cats_host(
        alpha, cats, GAMMA_RATES_MEAN))
    # every edge's cumulative P rows at once, [(edge, c, i), j]: the
    # batched matrix_exp gives each matrix the bits of its own call
    t = torch.as_tensor(np.asarray(tree.lengths, np.float64))[:, None] \
        * cat_rates[None, :]
    cum_all = torch.linalg.matrix_exp(Q * t[..., None, None]) \
        .cumsum(-1).numpy().reshape(len(t), cats * S, S)
    site_cat = rng.integers(0, cats, n_sites)
    row_base = site_cat * S                  # row of (category, state 0)
    adj = tree.adjacency()
    inner = {tree.n_tips: rng.choice(S, n_sites, p=freqs).astype(np.uint8)}
    tips = [None] * tree.n_tips
    stack = [(tree.n_tips, -1)]
    while stack:
        node, parent = stack.pop()
        if node < tree.n_tips:
            continue
        here = row_base + inner.pop(node)
        for nbr, e in adj[node]:
            if nbr == parent:
                continue
            rows = np.take(cum_all[e].T, here, axis=1)     # [S, sites]
            u = rng.random(n_sites)
            drawn = np.zeros(n_sites, np.uint8)
            for j in range(S):
                drawn += u > rows[j]
            np.minimum(drawn, S - 1, out=drawn)
            (tips if nbr < tree.n_tips else inner)[nbr] = drawn
            stack.append((nbr, node))
    chars = np.frombuffer(symbols.encode("ascii"), np.uint8)
    return [chars[x].tobytes().decode("ascii") for x in tips]


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


def random_binary_tree(rng, n_tips, min_len=0.01, max_len=0.9):
    """A random unrooted binary tree on ``t0..t{n_tips-1}`` (the JAX
    package's test recipe, ``tests/reference_impl.random_binary_tree``,
    draw for draw): a 3-star on tips 0-2, then tip k splits an edge
    drawn uniformly from those so far; lengths U(``min_len``,
    ``max_len``) in edge order."""
    labels = [f"t{i}" for i in range(n_tips)]
    edges = [[0, n_tips], [1, n_tips], [2, n_tips]]
    next_inner = n_tips + 1
    for tip in range(3, n_tips):
        e = rng.integers(len(edges))
        u, v = edges[e]
        w = next_inner
        next_inner += 1
        edges[e] = [u, w]
        edges.append([w, v])
        edges.append([tip, w])
    lengths = rng.uniform(min_len, max_len, size=len(edges))
    return Tree(n_tips, labels, np.array(edges, np.int32), lengths,
                n_nodes=next_inner)


# the capacity cell's model: tests/reference_impl.simulated_sequences'
# GTR rates and frequencies, Γ4 shape 0.9 (tools/probe_capacity_eval.py)
CAPACITY_RATES = (1.2, 2.5, 0.8, 1.1, 3.0, 1.0)
CAPACITY_FREQS = (0.3, 0.25, 0.2, 0.25)
CAPACITY_ALPHA = 0.9


def capacity_cell(n_taxa=10_000, n_sites=100_000, seed=3):
    """(sequences, labels, tree) of the capacity cell: a
    :func:`random_binary_tree` on ``t0..t{n_taxa-1}`` with lengths
    U(0.02, 0.4) and ``n_sites`` of DNA simulated along it
    (:func:`simulate`) under GTR+Γ4 (:data:`CAPACITY_RATES`,
    :data:`CAPACITY_FREQS`, :data:`CAPACITY_ALPHA`), every draw from
    ``np.random.default_rng(seed)``, the tree's first. Sequence i
    belongs to ``labels[i]``, tip i of ``tree``. The full size holds 1
    GB of tip states on the host while it simulates (:func:`simulate`)."""
    rng = np.random.default_rng(seed)
    tree = random_binary_tree(rng, n_taxa, min_len=0.02, max_len=0.4)
    seqs = simulate(rng, tree, n_sites, CAPACITY_RATES, CAPACITY_FREQS,
                    "ACGT", alpha=CAPACITY_ALPHA)
    return seqs, list(tree.labels[:n_taxa]), tree
