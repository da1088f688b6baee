"""The flagship example: a random alignment and tree under GTR+Γ4.

A port of the JAX package's ``__graft_entry__._example`` /
``_random_newick``: for ``states=4`` the same seed gives the same
sequences, Newick string and model as there. ``states=20`` draws a
protein alignment (+Γ4, C·S = 80) from the same recipe, and any other
state count (2..64) a multistate one (symbols of
:func:`~pllmod_tpu_torch.ops.charmap.multistate`).
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops.charmap import AA_ORDER
from pllmod_tpu_torch.ops.partition import create_partition
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
