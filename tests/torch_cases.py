"""Shared inputs of the ``test_torch_*`` files: one model and alignment,
made with numpy from a seed, built by the JAX package and carried into
the PyTorch port through ``pllmod_tpu_torch.convert``, so both packages
evaluate the same numbers."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu_torch.convert import (ARRAY_FIELDS, EIGEN_FIELDS,
                                      META_FIELDS, partition_from_arrays)
from pllmod_tpu_torch.tree.topology import Tree as TorchTree
from tests import reference_impl as ref


def to_torch(jpart, device="cpu"):
    """The port's Partition holding a JAX partition's arrays."""
    arrays = {f: np.asarray(getattr(jpart, f))
              for f in ARRAY_FIELDS + EIGEN_FIELDS
              if getattr(jpart, f) is not None}
    meta = {f: getattr(jpart, f) for f in META_FIELDS}
    return partition_from_arrays(arrays, meta, device)


def to_torch_tree(jtree):
    return TorchTree(jtree.n_tips, jtree.labels, jtree.edge_nodes.copy(),
                     jtree.lengths.copy(), jtree.n_nodes)


@dataclasses.dataclass
class Case:
    jpart: object          # JAX Partition in ``dtype``
    jpart64: object        # the same data and model in float64
    tpart: object          # the port's Partition (JAX arrays carried over)
    jtree: object
    tree: TorchTree
    seqs: list
    rates: np.ndarray
    freqs: np.ndarray


def make_case(seed, n_taxa, n_sites, states=4, cats=4, pinv=0.0,
              dtype=jnp.float32, cache=True, charmap=None):
    rng = np.random.default_rng(seed)
    jtree = ref.random_binary_tree(rng, n_taxa)
    if states == 20:
        seqs = ref.random_sequences(rng, n_taxa, n_sites,
                                    alphabet=jax_charmap.AA_ORDER,
                                    gap_frac=0.0)
    elif charmap is not None:
        syms = [chr(c) for c in charmap.valid_chars()]
        seqs = ["".join(rng.choice(syms, n_sites)) for _ in range(n_taxa)]
    else:
        seqs = ref.random_sequences(rng, n_taxa, n_sites)
    rates = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.dirichlet([8] * states)

    def build(dt):
        p = jax_create(seqs, states=states, n_rate_cats=cats, alpha=0.7,
                       subst_rates=rates, freqs=freqs, prop_invar=pinv,
                       charmap=charmap, dtype=dt)
        return p.cache_eigen() if cache else p

    jpart = build(dtype)
    return Case(jpart, build(jnp.float64), to_torch(jpart), jtree,
                to_torch_tree(jtree), seqs, rates, freqs)


def lengths(tree, dtype=torch.float32):
    return torch.as_tensor(tree.lengths, dtype=dtype)


def rel_err(got, want):
    return abs(float(got) - float(want)) / abs(float(want))
