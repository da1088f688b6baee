"""Shared inputs of the ``test_torch_*`` files: one model and alignment,
made with numpy from a seed, built by the JAX package and carried into
the PyTorch port through ``pllmod_tpu_torch.convert``, so both packages
evaluate the same numbers."""

from __future__ import annotations

import dataclasses
import functools
import gc

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu_torch.convert import (ARRAY_FIELDS, EIGEN_FIELDS,
                                      META_FIELDS, partition_from_arrays)
from pllmod_tpu_torch.tree.topology import Tree as TorchTree
from tests import reference_impl as ref


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread (autouse in
    every module that imports it). The suite runs in several worker
    processes, and torch's default of one OpenMP thread a core in each
    oversubscribes the cores, so that every parallel op spins: six
    concurrent runs of ``test_blo_matches_jax`` took 215 s each, against
    11 s each on one thread.

    It also keeps the garbage collector off the objects that exist when
    the module starts (``gc.freeze``) and collects less often: tracing
    the JAX package's interpret-mode kernels allocates millions of small
    objects, and every full collection would walk the imported modules'
    objects again."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    threshold = gc.get_threshold()
    gc.set_threshold(50_000, 20, 20)
    yield
    gc.set_threshold(*threshold)
    gc.unfreeze()
    torch.set_num_threads(n)


def with_eigen(jpart):
    """``jpart`` with its eigendecomposition cached: the JAX package's
    recipe (``eigen.eigen_reversible``: Q symmetrized by √π, ``eigh``,
    back-transformed) in numpy float64, cast to the partition's dtype.
    Both packages then read the same numbers. The JAX package's eager
    ``cache_eigen`` compiles some fifteen small programs for every shape
    in every test module (JAX's caches are cleared between modules),
    seconds each time."""
    rates = np.asarray(jpart.subst_rates, np.float64)
    freqs = np.asarray(jpart.freqs, np.float64)
    S = freqs.shape[-1]
    iu = np.triu_indices(S, k=1)
    out = []
    for r, f in zip(rates, freqs):
        pi = np.maximum(f, 1e-16)
        R = np.zeros((S, S))
        R[iu] = r
        Q = (R + R.T) * pi[None, :]
        Q -= np.diag(Q.sum(axis=1))
        Q /= max(-np.sum(pi * np.diag(Q)), 1e-16)
        sp = np.sqrt(pi)
        B = Q * (sp[:, None] / sp[None, :])
        lam, U = np.linalg.eigh(0.5 * (B + B.T))
        out.append((lam, U / sp[:, None], U.T * sp[None, :]))
    dt = np.asarray(jpart.freqs).dtype
    lam, V, Vinv = (jnp.asarray(np.stack(x).astype(dt)) for x in zip(*out))
    return jpart.replace(eigen_lam=lam, eigen_V=V, eigen_Vinv=Vinv)


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
    build: object          # dtype -> JAX Partition of this data and model
    tpart: object          # the port's Partition (JAX arrays carried over)
    jtree: object
    tree: TorchTree
    seqs: list
    rates: np.ndarray
    freqs: np.ndarray

    @functools.cached_property
    def jpart64(self):
        """The same data and model in float64, built on first use (a JAX
        partition costs seconds of eager compiles, and many tests never
        read this one)."""
        return self.build(jnp.float64)


def simulate(rng, tree, n_sites, rates, freqs, symbols, alpha=0.7, cats=4):
    """Sequences evolved along ``tree`` under (rates, freqs)+Γ, state i
    written as ``symbols[i]``: tree-signal data, whose likelihood has
    well-conditioned optima (random sequences have flat, saturated ones
    that equally correct optimizers resolve differently)."""
    from scipy.linalg import expm
    Q = ref.build_q(rates, freqs)
    cat_rates = ref.gamma_cats_mean(alpha, cats)
    site_cat = rng.integers(0, cats, n_sites)
    adj = tree.adjacency()
    seqs = {tree.n_tips: rng.choice(len(freqs), n_sites, p=freqs)}
    stack = [(tree.n_tips, -1)]
    while stack:
        node, parent = stack.pop()
        for nbr, e in adj[node]:
            if nbr == parent:
                continue
            cum = np.stack([expm(Q * tree.lengths[e] * r)
                            for r in cat_rates]).cumsum(-1)
            rows = cum[site_cat, seqs[node]]                # [sites, S]
            seqs[nbr] = np.minimum((rng.random((n_sites, 1)) > rows)
                                   .sum(1), len(freqs) - 1)
            stack.append((nbr, node))
    chars = np.array(list(symbols))
    return ["".join(chars[seqs[t]]) for t in range(tree.n_tips)]


def make_case(seed, n_taxa, n_sites, states=4, cats=4, pinv=0.0,
              dtype=jnp.float32, cache=True, charmap=None,
              symbols=None, jax_eigen=False):
    """A case of random sequences, or with ``symbols`` (one character per
    state) sequences simulated along the tree (:func:`simulate`). With
    ``cache`` the partitions carry their eigendecomposition from
    :func:`with_eigen`; ``jax_eigen`` gives ``jpart`` (not ``jpart64``)
    the JAX package's own ``cache_eigen`` instead."""
    rng = np.random.default_rng(seed)
    jtree = ref.random_binary_tree(rng, n_taxa)
    if symbols is not None:
        seqs = None
    elif states == 20:
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
    if symbols is not None:
        seqs = simulate(rng, jtree, n_sites, rates, freqs, symbols)

    def build(dt, jax_eigen=False):
        p = jax_create(seqs, states=states, n_rate_cats=cats, alpha=0.7,
                       subst_rates=rates, freqs=freqs, prop_invar=pinv,
                       charmap=charmap, dtype=dt)
        if not cache:
            return p
        return p.cache_eigen() if jax_eigen else with_eigen(p)

    jpart = build(dtype, jax_eigen)
    return Case(jpart, build, to_torch(jpart), jtree,
                to_torch_tree(jtree), seqs, rates, freqs)


def caterpillar_newick(n):
    """The maximally unbalanced tree on t0..t{n-1}: every level of its
    schedule holds one node."""
    return ("(t0:0.1," + "".join(f"(t{i}:0.{i + 1}," for i in range(1, n - 1))
            + f"t{n - 1}:0.1" + ")" * (n - 2) + ");")


def level_case(seed, n_taxa, n_sites, states=4, cats=4, pinv=0.0,
               caterpillar=False, **kw):
    """A :func:`make_case`, its tree replaced by a caterpillar on request."""
    case = make_case(seed, n_taxa, n_sites, states=states, cats=cats,
                     pinv=pinv, **kw)
    if caterpillar:
        from pllmod_tpu.tree.topology import Tree as JaxTree
        jtree = JaxTree.from_newick(caterpillar_newick(n_taxa))
        case = dataclasses.replace(case, jtree=jtree,
                                   tree=to_torch_tree(jtree))
    return case


def tip_edge(tree):
    """The first edge with a tip endpoint."""
    return next(e for e, (u, v) in enumerate(tree.edge_nodes)
                if int(u) >= 0 and (tree.is_tip(int(u))
                                    or tree.is_tip(int(v))))


def lengths(tree, dtype=torch.float32):
    return torch.as_tensor(tree.lengths, dtype=dtype)


def rel_err(got, want):
    return abs(float(got) - float(want)) / abs(float(want))
