"""Marginal ancestral state probabilities — the PyTorch counterpart of
``pllmod_tpu.algorithm.ancestral`` (``pllmod_treeinfo_compute_ancestral``,
treeinfo.c:1558-1718, and libpll's ``pll_compute_node_ancestral``).

For each inner node u with neighbors x, y, z, the per-site posterior
over states is

    prob[s] ∝ π_s · Σ_c w_c Π_{n ∈ {x,y,z}} (P(t_n) · A_{n→u})_s

The reference re-roots and recomputes incrementally per node; here all
directed CLVs come from one directed walk (``edge_grad.directed_clvs``:
kernel 2 for a float32 partition, at P-matrices built in float64 and
rounded once, the serial engine for float64), and every inner node is
scored in one batched product over the [N, C, S, P] gathers of
``edge_grad``. Each CLV's per-site scaler multiplies every state of that
site alike, so the per-site normalization removes it.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.optimize import blo as blo_mod
from pllmod_tpu_torch.optimize.blo import DirectedTraversal
from pllmod_tpu_torch.optimize.edge_grad import directed_clvs


def _pmats64(partition, brlens):
    """The P-matrices [E, C, S, S] of ``brlens`` (numpy), built in
    float64 and cast to the partition's dtype. A posterior reads the
    small entries of P (the unlikely states' paths), which a float32
    eigendecomposition's reconstruction V·diag(e^λt)·V⁻¹ leaves with
    relative errors up to ~1e-3; built in float64 and rounded once, each
    entry carries only its own rounding."""
    if partition.dtype == torch.float64:
        return partition.prob_matrices(brlens)
    p64 = partition.to(dtype=torch.float64).with_model_params()
    return p64.cache_eigen().prob_matrices(brlens).to(partition.dtype)


def ancestral_probabilities(partition, tree, nodes=None):
    """Posterior state probabilities at inner nodes.

    Args:
      partition: Partition
      tree: Tree
      nodes: optional list of inner node ids (default: all inner nodes)
    Returns:
      (nodes list, probs [n_nodes, patterns, states] numpy, normalized
      per site)
    """
    if nodes is None:
        adj = tree.adjacency()
        nodes = [n for n in range(tree.n_tips, tree.n_nodes) if adj[n]]
    trav = DirectedTraversal(tree)
    dev, dtype = partition.device, partition.dtype
    P = _pmats64(partition, tree.lengths)
    clvs, scalers, gather = directed_clvs(
        partition, blo_mod._compile_tables(partition, trav, derivs=False),
        P=P)

    # per node: (ref of A_{nbr->node}, edge id) for its 3 neighbors
    refs = []
    edges = []
    n_tips = tree.n_tips
    for u in nodes:
        row_r, row_e = [], []
        for nbr, e in tree.neighbors(u):
            if nbr < n_tips:
                row_r.append(nbr)
            else:
                row_r.append(n_tips + trav.slot_of[(nbr, u)])
            row_e.append(e)
        assert len(row_r) == 3, "ancestral states need a binary tree"
        refs.append(row_r)
        edges.append(row_e)
    refs = torch.as_tensor(np.array(refs, np.int64), device=dev)
    edges = torch.as_tensor(np.array(edges, np.int64), device=dev)

    acc = None
    for k in range(3):
        A, _s = gather(partition, clvs, scalers, refs[:, k])   # [N,C,S,P]
        term = torch.matmul(P[edges[:, k]], A.to(dtype))
        acc = term if acc is None else acc.mul_(term)
    del clvs, scalers
    acc.mul_(partition.freqs_per_cat()[None, :, :, None])
    site_state = torch.einsum("ncsp,c->nps", acc, partition.rate_weights)
    norm = site_state.sum(dim=2, keepdim=True)
    probs = site_state / torch.clamp(norm, min=1e-300)
    return nodes, probs.cpu().numpy()


def ancestral_states(partition, tree, nodes=None):
    """Most-probable state per site per inner node (argmax of
    :func:`ancestral_probabilities`)."""
    nodes, probs = ancestral_probabilities(partition, tree, nodes)
    return nodes, probs.argmax(axis=-1)
