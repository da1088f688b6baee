"""The substitution model as the benchmark states it, in float64: the
rate matrix Q, the discrete Γ categories and the random binary tree.

Both sides take their inputs from here: the program gets the arrays, the
plain reference (:mod:`phylobench.reference`) works everything else out
again. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def build_q(subst_rates, freqs) -> torch.Tensor:
    """Reversible rate matrix [S, S] in float64: Q_ij = r_ij π_j (i ≠ j),
    rows summing to 0, scaled to a mean rate Σ_i π_i (−Q_ii) of 1.
    ``subst_rates`` is the upper triangle, row major."""
    pi = torch.as_tensor(freqs, dtype=torch.float64)
    S = pi.shape[0]
    R = torch.zeros((S, S), dtype=torch.float64)
    iu = torch.triu_indices(S, S, 1)
    R[iu[0], iu[1]] = torch.as_tensor(subst_rates, dtype=torch.float64)
    R = R + R.T
    Q = R * pi[None, :]
    Q = Q - torch.diag(Q.sum(1))
    return Q / -(pi * torch.diagonal(Q)).sum()


def _gamma_quantile(alpha: float, p: float) -> float:
    """x with P(alpha, x) = p (the regularized lower incomplete Γ), by
    bisection in float64."""
    a = torch.tensor(alpha, dtype=torch.float64)
    lo, hi = 0.0, 1.0
    while torch.special.gammainc(a, torch.tensor(hi, dtype=torch.float64)) < p:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if torch.special.gammainc(a, torch.tensor(mid, dtype=torch.float64)) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def gamma_rates(alpha: float, k: int) -> np.ndarray:
    """The mean rates of k equiprobable categories of Γ(alpha, alpha)
    (Yang 1994's mean method; mean 1)."""
    if k == 1:
        return np.ones(1)
    bounds = [_gamma_quantile(alpha, i / k) for i in range(1, k)]
    a1 = torch.tensor(alpha + 1.0, dtype=torch.float64)
    cdf = [0.0] + [float(torch.special.gammainc(
        a1, torch.tensor(b, dtype=torch.float64))) for b in bounds] + [1.0]
    return k * np.diff(np.asarray(cdf))


def model_arrays(config: dict) -> dict:
    """The model of ``config`` as float64 numpy arrays: ``subst_rates``,
    ``freqs`` (normalised to sum 1), ``rate_cats``, ``rate_weights``,
    ``alpha``."""
    m = config["model"]
    if m.get("gamma", "mean") != "mean" or m.get("prop_invar", 0.0) != 0.0:
        raise ValueError("the benchmark states Γ by category means and no "
                         "invariant sites")
    freqs = np.asarray(m["freqs"], np.float64)
    k = int(m["rate_cats"])
    return dict(subst_rates=np.asarray(m["subst_rates"], np.float64),
                freqs=freqs / freqs.sum(),
                rate_cats=gamma_rates(float(m["alpha"]), k),
                rate_weights=np.full(k, 1.0 / k),
                alpha=float(m["alpha"]))


def random_binary_tree(rng: np.random.Generator, n_tips: int,
                       min_len: float, max_len: float):
    """(edges int32 [2n−3, 2], lengths float64 [2n−3]) of a random
    unrooted binary tree: a 3-star on tips 0–2 at inner node n, then tip
    k splits an edge drawn uniformly from those so far; lengths
    U(min_len, max_len) in edge order. Inner nodes are n .. 2n−3."""
    edges = np.zeros((2 * n_tips - 3, 2), np.int64)
    edges[:3] = [[0, n_tips], [1, n_tips], [2, n_tips]]
    n_edges, next_inner = 3, n_tips + 1
    picks = rng.integers(0, np.arange(3, 2 * n_tips - 3, 2))
    for tip, e in zip(range(3, n_tips), picks):
        u, v = edges[e]
        w = next_inner
        next_inner += 1
        edges[e] = [u, w]
        edges[n_edges] = [w, v]
        edges[n_edges + 1] = [tip, w]
        n_edges += 2
    lengths = rng.uniform(min_len, max_len, size=n_edges)
    return edges.astype(np.int32), lengths


class Rooted:
    """The tree ``edges`` (unrooted, binary, tips 0 .. n_tips−1) hung from
    its inner node ``n_tips``, which keeps three children; every other
    inner node has two.

    - ``parent[v]``, ``pedge[v]``: v's parent and the edge between them
      (−1 at the root);
    - ``children[v]``: a list of (child, edge) for every inner v;
    - ``up_levels``: the inner nodes but the root, by height (tips 0),
      each level as int64 arrays (nodes, c1, e1, c2, e2);
    - ``down_levels``: every node but the root, by depth, each level as
      int64 arrays (nodes, their parents, their edges).
    """

    def __init__(self, edges, n_tips: int):
        edges = np.asarray(edges, np.int64)
        self.n_tips = n_tips
        self.n_nodes = n_nodes = int(edges.max()) + 1
        self.root = root = n_tips
        adj = [[] for _ in range(n_nodes)]
        for e, (u, v) in enumerate(edges.tolist()):
            adj[u].append((v, e))
            adj[v].append((u, e))
        parent = np.full(n_nodes, -1, np.int64)
        pedge = np.full(n_nodes, -1, np.int64)
        depth = np.zeros(n_nodes, np.int64)
        order = [root]
        children = {}
        seen = np.zeros(n_nodes, bool)
        seen[root] = True
        for v in order:
            kids = []
            for w, e in adj[v]:
                if not seen[w]:
                    seen[w] = True
                    parent[w], pedge[w], depth[w] = v, e, depth[v] + 1
                    kids.append((w, e))
                    order.append(w)
            if v >= n_tips:
                children[v] = kids
        if len(order) != n_nodes:
            raise ValueError("the edges do not make one tree")
        height = np.zeros(n_nodes, np.int64)
        for v in reversed(order):
            if v >= n_tips:
                height[v] = 1 + max(height[w] for w, _ in children[v])
        self.parent, self.pedge, self.depth = parent, pedge, depth
        self.children, self.height = children, height
        inner = np.array([v for v in order if v >= n_tips and v != root],
                         np.int64)
        self.up_levels = []
        for h in range(1, int(height[inner].max(initial=0)) + 1):
            nodes = inner[height[inner] == h]
            kids = np.array([[c for ce in children[v] for c in ce]
                             for v in nodes.tolist()], np.int64).reshape(-1, 4)
            self.up_levels.append((nodes, kids[:, 0], kids[:, 1], kids[:, 2],
                                   kids[:, 3]))
        nodes = np.array(order[1:], np.int64)
        self.down_levels = []
        for d in range(1, int(depth.max()) + 1):
            lv = nodes[depth[nodes] == d]
            self.down_levels.append((lv, parent[lv], pedge[lv]))
