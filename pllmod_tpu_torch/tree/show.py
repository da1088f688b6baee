"""Debug/visual helpers: ASCII tree drawing + pmatrix/CLV dumps.

Host-side port (a copy of the JAX package's module) of libpll's
``pll_utree_show_ascii``, ``pll_show_pmatrix`` and ``pll_show_clv``
(SURVEY §2.9 misc) — the printf-observability surface the reference's
golden tests rely on. ``show_pmatrix`` and ``show_clv`` take torch
tensors (on any device) or numpy arrays.
"""

from __future__ import annotations

import io

from pllmod_tpu_torch.common import host_array


def show_ascii(tree, root_node=None, show_lengths: bool = True) -> str:
    """ASCII rendering of the (unrooted) tree, rooted for display at an
    inner node (pll_utree_show_ascii analog)."""
    adj = tree.adjacency()
    if root_node is None:
        root_node = next(n for n in range(tree.n_tips, tree.n_nodes)
                         if adj[n])
    out = io.StringIO()

    def name(node, pedge):
        lb = tree.labels[node] if tree.is_tip(node) else f"[{node}]"
        if show_lengths and pedge >= 0:
            lb += f":{tree.lengths[pedge]:.4f}"
        return lb

    def rec(node, parent, pedge, prefix, is_last):
        connector = "" if parent == -1 else ("└─" if is_last else "├─")
        out.write(prefix + connector + name(node, pedge) + "\n")
        kids = [(n, e) for n, e in adj[node] if n != parent]
        if tree.is_tip(node):
            return
        ext = "" if parent == -1 else ("  " if is_last else "│ ")
        for i, (nbr, e) in enumerate(kids):
            rec(nbr, node, e, prefix + ext, i == len(kids) - 1)

    rec(root_node, -1, -1, "", True)
    return out.getvalue()


def show_pmatrix(P, edge: int, precision: int = 4) -> str:
    """Formatted P-matrix for one edge: [C, S, S] rows per category
    (pll_show_pmatrix analog)."""
    P = host_array(P)
    mat = P[edge]
    out = io.StringIO()
    for c in range(mat.shape[0]):
        out.write(f"# category {c}\n")
        for row in mat[c]:
            out.write(" ".join(f"{x:.{precision}f}" for x in row) + "\n")
    return out.getvalue()


def show_clv(clvs, scalers, slot: int, sites=None, precision: int = 6) -> str:
    """Formatted CLV dump for one slot (pll_show_clv analog)."""
    clv = host_array(clvs)[slot]
    sc = host_array(scalers)[slot]
    n_sites = clv.shape[0] if sites is None else sites
    out = io.StringIO()
    for p in range(n_sites):
        cats = " | ".join(
            " ".join(f"{x:.{precision}g}" for x in clv[p, c])
            for c in range(clv.shape[1]))
        out.write(f"site {p} (2^{-int(sc[p])}): {cats}\n")
    return out.getvalue()
