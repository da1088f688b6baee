"""Per-node site-repeats compression — PLL_ATTRIB_SITE_REPEATS analog; a
copy of ``pllmod_tpu.ops.repeats`` (host numpy, float64) whose only
device step, the P-matrices, comes from the port's
``Partition.prob_matrices``.

Reference semantics (libpll-2 site repeats: per-node ``site_id[]`` (site
→ repeat class) and ``id_site[]`` (class → representative site)): within
a node's subtree, sites whose leaf patterns are identical have identical
CLV columns, so only one column per class needs computing. Classes
compose bottom-up — a node's class is the pair (left child's class,
right child's class) uniquified.

Repeats make the per-node working set data-dependent (K_p columns per
node), so this engine is host numpy with no kernel: an independent
float64 golden reference (``schedule="repeats"``) and, through
:func:`repeats_stats`, the measure of what the dense engines leave on
the table for a dataset. Whole-column duplicates are already removed by
pattern compression at partition build.
"""

from __future__ import annotations

import numpy as np
import torch

LN2 = float(np.log(2.0))


def _np(t, dtype=None):
    """A tensor's values as a host numpy array."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    return a if dtype is None else a.astype(dtype)


def compute_repeats(tip_codes: np.ndarray, ops: np.ndarray, n_tips: int,
                    n_codes: int):
    """Bottom-up repeat classes for every inner-node slot.

    Args:
      tip_codes: int [n_tips, P] tip state codes (rows of the code-CLV
        table; equal code ⇔ identical tip-CLV column, so tip classes are
        the codes themselves).
      ops: int32 [n_inner, 5] post-order rows
        (parent_slot, child1, edge1, child2, edge2); −1 rows are skipped.
      n_codes: number of rows of the code-CLV table.

    Returns:
      (site_id, n_classes, id_site): three dicts keyed by inner slot —
      ``site_id[s]`` int32 [P] class of each site at that node,
      ``n_classes[s]`` the class count K_s, and ``id_site[s]`` int64
      [K_s] the representative (first) site of each class.
    """
    site_id: dict[int, np.ndarray] = {}
    n_classes: dict[int, int] = {}
    id_site: dict[int, np.ndarray] = {}

    def node_classes(node: int):
        if node < n_tips:
            return tip_codes[node], n_codes
        s = node - n_tips
        return site_id[s], n_classes[s]

    for row in np.asarray(ops):
        slot, c1, _e1, c2, _e2 = (int(x) for x in row)
        if slot < 0:
            continue
        id1, _ = node_classes(c1)
        id2, k2 = node_classes(c2)
        pair = id1.astype(np.int64) * np.int64(k2) + id2.astype(np.int64)
        uniq, first, inv = np.unique(pair, return_index=True,
                                     return_inverse=True)
        site_id[slot] = inv.astype(np.int32)
        n_classes[slot] = len(uniq)
        id_site[slot] = first.astype(np.int64)
    return site_id, n_classes, id_site


def repeats_stats(partition, tree, root_edge=None) -> dict:
    """Per-node repeat-class counts and the work ratio against dense
    pruning (ratio ≪ 1 ⇒ the dataset is repeat-heavy)."""
    ops, _ = tree.traversal_ops(root_edge)
    Pn = partition.n_patterns
    tip_codes = _np(partition.tip_states)[:, :Pn]
    _sid, kcount, _rep = compute_repeats(
        tip_codes, ops, partition.n_tips, int(partition.code_clv.shape[0]))
    slots = sorted(kcount)
    unique_work = int(sum(kcount.values()))
    dense_work = len(slots) * Pn
    return {
        "n_patterns": Pn,
        "n_inner": len(slots),
        "per_node_classes": [kcount[s] for s in slots],
        "unique_work": unique_work,
        "dense_work": dense_work,
        "work_ratio": unique_work / max(dense_work, 1),
    }


def _site_lnl_np(partition, per_cat: np.ndarray, scaler: np.ndarray,
                 Pn: int) -> np.ndarray:
    """float64 mirror of likelihood._site_lnl (per-category p-inv/freqs
    via param_indices; overflow-safe log-space mixture)."""
    w = _np(partition.rate_weights, np.float64)
    pinv_c = _np(partition.pinv_per_cat(), np.float64)
    tiny = 1e-300
    A = per_cat @ (w * (1.0 - pinv_c))
    ln_var = np.log(np.maximum(A, tiny)) + scaler.astype(np.float64) * LN2
    if pinv_c.max() > 0:
        fc = _np(partition.freqs_per_cat(), np.float64)
        inv_pc = _np(partition.inv_indicator, np.float64)[:Pn] @ fc.T  # [P,C]
        B = inv_pc @ (w * pinv_c)
        with np.errstate(divide="ignore"):
            ln_b = np.where(B > 0, np.log(np.maximum(B, tiny)), -np.inf)
        return np.logaddexp(ln_var, ln_b)
    return ln_var


def loglikelihood_repeats(partition, tree, brlens=None, root_edge=None,
                          return_stats: bool = False):
    """Full-tree edge log-likelihood computing only the UNIQUE CLV
    columns of every inner node (host numpy, float64 accumulation; a
    Python float).

    Same contract as ``engine.tree_loglikelihood`` (virtual root on
    ``root_edge``; per-node exact power-of-two rescaling; per-category
    p-inv mixture), with ``unique_work/dense_work`` of the pruning
    FLOPs. The P-matrices are built in the partition's dtype on its
    device, as the other schedules build them, then widened.
    """
    if brlens is None:
        brlens = tree.lengths
    Pmats = _np(partition.prob_matrices(brlens), np.float64)   # [E,C,S,S]
    n_tips = partition.n_tips
    Pn = partition.n_patterns
    C = partition.n_cats
    tip_codes = _np(partition.tip_states)[:, :Pn]
    code_clv = _np(partition.code_clv, np.float64)             # [codes,S]

    ops, root_info = tree.traversal_ops(root_edge)
    site_id, kcount, id_site = compute_repeats(
        tip_codes, ops, n_tips, code_clv.shape[0])

    clvs: dict[int, np.ndarray] = {}      # slot -> [K, C, S]
    scalers: dict[int, np.ndarray] = {}   # slot -> [K] int64

    def node_cols(node: int, sites: np.ndarray):
        """CLV columns + scalers of ``node`` at the given sites."""
        if node < n_tips:
            cols = code_clv[tip_codes[node, sites]]            # [n,S]
            cols = np.broadcast_to(
                cols[:, None, :], (len(sites), C, cols.shape[-1]))
            return cols, np.zeros(len(sites), np.int64)
        s = node - n_tips
        cls = site_id[s][sites]
        return clvs[s][cls], scalers[s][cls]

    for row in np.asarray(ops):
        slot, c1, e1, c2, e2 = (int(x) for x in row)
        if slot < 0:
            continue
        sites = id_site[slot]
        left_c, sl = node_cols(c1, sites)
        right_c, sr = node_cols(c2, sites)
        left = np.einsum("kcj,cij->kci", left_c, Pmats[e1])
        right = np.einsum("kcj,cij->kci", right_c, Pmats[e2])
        clv = left * right
        m = clv.max(axis=(1, 2))
        _mant, e = np.frexp(m)
        e = np.where(m > 0, e, 0).astype(np.int64)
        clvs[slot] = np.ldexp(clv, -e[:, None, None])
        scalers[slot] = sl + sr + e

    u, v, eid = (int(x) for x in root_info)
    allsites = np.arange(Pn)
    cu, su = node_cols(u, allsites)        # expand classes per site
    cv, sv = node_cols(v, allsites)
    fc = _np(partition.freqs_per_cat(), np.float64)
    right = np.einsum("pcj,cij->pci", cv, Pmats[eid])
    per_cat = np.einsum("pci,ci,pci->pc", cu, fc, right)
    lnl = _site_lnl_np(partition, per_cat, su + sv, Pn)
    w = _np(partition.pattern_weights, np.float64)[:Pn]
    total = float(lnl @ w)
    if return_stats:
        n_inner = len(kcount)
        return total, {
            "unique_work": int(sum(kcount.values())),
            "dense_work": n_inner * Pn,
        }
    return total
