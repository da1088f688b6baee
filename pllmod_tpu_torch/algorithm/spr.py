"""SPR-round topology search with batched regraft scoring — the PyTorch
counterpart of ``pllmod_tpu.algorithm.spr`` (``pllmod_algo_spr_round``,
``src/algorithm/algo_search.c``; call stack SURVEY.md §3.4).

The reference scores each regraft candidate serially with incremental
CLV updates. Here, as in the JAX package, for each pruned subtree

1. the host builds the remainder tree R (O(n) bookkeeping, cached by
   topology),
2. one directed walk computes ALL directed CLVs of R,
3. one batched evaluation scores EVERY regraft edge of R: for edge
   (x, y) the placed likelihood is
   ``L_p = Σ_c w_c Σ_i π_i (P(t_s)·clv_S)_i (P(l/2)·A_{x→y})_i (P(l/2)·A_{y→x})_i``
   with clv_S the pruned subtree's root CLV (the reference's fast-mode
   attachment, algo_search.c:753-787), or in thorough mode the
   reference's radius-1 triplet Newton on (t_s, t_x, t_y)
   (algo_search.c:792-807),
4. the best candidate inside the BFS radius window (host mask) is
   applied when it improves the logL by more than ``epsilon``
   (algo_search.c:953); the others feed a top list of non-applied
   moves (algo_search.c:70-346), re-tried with a BLO after the round's
   full BLO (algo_search.c:1271-1470).

K candidates are scored at once: their remainder tables are
concatenated into one op table (candidate k's CLV slots offset by
k·stride, its edge / P-matrix ids by k·E), so one directed walk builds
every candidate's remainder CLVs. The adaptive driver grows K
geometrically while candidates do not apply and resets it to 1 on an
applied move; candidates resolve in candidate order against the tree
state a serial loop would see, so the batched and the serial driver
apply the same moves.

Engines, by the partition's dtype (``optimize/edge_grad.directed_clvs``
over ``blo._compile_tables`` / ``blo.walk_tables``):

- float32 runs kernel 2 (``fused.fused_walk``, ``csrc/fused.cu``) for
  the full tree's directed CLVs and the K-candidate tables; its buffers
  are ``[n_slots, C·S, Ppad]`` with scalers ``[n_slots, 1, Ppad]``;
- float64 runs the serial engine (``clv.update_partials``,
  ``[n_slots, Ppad, C, S]``).

Both are gathered into ``[.., C, S, P]`` (``edge_grad.gather_csp`` /
``gather_std``), and every contraction of the scorers is a batched
``matmul`` over that layout, in the partition's dtype (TF32 is off,
``pllmod_tpu_torch/__init__.py``); the per-site logLs are summed over
patterns in float64. The scorers' contractions are plain torch: the
JAX package has no Pallas kernel there. The round ends with
``blo.optimize_branch_lengths_treeinfo`` (kernels 1, 8–10 for float32).

Under a site mesh (sharded partitions, ``parallel.shard_treeinfo``; the
JAX package's ``_fused_clvs_brl_sharded``, ``_score_*_sharded``,
spr.py:144-216, :590-672) the full-tree CLVs and both scorers run on
every shard, on its device, from tables compiled once: the fast
scorer's per-candidate scores are reduced over the shards before the
top list is chosen, and the thorough scorer's triplet Newton sums its
derivatives over every shard each iteration, so that every shard takes
the same step. The closing BLO reduces its own (``optimize/blo.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from itertools import chain

import numpy as np
import torch

from pllmod_tpu_torch.common import BRLEN_SCALED
from pllmod_tpu_torch.ops import derivatives as deriv_mod
from pllmod_tpu_torch.ops import likelihood as lk_mod
from pllmod_tpu_torch.ops.engine import reduce_shards
from pllmod_tpu_torch.optimize import blo as blo_mod
from pllmod_tpu_torch.optimize.blo import (DirectedTraversal,
                                           optimize_branch_lengths_treeinfo)
from pllmod_tpu_torch.optimize.edge_grad import directed_clvs
from pllmod_tpu_torch.optimize.newton import minimize_newton_multi
from pllmod_tpu_torch.parallel.sharding import shards_of
from pllmod_tpu_torch.tree import moves

# Reuse the full-tree directed-CLV buffers across applied SPRs under the
# dirty-node validity protocol (see spr_round). False = rebuild after
# every applied move, the reference the protocol is held to
# (tests/test_torch_spr_reuse.py; results are bit-identical either way).
FULL_CLV_REUSE = True

# Max prune candidates scored per batch: the adaptive driver grows the
# batch 1 -> 2 -> ... -> limit while candidates don't apply, and resets
# it to 1 on an applied move. None = auto (:func:`_spr_batch_limit`);
# 1 = the serial driver.
SPR_BATCH_MAX: int | None = None
SPR_BATCH_CAP = 16
# the auto limit's budget on the CPU (on a card: half the bytes it can
# still hand out at the round's start, _batch_budget)
CPU_BATCH_BYTES = 1 << 30
# live slot-sized tensors a window row of the thorough scorer holds at
# its peak: the two gathered sides, the two P·side products and their
# product, the sumtable, the derivatives' exponential product and one
# temporary of theirs
THOROUGH_ROW_SLOTS = 8
# the triplet Newton's stopping step and iteration cap (a coordinate's
# Newton, the reference's radius-1 triplet BLO, algo_search.c:792-807)
TRIPLET_TOL = 1e-4
TRIPLET_ITERS = 6

# Wall-decomposition accumulator: total host seconds spent inside SPR
# candidate host builds (reset at will).
HOST_BUILD_SECONDS = 0.0

# Structural host_build cache: the remainder tree R, radius mask and
# DirectedTraversal of a candidate depend only on (topology, prune_edge,
# junction, radius window), and converged rounds revisit identical
# topologies. Branch LENGTHS change between rounds (BLO/model-opt), so
# hits refresh R.lengths from the live tree (fused edge = sum of the
# two merged junction edges). Least recently used entries go first.
_HOST_BUILD_CACHE: collections.OrderedDict = collections.OrderedDict()
_HOST_BUILD_CACHE_MAX = 1024


def _cache_get(key):
    hit = _HOST_BUILD_CACHE.get(key)
    if hit is not None:
        _HOST_BUILD_CACHE.move_to_end(key)
    return hit


def _cache_put(key, value):
    _HOST_BUILD_CACHE[key] = value
    if len(_HOST_BUILD_CACHE) > _HOST_BUILD_CACHE_MAX:
        _HOST_BUILD_CACHE.popitem(last=False)


def _window_bound(n_edge_slots: int) -> int:
    """The largest window width the thorough driver pads to."""
    return max(8, 1 << int(max(n_edge_slots, 1) - 1).bit_length())


def _batch_budget(dev) -> int:
    """The auto batch limit's byte budget on ``dev``: half the bytes the
    card can still hand out (the driver's free bytes and the blocks the
    caching allocator holds unused, so the budget does not depend on
    what ran before in the process), :data:`CPU_BATCH_BYTES` on the
    CPU."""
    if dev is None or dev.type != "cuda":
        return CPU_BATCH_BYTES
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    return free // 2


def _spr_batch_limit(treeinfo, n_edge_slots: int, stride: int,
                     thorough: bool = False) -> int:
    """Auto batch bound: the bytes a candidate keeps alive on each
    device, summed over the partitions and the shards that share that
    device, against the device's :func:`_batch_budget` at the round's
    start; the tightest device sets the bound. A candidate holds its
    remainder buffer (``stride`` slots of C·S·Ppad values, a shard's
    Ppad) and, in fast mode, 4 slots a regraft edge (the two gathered
    sides and the two P·side products), in thorough mode
    :data:`THOROUGH_ROW_SLOTS` a window row. Floored to a power of
    two, capped at :data:`SPR_BATCH_CAP`; :data:`SPR_BATCH_MAX` overrides
    it."""
    if SPR_BATCH_MAX is not None:
        return max(1, SPR_BATCH_MAX)
    rows = (THOROUGH_ROW_SLOTS * _window_bound(n_edge_slots) if thorough
            else 4 * n_edge_slots)
    per: dict = {}
    for i in treeinfo.local_indices():
        for p in shards_of(treeinfo.partitions[i]):
            per[p.device] = per.get(p.device, 0) + (
                (stride + rows) * p.n_patterns_padded * p.n_cats * p.states
                * p.freqs.element_size())
    k = max(1, min((int(_batch_budget(dev) // max(n, 1))
                    for dev, n in per.items()), default=1))
    k = 1 << (k.bit_length() - 1)          # floor to a power of two
    return int(min(SPR_BATCH_CAP, k))


def full_tree_clvs(partition, brlens, trav):
    """The full tree's directed CLVs of ``trav`` at ``brlens`` (numpy):
    (clvs, scalers, gather) of :func:`edge_grad.directed_clvs`."""
    return _full_clvs(partition, brlens, trav)[0]


def _full_clvs(partition, brlens, trav):
    """:func:`full_tree_clvs` of every shard of ``partition`` (a plain
    partition is its one shard), each on its device from one table
    compile: a list in shard order."""
    brl = torch.as_tensor(np.asarray(brlens, np.float64),
                          dtype=partition.dtype, device=partition.device)
    tabs = blo_mod._compile_tables(partition, trav, derivs=False)
    return [directed_clvs(s, t, brl)
            for s, t in zip(shards_of(partition), tabs.shards or [tabs])]


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------
def _weighted_lnl(partition, per_cat, scaler):
    """Σ_p w_p lnl[.., p] in float64 of per-category site likelihoods
    ``per_cat`` [.., C, P] with scalers [.., P]."""
    site = lk_mod._site_lnl(partition, per_cat.transpose(-1, -2), scaler)
    return site.to(torch.float64) @ partition.pattern_weights.to(
        torch.float64)


def _score_regrafts_batch(partition, ops_cat, brl_cat, clv_S_b, scaler_S_b,
                          t_s_b, edge_ref_flat, edge_mask_b, half_flat,
                          stride: int, tables=None):
    """Fast-mode regraft scoring for K prune candidates at once.

    The K remainder trees' directed traversals are concatenated into one
    op table (candidate k's CLV slots offset by ``k*stride``, its edge /
    P-matrix ids by ``k*E``), so one directed walk
    (``edge_grad.directed_clvs``) computes every candidate's remainder
    CLVs, and one batched contraction scores all K × E regraft
    placements.

    Args:
      ops_cat: int [K*n_ops_full, 5] concatenated+offset op tables
      brl_cat: [K*E] per-candidate remainder branch lengths
      clv_S_b / scaler_S_b: [K, C, S, P] / [K, P] pruned-subtree CLVs
      t_s_b: [K] subtree attachment lengths
      edge_ref_flat: long [K*E, 2] offset directed-CLV refs
      edge_mask_b: bool [K, E]
      half_flat: [K*E] attachment half-lengths
      stride: CLV-slot stride between candidates (n_ops_full + 2)
      tables: ``blo.walk_tables(partition, ops_cat, K * stride)`` when
        the caller has compiled it
    Returns:
      lnl float64 [K, E] (-inf on masked edges)
    """
    dtype = partition.dtype
    K, E = edge_mask_b.shape
    if tables is None:
        tables = blo_mod.walk_tables(partition, ops_cat, K * stride)
    clvs, scalers, gather = directed_clvs(partition, tables, brl_cat)
    P_s = partition.prob_matrices(t_s_b)                    # [K,C,S,S]
    fc = partition.freqs_per_cat()                          # [C,S]
    s_in = torch.matmul(P_s, clv_S_b.to(dtype)) * fc[:, :, None]
    P_h = partition.prob_matrices(half_flat)                # [K*E,C,S,S]
    A_x, sx = gather(partition, clvs, scalers, edge_ref_flat[:, 0])
    u = torch.matmul(P_h, A_x.to(dtype))                    # [K*E,C,S,P]
    del A_x
    A_y, sy = gather(partition, clvs, scalers, edge_ref_flat[:, 1])
    del clvs, scalers
    u.mul_(torch.matmul(P_h, A_y.to(dtype)))
    del A_y
    C, S, Ppad = u.shape[1:]
    u = u.view(K, E, C, S, Ppad).mul_(s_in[:, None])
    per_cat = u.sum(-2)                                     # [K,E,C,P]
    del u
    sc_tot = (sx + sy).view(K, E, Ppad) + scaler_S_b[:, None, :]
    lnls = _weighted_lnl(partition, per_cat, sc_tot)
    return torch.where(edge_mask_b, lnls,
                       torch.full_like(lnls, -float("inf")))


def _triplet_newton(sides, t_s, hl, min_brlen, max_brlen):
    """The thorough scorer's triplet coordinate Newton (the reference's
    radius-1 triplet BLO, algo_search.c:792-807) over a batch of window
    rows: two cycles over (t_s, t_x, t_y), each coordinate a bracketed
    Newton (:data:`TRIPLET_TOL`, :data:`TRIPLET_ITERS`) against its
    sumtable, summed over partitions with the brlen-scaler chain rule
    (df·s, ddf·s², pll_optimize.c:1249-1267).

    ``sides``: per partition, or per shard of a sharded partition
    (part, scaler, eigen, A_x, sx, A_y, sy, clv_S, scaler_S) with the
    sides [K, W, C, S, P] / [K, W, P] and the subtree [K, 1, C, S, P] /
    [K, 1, P] on that part's device; ``t_s`` [K, W], ``hl`` [K, W] the
    start lengths. The derivatives and logLs are summed over every side
    on ``t_s``'s device. Returns (lnl, ts, tx, ty), each [K, W]."""
    K, W = hl.shape

    def comb(part, psc, c1, t1, c2, t2):
        C, S = part.n_cats, part.states
        P1 = part.prob_matrices((t1 * psc).reshape(-1)).view(K, W, C, S, S)
        P2 = part.prob_matrices((t2 * psc).reshape(-1)).view(K, W, C, S, S)
        return torch.matmul(P1, c1) * torch.matmul(P2, c2)

    def coord_newton(t_triple, which):
        ts, tx, ty = t_triple
        sts, scs = [], []
        for part, psc, eigen, A_x, sx, A_y, sy, clv_S, scaler_S in sides:
            if which == 0:    # t_s: edge between clv_S and (x, y)
                B, other = comb(part, psc, A_x, tx, A_y, ty), clv_S
            elif which == 1:  # t_x
                B, other = comb(part, psc, clv_S, ts, A_y, ty), A_x
            else:             # t_y
                B, other = comb(part, psc, clv_S, ts, A_x, tx), A_y
            st = deriv_mod.sumtable(part, B.movedim(-1, -3),
                                    other.movedim(-1, -3), eigen)
            del B
            sts.append(st)
            scs.append(sx + sy + scaler_S)
        t0 = (ts, tx, ty)[which]

        def deriv(t):
            df_tot = torch.zeros_like(t)
            ddf_tot = torch.zeros_like(t)
            for (part, psc, eigen, *_), st, sc in zip(sides, sts, scs):
                _, df, ddf = deriv_mod.edge_derivatives(
                    part, st, sc, (t * psc).to(st.device), eigen)
                df_tot = df_tot + df.to(t.device) * psc
                ddf_tot = ddf_tot + ddf.to(t.device) * psc * psc
            return df_tot, ddf_tot

        t_new = minimize_newton_multi(deriv, t0, min_brlen, max_brlen,
                                      tol=TRIPLET_TOL,
                                      max_iters=TRIPLET_ITERS)
        lnl = torch.zeros_like(t_new)
        for (part, psc, eigen, *_), st, sc in zip(sides, sts, scs):
            lnl = lnl + deriv_mod.edge_derivatives(
                part, st, sc, (t_new * psc).to(st.device), eigen)[0].to(
                    t_new.device)
        if which == 0:
            return (t_new, tx, ty), lnl
        if which == 1:
            return (ts, t_new, ty), lnl
        return (ts, tx, t_new), lnl

    t = (t_s, hl, hl)
    lnl = None
    for _cycle in range(2):
        for which in (0, 1, 2):
            t, lnl = coord_newton(t, which)
    return lnl, t[0], t[1], t[2]


def _score_regrafts_thorough_batch(partitions, part_scalers, ops_cat,
                                   brl_cat, clv_S_b, scaler_S_b, t_s_b,
                                   eref_w, wmask, halves_w, min_brlen,
                                   max_brlen, stride: int):
    """K-candidate thorough scoring at once: all candidates' remainder
    CLVs from the concatenated op table (as :func:`_score_regrafts_batch`,
    each partition's at its lengths ``brl_cat · scaler``), then the
    triplet Newton (:func:`_triplet_newton`) over candidates × window
    edges.

    Args:
      partitions / part_scalers: the partitions, or the shards of sharded
        ones, and their brlen scalers (SCALED mode; 1.0 otherwise); each
        one's subtree CLVs on its device
      ops_cat: int [K·n_ops_full, 5] concatenated remainder tables
      brl_cat: [K·E] per-candidate R branch lengths (P ids offset k·E)
      clv_S_b/scaler_S_b: per partition [K, C, S, P] / [K, P]
      t_s_b: [K]; eref_w: long [K, W, 2] window edge refs (slots offset
        k·stride); wmask: bool [K, W] live rows; halves_w: [K, W]
    Returns (lnl [K, W], ts [K, W], tx [K, W], ty [K, W]).
    """
    K, W = wmask.shape
    sides = []
    compiled: dict = {}     # the table, compiled once a dtype
    for part, psc, cS, sS in zip(partitions, part_scalers, clv_S_b,
                                 scaler_S_b):
        dtype = part.dtype
        first = compiled.get(dtype)
        if first is None:
            tables = compiled[dtype] = blo_mod.walk_tables(
                part, ops_cat, K * stride)
        else:
            tables = blo_mod.tables_for(first, part)
        clvs, scalers, gather = directed_clvs(part, tables, brl_cat * psc)
        eref = eref_w.to(part.device)
        A_x, sx = gather(part, clvs, scalers, eref[..., 0].reshape(-1))
        A_y, sy = gather(part, clvs, scalers, eref[..., 1].reshape(-1))
        del clvs, scalers
        shp = (K, W) + A_x.shape[1:]
        sides.append((part, psc, part.eigen(),
                       A_x.to(dtype).view(shp), sx.view(K, W, -1),
                       A_y.to(dtype).view(shp), sy.view(K, W, -1),
                       cS.to(dtype)[:, None], sS[:, None]))
    dtype = partitions[0].dtype
    t_s = t_s_b.to(dtype)[:, None].expand(K, W).contiguous()
    lnls, ts, tx, ty = _triplet_newton(sides, t_s, halves_w.to(dtype),
                                       min_brlen, max_brlen)
    return (torch.where(wmask, lnls, torch.full_like(lnls, -float("inf"))),
            ts, tx, ty)


# ---------------------------------------------------------------------------
# host side: candidates and their concatenated tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SprEntry:
    """bestnode toplist entry (algo_search.c:70-346)."""
    lnl: float
    prune_edge: int
    junction: int
    regraft_edge: int


def _prune_candidates(tree):
    """All (prune_edge, junction) pairs — every subtree that can be pruned
    (the reference queries all 3(n-2) inner subnodes,
    algo_search.c:1154-1169)."""
    out = []
    for e, (u, v) in enumerate(tree.edge_nodes):
        u, v = int(u), int(v)
        if u < 0:
            continue
        for junction in (u, v):
            if not tree.is_tip(junction):
                out.append((e, junction))
    return out


def _radius_mask(tree_R, a, b, radius_min, radius_max, n_edge_slots):
    """Edges of R whose BFS distance from the original location (the fused
    edge's endpoints a..b) lies within [radius_min, radius_max]
    (nodes_at_node_dist, utree_operations.c:389-503).

    Vectorized bounded edge-relaxation (radius_max+1 rounds of
    ``np.minimum.at`` over the live edge array finalize every node
    distance ≤ radius_max+1) instead of the python deque BFS — no
    adjacency build, O(radius · E) numpy."""
    en = tree_R.edge_nodes
    live = np.nonzero(en[:, 0] >= 0)[0]
    lu = en[live, 0].astype(np.int64)
    lv = en[live, 1].astype(np.int64)
    big = np.int64(1) << 40
    dist = np.full(tree_R.n_nodes, big, np.int64)
    dist[[a, b]] = 0
    for _ in range(radius_max + 1):
        du, dv = dist[lu], dist[lv]
        np.minimum.at(dist, lu, dv + 1)
        np.minimum.at(dist, lv, du + 1)
    # edge distance = max of endpoint distances: 0 ONLY for the fused
    # edge (the no-op reinsertion); edges incident to the prune spot
    # count as distance 1 (reference nodes_at_node_dist semantics)
    edge_dist = np.full(n_edge_slots, big, np.int64)
    edge_dist[live] = np.maximum(dist[lu], dist[lv])
    return (edge_dist >= radius_min) & (edge_dist <= radius_max)


def _build_candidate(tree, prune_edge, junction, radius_min, radius_max):
    """The host construction of one candidate: the remainder tree R
    (junction dissolved, subtree edges dropped), its radius window and
    directed traversal. Returns (bld, fused_e, freed_e), or None when
    the candidate has nothing to score."""
    n_edge_slots = len(tree.edge_nodes)
    u, v = (int(x) for x in tree.edge_nodes[prune_edge])
    sub_root = u if junction == v else v
    nbrs = [(n, e) for n, e in tree.neighbors(junction) if e != prune_edge]
    if len(nbrs) != 2:
        return None
    (a, _ea), (b, _eb) = nbrs
    sub_nodes = moves.subtree_nodes(tree, prune_edge, sub_root)

    # ---- remainder tree R: dissolve junction, drop subtree edges ----
    R = tree.copy()
    freed_e, fused_e = moves.prune(R, junction, keep_edge=prune_edge)
    R.edge_nodes[prune_edge] = (-1, -1)
    sub_arr = np.fromiter(sub_nodes, np.int64, len(sub_nodes))
    en = R.edge_nodes
    drop = ((en[:, 0] >= 0) & np.isin(en[:, 0], sub_arr)
            & np.isin(en[:, 1], sub_arr))
    en[drop] = -1
    R.invalidate()
    # vectorized root-tip search: first live tip outside the subtree
    has_edge = np.zeros(R.n_tips, bool)
    lv = en[en[:, 0] >= 0]
    has_edge[lv[lv[:, 0] < R.n_tips, 0]] = True
    has_edge[lv[lv[:, 1] < R.n_tips, 1]] = True
    has_edge[sub_arr[sub_arr < R.n_tips]] = False
    rt = np.nonzero(has_edge)[0]
    if len(rt) == 0:
        return None
    root_tip = int(rt[0])

    # radius window around the original location
    mask = _radius_mask(R, a, b, radius_min, radius_max, n_edge_slots)
    mask &= R.edge_nodes[:, 0] >= 0
    if not mask.any():
        return None
    trav_R = DirectedTraversal(R, root_tip=root_tip)
    mask = mask & trav_R.edge_mask
    if not mask.any():
        return None
    bld = dict(cand=(prune_edge, junction), prune_edge=prune_edge,
               junction=junction, a=a, b=b, R=R, mask=mask,
               trav_R=trav_R, sub_root=sub_root, sub_nodes=sub_nodes)
    return bld, fused_e, freed_e


def _offset_ops(tr, k, n_tips, stride, E):
    """Candidate k's remainder rows, slots offset k·stride, edge ids
    k·E."""
    ops_k = tr.ops.astype(np.int64).copy()
    ops_k[:, 0] += k * stride
    for col in (1, 3):
        inner = ops_k[:, col] >= n_tips
        ops_k[inner, col] += k * stride
    ops_k[:, 2] += k * E
    ops_k[:, 4] += k * E
    return ops_k


def _batch_tables(tree, builds, stride):
    """The fast scorer's host tables of ``builds`` (numpy): ops_cat,
    eref_cat, mask_b, brl_cat, half_cat, t_s_b."""
    n_tips = tree.n_tips
    n_ops_full = 3 * (n_tips - 2)
    E = len(tree.edge_nodes)
    K = len(builds)
    ops_cat = np.full((K * n_ops_full, 5), -1, np.int32)
    eref_cat = np.zeros((K * E, 2), np.int64)
    mask_b = np.zeros((K, E), bool)
    brl_cat = np.full(K * E, 0.1)
    half_cat = np.full(K * E, 0.05)
    t_s_b = np.zeros(K)
    for k, bld in enumerate(builds):
        tr = bld["trav_R"]
        ops_k = _offset_ops(tr, k, n_tips, stride, E)
        ops_cat[k * n_ops_full:k * n_ops_full + len(ops_k)] = ops_k
        er = tr.edge_ref.astype(np.int64).copy()
        er[er >= n_tips] += k * stride
        eref_cat[k * E:(k + 1) * E] = er
        mask_b[k] = bld["mask"]
        R = bld["R"]
        brl_cat[k * E:(k + 1) * E] = np.where(
            R.edge_nodes[:, 0] >= 0, R.lengths, 0.1)
        half_cat[k * E:(k + 1) * E] = R.lengths / 2.0
        t_s_b[k] = tree.lengths[bld["prune_edge"]]
    return dict(ops_cat=ops_cat, eref_cat=eref_cat, mask_b=mask_b,
                brl_cat=brl_cat, half_cat=half_cat, t_s_b=t_s_b)


def _thorough_tables(tree, builds, stride):
    """The thorough scorer's host tables of ``builds`` (numpy): ops_cat,
    brl_cat, t_s_b, the window lists ``w_lists`` and, padded to W rows
    (a power of two, at least 8), eref_w, wmask, halves_w."""
    n_tips = tree.n_tips
    n_ops_full = 3 * (n_tips - 2)
    E = len(tree.edge_nodes)
    K = len(builds)
    ops_cat = np.full((K * n_ops_full, 5), -1, np.int32)
    brl_cat = np.full(K * E, 0.1)
    t_s_b = np.zeros(K)
    w_lists = [np.nonzero(b["mask"])[0] for b in builds]
    W = max(8, 1 << int(max(len(w) for w in w_lists) - 1).bit_length())
    eref_w = np.zeros((K, W, 2), np.int64)
    wmask = np.zeros((K, W), bool)
    halves_w = np.full((K, W), 0.05)
    for k, bld in enumerate(builds):
        tr = bld["trav_R"]
        ops_k = _offset_ops(tr, k, n_tips, stride, E)
        ops_cat[k * n_ops_full:k * n_ops_full + len(ops_k)] = ops_k
        R = bld["R"]
        brl_cat[k * E:(k + 1) * E] = np.where(
            R.edge_nodes[:, 0] >= 0, R.lengths, 0.1)
        t_s_b[k] = tree.lengths[bld["prune_edge"]]
        w_np = w_lists[k]
        w_idx = np.concatenate(
            [w_np, np.full(W - len(w_np), w_np[0], np.int64)])
        er = tr.edge_ref.astype(np.int64)[w_idx].copy()
        er[er >= n_tips] += k * stride
        eref_w[k] = er
        wmask[k, :len(w_np)] = True
        halves_w[k] = R.lengths[w_idx] / 2.0
    return dict(ops_cat=ops_cat, brl_cat=brl_cat, t_s_b=t_s_b,
                w_lists=w_lists, eref_w=eref_w, wmask=wmask,
                halves_w=halves_w)


def _part_scalers(treeinfo, part_idx):
    if treeinfo.brlen_linkage == BRLEN_SCALED:
        return tuple(float(treeinfo.brlen_scalers[i]) for i in part_idx)
    return tuple(1.0 for _ in part_idx)


def _subtree_ref(tree, trav_full, bld):
    """Node reference of the pruned subtree's root CLV in the full-tree
    buffer (both engines keep DirectedTraversal's slot numbering)."""
    if tree.is_tip(bld["sub_root"]):
        return bld["sub_root"]
    return tree.n_tips + trav_full.slot_of[(bld["sub_root"],
                                            bld["junction"])]


def _score_builds(treeinfo, part_idx, trav_full, full_clvs, builds,
                  thorough: bool, stats=None):
    """Score ``builds`` in one batch against the full-tree directed CLVs
    ``full_clvs`` (per partition, the list of its shards' (clvs,
    scalers, gather) of ``trav_full``, :func:`_full_clvs`). Returns the
    per-candidate resolve() contexts in candidate order."""
    tree = treeinfo.tree
    stride = 3 * (tree.n_tips - 2) + 2
    K = len(builds)
    if stats is not None:
        stats["batches"] = stats.get("batches", 0) + 1
        stats["max_batch"] = max(stats.get("max_batch", 0), K)
        stats["candidates"] = stats.get("candidates", 0) + K
    parts = [treeinfo.partitions[i] for i in part_idx]
    tabs = (_thorough_tables if thorough else _batch_tables)(tree, builds,
                                                             stride)
    refs_np = np.asarray([_subtree_ref(tree, trav_full, bld)
                          for bld in builds], np.int64)
    # per partition, per shard: (shard, subtree CLVs, subtree scalers)
    units = []
    for i, part in zip(part_idx, parts):
        per = []
        for s, (clvs, scalers, gather) in zip(shards_of(part), full_clvs[i]):
            cS, sS = gather(s, clvs, scalers,
                            torch.as_tensor(refs_np, device=s.device))
            per.append((s, cS, sS))
        units.append(per)

    def dev(x, part, dtype=None):
        return torch.as_tensor(x, device=part.device,
                               dtype=part.dtype if dtype is None else dtype)

    if not thorough:
        score_parts = []
        compiled: dict = {}     # the K-candidate table, once a dtype
        for part, per in zip(parts, units):
            scores = []
            for s, cS, sS in per:
                first = compiled.get(s.dtype)
                if first is None:
                    wt = compiled[s.dtype] = blo_mod.walk_tables(
                        s, tabs["ops_cat"], K * stride)
                else:
                    wt = blo_mod.tables_for(first, s)
                scores.append(_score_regrafts_batch(
                    s, tabs["ops_cat"], dev(tabs["brl_cat"], s), cS, sS,
                    dev(tabs["t_s_b"], s),
                    dev(tabs["eref_cat"], s, torch.int64),
                    dev(tabs["mask_b"], s, torch.bool),
                    dev(tabs["half_cat"], s), stride, tables=wt))
            # the shards' scores reduced before the top list is chosen
            score_parts.append(
                reduce_shards(scores, part.device).cpu().numpy())
        return [dict(prune_edge=bld["prune_edge"],
                     junction=bld["junction"], a=bld["a"], b=bld["b"],
                     R=bld["R"], mask=bld["mask"],
                     score_parts=[sp[k] for sp in score_parts],
                     triplets_dev=None)
                for k, bld in enumerate(builds)]

    p0 = parts[0]
    pscs = _part_scalers(treeinfo, part_idx)
    flat = [(s, psc, cS, sS) for per, psc in zip(units, pscs)
            for s, cS, sS in per]
    lnls_w, ts_w, tx_w, ty_w = _score_regrafts_thorough_batch(
        [u[0] for u in flat], [u[1] for u in flat], tabs["ops_cat"],
        dev(tabs["brl_cat"], p0), [u[2] for u in flat],
        [u[3] for u in flat], dev(tabs["t_s_b"], p0),
        dev(tabs["eref_w"], p0, torch.int64),
        dev(tabs["wmask"], p0, torch.bool), dev(tabs["halves_w"], p0),
        1e-4, 100.0, stride)
    lnls_np, ts_np, tx_np, ty_np = (
        x.to(torch.float64).cpu().numpy()
        for x in (lnls_w, ts_w, tx_w, ty_w))    # one sync a batch
    w_lists = tabs["w_lists"]
    return [dict(prune_edge=bld["prune_edge"],
                 junction=bld["junction"], a=bld["a"], b=bld["b"],
                 R=bld["R"], mask=bld["mask"], w_idx=w_lists[k],
                 score_parts=[lnls_np[k]],
                 triplets_dev=(ts_np[k], tx_np[k], ty_np[k]))
            for k, bld in enumerate(builds)]


def score_candidates(treeinfo, cands, radius_min: int = 1,
                     radius_max: int = 10, thorough: bool = False):
    """Score the prune candidates ``cands`` ((prune_edge, junction)
    pairs) of ``treeinfo``'s tree as ONE batch, as a round's first batch
    would score them, without touching the tree. Returns, per candidate
    that has a window, (cand, scores float64 [E] summed over the
    partitions, −inf off the window) and in thorough mode also the
    triplets (ts, tx, ty), each [E]. A check of the scorers against
    another dtype or device, not a step of the search."""
    tree = treeinfo.tree
    part_idx = list(treeinfo.local_indices())
    for i in part_idx:
        if treeinfo.partitions[i].eigen_lam is None:
            treeinfo.partitions[i] = treeinfo.partitions[i].cache_eigen()
    builds = [b[0] for b in (_build_candidate(tree, e, j, radius_min,
                                              radius_max) for e, j in cands)
              if b is not None]
    trav = DirectedTraversal(tree)
    full = {i: _full_clvs(treeinfo.partitions[i],
                          treeinfo.partition_brlens(i), trav)
            for i in part_idx}
    ctxs = _score_builds(treeinfo, part_idx, trav, full, builds, thorough)
    E = len(tree.edge_nodes)
    out = []
    for ctx in ctxs:
        total = sum(np.asarray(s, np.float64) for s in ctx["score_parts"])
        w_np = ctx.get("w_idx")
        if w_np is None:
            out.append(((ctx["prune_edge"], ctx["junction"]), total))
            continue
        full_s = np.full(E, -np.inf)
        full_s[w_np] = total[:len(w_np)]
        trip = []
        for x in ctx["triplets_dev"]:
            t = np.full(E, 0.1)
            t[w_np] = x[:len(w_np)]
            trip.append(t)
        out.append(((ctx["prune_edge"], ctx["junction"]), full_s,
                    tuple(trip)))
    return out


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------
def spr_round(treeinfo, radius_min: int = 1, radius_max: int = 10,
              ntopol_keep: int = 20, thorough: bool = False,
              epsilon: float = 1e-6, blo_params: dict | None = None,
              subtree_cutoff: float = 0.0, constraint=None,
              cutoff_state: dict | None = None,
              stats: dict | None = None):
    """One SPR round over all prunable subtrees.

    Returns (best_lnl, n_applied, toplist) — treeinfo holds the best
    topology found (with optimized branch lengths).

    The reference's adaptive cutoff (cutoff_info_t,
    pllmod_algorithm.h:41-47) stops expanding the regraft-candidate BFS
    once the logL drop exceeds ``subtree_cutoff × mean drop``
    (algo_search.c:841-848). The batched scorer evaluates the whole
    radius window at once, so depth pruning saves nothing; instead the
    SAME statistic skips the whole PRUNE candidate when its
    previous-round drop exceeded the cutoff, and a skipped candidate is
    re-evaluated the following round (bounded staleness).
    ``subtree_cutoff=0`` disables, as in the reference.

    ``constraint`` (tree.constraint.Constraint) filters regraft
    candidates via the reference's SPR fast check
    (constraint_check_spr, algo_search.c:737).

    ``cutoff_state``: optional mutable dict ``{"sum": float, "n": int}``
    persisting the adaptive-cutoff statistics ACROSS rounds, the way
    RAxML-NG threads one ``cutoff_info_t`` through its whole search
    (pllmod_algorithm.h:41-47); omitted = per-round statistics.

    ``stats``: optional dict, filled with ``batches``, ``max_batch``
    (the largest K), ``candidates`` (scored), ``batch_limit`` and
    ``full_builds`` (full-tree directed-CLV builds).
    """
    tree = treeinfo.tree
    part_idx = list(treeinfo.local_indices())
    n_edge_slots = len(tree.edge_nodes)

    for i in part_idx:
        if treeinfo.partitions[i].eigen_lam is None:
            treeinfo.partitions[i] = treeinfo.partitions[i].cache_eigen()
    start_lnl = treeinfo.compute_loglh()
    best_lnl = start_lnl
    n_applied = 0
    toplist: list[SprEntry] = []
    if cutoff_state is None:
        cutoff_state = {"sum": 0.0, "n": 0}
    cutoff_state.setdefault("sum", 0.0)
    cutoff_state.setdefault("n", 0)
    cutoff_state.setdefault("drops", {})   # (prune_edge, junction) -> drop
    if stats is not None:
        stats.update(batches=0, max_batch=0, candidates=0, full_builds=0)

    # Full-tree directed CLVs with a VALIDITY protocol (the reference's
    # clv_valid bookkeeping, treeinfo.c:872-944, applied to the directed
    # buffer): an applied SPR only modifies the neighborhood of the old
    # and new attachment points, so it marks those nodes dirty instead of
    # discarding the buffers. A candidate's pruned-subtree CLV
    # (sub_root -> junction) is reusable iff its node set avoids every
    # dirty node — the moved subtree always travels with its junction, so
    # containing a relocated node implies containing a dirty one.
    trav_full = None
    full_clvs: dict[int, tuple] = {}
    dirty_nodes: set[int] = set()
    topo_state = {"bytes": None}   # host_build cache key, None = stale

    n_tips = tree.n_tips
    n_ops_full = 3 * (n_tips - 2)
    E = n_edge_slots
    stride = n_ops_full + 2     # per-candidate CLV-slot stride (batch)

    def host_build(prune_edge, junction):
        """Host-only candidate construction (staleness + cutoff checks,
        remainder tree, radius mask, directed traversal). No device
        work, no tree mutation; None = candidate skipped."""
        _t0 = time.perf_counter()
        try:
            return _host_build_inner(prune_edge, junction)
        finally:
            global HOST_BUILD_SECONDS
            HOST_BUILD_SECONDS += time.perf_counter() - _t0

    def _host_build_inner(prune_edge, junction):
        u, v = (int(x) for x in tree.edge_nodes[prune_edge])
        if u < 0 or junction not in (u, v):
            return None  # candidate went stale after an applied SPR
        if subtree_cutoff > 0 and cutoff_state["n"] > 5:
            # adaptive cutoff: skip a candidate whose previous-round drop
            # exceeded the running mean × factor; clear its record so it
            # is re-evaluated next round
            drop_prev = cutoff_state["drops"].get((prune_edge, junction))
            if drop_prev is not None and drop_prev > subtree_cutoff * (
                    cutoff_state["sum"] / cutoff_state["n"]):
                del cutoff_state["drops"][(prune_edge, junction)]
                cutoff_state["skipped"] = cutoff_state.get("skipped", 0) + 1
                return None
        if topo_state["bytes"] is None:
            topo_state["bytes"] = tree.edge_nodes.tobytes()
        ck = (topo_state["bytes"], prune_edge, junction, radius_min,
              radius_max)
        hit = _cache_get(ck)
        if hit is not None:
            if hit == "skip":
                return None
            bld, fused_e, freed_e = hit
            lens = tree.lengths.copy()
            lens[fused_e] = tree.lengths[fused_e] + tree.lengths[freed_e]
            bld["R"].lengths = lens
            return bld
        built = _build_candidate(tree, prune_edge, junction, radius_min,
                                 radius_max)
        if built is None:
            _cache_put(ck, "skip")
            return None
        _cache_put(ck, built)
        return built[0]

    def ensure_full_clvs(builds):
        """Full-tree directed CLVs for every build's pruned-subtree CLV,
        under the dirty-node validity protocol (see above): rebuild once
        iff any build's subtree touches a dirty node."""
        nonlocal trav_full
        need = trav_full is None or not FULL_CLV_REUSE
        if not need:
            for bld in builds:
                if (dirty_nodes & bld["sub_nodes"]) or (
                        not tree.is_tip(bld["sub_root"])
                        and (bld["sub_root"], bld["junction"])
                        not in trav_full.slot_of):
                    need = True
                    break
        if not need:
            return
        trav_full = DirectedTraversal(tree)
        full_clvs.clear()
        for i in part_idx:
            full_clvs[i] = _full_clvs(treeinfo.partitions[i],
                                      treeinfo.partition_brlens(i),
                                      trav_full)
        if stats is not None:
            stats["full_builds"] += 1
        dirty_nodes.clear()

    def dispatch(builds):
        ensure_full_clvs(builds)
        return _score_builds(treeinfo, part_idx, trav_full, full_clvs,
                             builds, thorough, stats)

    def resolve(ctx):
        """Sum the candidate's scores and decide (filter, apply-or-
        toplist). The only place the tree is mutated."""
        nonlocal best_lnl, n_applied
        prune_edge = ctx["prune_edge"]
        junction = ctx["junction"]
        a, b, R = ctx["a"], ctx["b"], ctx["R"]
        mask = ctx["mask"]
        total_scores = None
        for scores in ctx["score_parts"]:
            sarr = np.array(scores, np.float64)
            total_scores = sarr if total_scores is None \
                else total_scores + sarr
        w_np = ctx.get("w_idx")
        if w_np is not None:      # windowed thorough scores: scatter
            full = np.full(n_edge_slots, -np.inf)
            full[w_np] = total_scores[:len(w_np)]
            total_scores = full
        triplets = None
        if ctx["triplets_dev"] is not None:
            ts, tx, ty = (np.array(t, np.float64)
                          for t in ctx["triplets_dev"])
            if w_np is not None:
                def _scat(x):
                    out = np.full(n_edge_slots, 0.1)
                    out[w_np] = x[:len(w_np)]
                    return out
                ts, tx, ty = _scat(ts), _scat(tx), _scat(ty)
            triplets = (ts, tx, ty)
        total_scores[~mask] = -np.inf
        u, v = (int(x) for x in tree.edge_nodes[prune_edge])
        sub_root = u if junction == v else v
        if constraint is not None and constraint.subtree_affected(
                tree, prune_edge, sub_root):
            # drop candidates that would violate the constraint, best-first
            for e_cand in np.argsort(-total_scores):
                if not np.isfinite(total_scores[e_cand]):
                    break
                if constraint.check_spr(tree, prune_edge, junction,
                                        int(e_cand)):
                    break  # best remaining candidate is valid
                total_scores[e_cand] = -np.inf
        best_edge = int(np.argmax(total_scores))
        cand_lnl = float(total_scores[best_edge])

        while cand_lnl > best_lnl + epsilon:
            x_node = int(R.edge_nodes[best_edge, 0])
            y_node = int(R.edge_nodes[best_edge, 1])
            if constraint is not None:
                # fast pre-check for re-picked candidates (the best one
                # already passed in the filter above; re-checking is cheap)
                if not constraint.check_spr(tree, prune_edge, junction,
                                            best_edge):
                    total_scores[best_edge] = -np.inf
                    best_edge = int(np.argmax(total_scores))
                    cand_lnl = float(total_scores[best_edge])
                    continue
                snap = tree.snapshot()
            # apply the SPR on the real tree
            moves.spr(tree, prune_edge, best_edge, junction=junction)
            if constraint is not None and not constraint.check_tree(tree):
                # the fast check is a heuristic (path-edge splits also
                # change); the full check is the guarantee — roll back and
                # try the next-best candidate (the reference instead FAILS
                # the whole round here, algo_search.c:1458-1468)
                tree.restore(snap)
                total_scores[best_edge] = -np.inf
                best_edge = int(np.argmax(total_scores))
                cand_lnl = float(total_scores[best_edge])
                continue
            # validity protocol: only the old (a—junction—b) and new
            # (x—junction—y) attachment neighborhoods changed
            dirty_nodes.update((junction, a, b, x_node, y_node))
            topo_state["bytes"] = None    # topology changed
            if triplets is not None:
                # write optimized attachment lengths (reference saves &
                # applies the best triplet, algo_search.c:809-819)
                ts, tx, ty = triplets
                tree.lengths[prune_edge] = float(ts[best_edge])
                tree.lengths[best_edge] = float(tx[best_edge])
                e_y = tree.edge_between(junction, y_node)
                if e_y is not None:
                    tree.lengths[e_y] = float(ty[best_edge])
            treeinfo.tree.invalidate()
            best_lnl = cand_lnl
            n_applied += 1
            return True
        if not np.isfinite(cand_lnl):
            return False   # every candidate was masked (constraint)
        drop = best_lnl - cand_lnl
        cutoff_state["sum"] += drop
        cutoff_state["n"] += 1
        cutoff_state["drops"][(prune_edge, junction)] = drop
        toplist.append(SprEntry(cand_lnl, prune_edge, junction,
                                best_edge))
        toplist.sort(key=lambda t: -t.lnl)
        del toplist[ntopol_keep:]
        return False

    # ---- adaptively BATCHED candidate driver ----------------------------
    # Serial-equivalent by construction: candidates resolve in candidate
    # order against exactly the tree state a serial loop would see. In
    # the steady state of a converging search (few applies) the batch
    # grows geometrically; an applied move makes the REST of the batch
    # stale — those candidates are requeued and re-scored against the
    # post-apply tree, and the batch resets to 1.
    batch_max = _spr_batch_limit(treeinfo, E, stride, thorough)
    if stats is not None:
        stats["batch_limit"] = batch_max
    cand_iter = iter(_prune_candidates(tree))
    batch_size = 1
    while True:
        builds = []
        while len(builds) < batch_size:
            nxt = next(cand_iter, None)
            if nxt is None:
                break
            bld = host_build(*nxt)
            if bld is not None:
                builds.append(bld)
        if not builds:
            break
        ctxs = dispatch(builds)
        applied_at = None
        for j, ctx in enumerate(ctxs):
            if resolve(ctx):
                applied_at = j
                break
        if applied_at is not None:
            if applied_at + 1 < len(builds):
                cand_iter = chain(
                    [b["cand"] for b in builds[applied_at + 1:]],
                    cand_iter)
            batch_size = 1
        else:
            batch_size = min(batch_size * 2, batch_max)

    # full branch-length optimization (algo_search.c:1232)
    final_lnl = optimize_branch_lengths_treeinfo(
        treeinfo, **(blo_params or {}))

    # re-evaluate the toplist: apply each saved candidate move with BLO and
    # keep the best topology seen (algo_search.c:1271-1418)
    if toplist:
        best_topo = treeinfo.get_topology()
        best_final = final_lnl
        for entry in toplist:
            u, v = (int(x) for x in tree.edge_nodes[entry.prune_edge])
            if u < 0 or entry.junction not in (u, v):
                continue  # stale after applied SPRs
            if tree.edge_nodes[entry.regraft_edge, 0] < 0:
                continue
            snap = treeinfo.get_topology()
            try:
                moves.spr(tree, entry.prune_edge, entry.regraft_edge,
                          junction=entry.junction)
            except Exception:
                continue
            if constraint is not None and not constraint.check_tree(tree):
                treeinfo.set_topology(snap)
                continue
            treeinfo.tree.invalidate()
            lnl_try = optimize_branch_lengths_treeinfo(
                treeinfo, max_sweeps=8, tolerance=1e-3)
            if lnl_try > best_final + epsilon:
                best_final = lnl_try
                best_topo = treeinfo.get_topology()
                n_applied += 1
            treeinfo.set_topology(snap)
        treeinfo.set_topology(best_topo)
        if best_final > final_lnl:
            final_lnl = optimize_branch_lengths_treeinfo(
                treeinfo, **(blo_params or {}))
    # consistency: final logL must not be (much) worse than tracked best
    # (reference asserts |logL − best| < 1e-6 after restoring best topology)
    return final_lnl, n_applied, toplist
