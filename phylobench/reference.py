"""The plain reference: Felsenstein's pruning in plain PyTorch, float64 by
default, over the benchmark's own tree, model and tip states.

It imports nothing of the program and takes nothing the program made:
P(t) is ``torch.linalg.matrix_exp`` of the benchmark's Q
(:func:`phylobench.model.build_q`), the CLVs are one-hot tip states
pruned level by level (every CLV rescaled to a maximum of 1 a site, its
logarithm carried beside it), and the branch-length optimum is found by
its own Newton iterations on its own edge sums.

``dtype=torch.float32, tf32=True`` is the control of every cell: the
same arithmetic in float32 with every contraction's operands rounded to
TF32 (10 mantissa bits, as the tensor cores read them), the precision
just below the configuration's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phylobench.model import Rooted, build_q

# bytes of the per-node CLVs of one block of sites, and of one level's
# temporaries
_BLOCK_BYTES = 16 << 30
_LEVEL_BYTES = 1 << 30
# sweeps of the reference's optimizer before it stops unconverged
MAX_SWEEPS = 64


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def rel_gap(got: float, want: float) -> float:
    """|got − want| / |want|; infinite where either is not finite."""
    gap = abs(got - want) / abs(want)
    return gap if math.isfinite(gap) else math.inf


def worst(gaps) -> float:
    """The largest gap (0 of none); infinite where any is not finite."""
    out = 0.0
    for g in gaps:
        out = g if not math.isfinite(g) or g > out else out
        if not math.isfinite(out):
            return math.inf
    return out


def edge_colors(rooted: Rooted, n_edges: int) -> list[np.ndarray]:
    """Three classes of edges, no two edges of a class sharing a node."""
    color = np.full(n_edges, -1, np.int64)
    for i, (_, e) in enumerate(rooted.children[rooted.root]):
        color[e] = i
    for nodes, parents, pedges in rooted.down_levels:
        for v in nodes.tolist():
            if v in rooted.children:
                free = [c for c in range(3) if c != color[rooted.pedge[v]]]
                for (_, e), c in zip(rooted.children[v], free):
                    color[e] = c
    return [np.nonzero(color == c)[0] for c in range(3)]


class Reference:
    """The likelihood of the tips ``tips`` (uint8 [n_tips, sites] state
    indices, on ``device``) on the tree ``rooted`` under ``model`` (the
    float64 arrays of :func:`phylobench.model.model_arrays`)."""

    def __init__(self, rooted: Rooted, model: dict, tips: torch.Tensor,
                 dtype=torch.float64, tf32: bool = False):
        self.r, self.tips, self.dtype, self.tf32 = rooted, tips, dtype, tf32
        dev = self.device = tips.device
        self.Q = build_q(model["subst_rates"], model["freqs"]).to(dev)
        self.pi = torch.as_tensor(model["freqs"], dtype=torch.float64,
                                  device=dev)
        self.cats = torch.as_tensor(model["rate_cats"], dtype=torch.float64,
                                    device=dev)
        self.cw = torch.as_tensor(model["rate_weights"], dtype=torch.float64,
                                  device=dev)
        self.S, self.C = self.pi.shape[0], self.cats.shape[0]
        self.n_sites = tips.shape[1]
        self.n_edges = 2 * rooted.n_tips - 3
        # Q = Π^-1/2 U Λ U^T Π^1/2 for the edge sums of the optimizer
        sq = self.pi.sqrt()
        lam, U = torch.linalg.eigh(sq[:, None] * self.Q / sq[None, :])
        self.lam, self.U, self.sqpi = lam, U, sq
        self._plans = {}

    # -- arithmetic in the reference's precision ---------------------------
    def _t(self, x):
        return x.to(self.dtype)

    def _mm(self, x):
        """An operand of a contraction."""
        x = self._t(x)
        return round_tf32(x) if self.tf32 else x

    def pmats(self, lengths) -> torch.Tensor:
        """P(t_e·r_c) [E, C, S, S] in the reference's precision."""
        t = torch.as_tensor(lengths, dtype=torch.float64,
                            device=self.device)
        A = self._t(self.Q * (t[:, None] * self.cats[None, :])
                    [..., None, None])
        return torch.linalg.matrix_exp(A)

    def _blocks(self, n_nodes: int):
        per_site = n_nodes * self.C * self.S * 8
        step = max(1, min(self.n_sites, _BLOCK_BYTES // max(per_site, 1)))
        return [(lo, min(lo + step, self.n_sites))
                for lo in range(0, self.n_sites, step)]

    def _step(self, B: int) -> int:
        """Nodes of a level handled at once, for blocks of B sites."""
        return max(1, _LEVEL_BYTES // (B * self.C * self.S * 8 * 4))

    def _chunks(self, k: int, B: int):
        step = self._step(B)
        return [slice(lo, min(lo + step, k)) for lo in range(0, k, step)]

    def _side(self, child, edge):
        """The device index tensors of (child, edge) pairs: the positions,
        tips and edges of the tip children, and the positions, CLV rows
        and edges of the inner ones (built once, reused by every block)."""
        dev, n_tips = self.device, self.r.n_tips
        is_tip = child < n_tips

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)
        return (len(child),
                (t(np.nonzero(is_tip)[0]), t(child[is_tip]), t(edge[is_tip]))
                if is_tip.any() else None,
                (t(np.nonzero(~is_tip)[0]), t(child[~is_tip] - n_tips),
                 t(edge[~is_tip])) if not is_tip.all() else None)

    def _up_plan(self, B: int):
        """Per chunk of every up level: (CLV rows written, side 1, side 2),
        for blocks of B sites."""
        key = ("up", self._step(B))
        if key not in self._plans:
            n_tips = self.r.n_tips
            self._plans[key] = [
                (torch.as_tensor(nodes[sl] - n_tips, device=self.device),
                 self._side(c1[sl], e1[sl]), self._side(c2[sl], e2[sl]))
                for nodes, c1, e1, c2, e2 in self.r.up_levels
                for sl in self._chunks(len(nodes), B)]
        return self._plans[key]

    def _msg(self, P, tipsb, clv, lsc, side):
        """The messages P_e · x_child [k, C, B, S] and their log scales
        [k, B] of a side (:meth:`_side`)."""
        k, tips, inner = side
        dev, B = self.device, tipsb.shape[1]
        out = torch.empty((k, self.C, B, self.S), dtype=self.dtype,
                          device=dev)
        sc = torch.zeros((k, B), dtype=self.dtype, device=dev)
        if tips is not None:
            pos, child, edge = tips
            PT = self._mm(P[edge]).transpose(2, 3)         # [k, c, j, i]
            kt = torch.arange(len(pos), device=dev)[:, None, None]
            ct = torch.arange(self.C, device=dev)[None, :, None]
            out[pos] = PT[kt, ct, tipsb[child][:, None, :]]
        if inner is not None:
            pos, idx, edge = inner
            out[pos] = torch.matmul(self._mm(clv[idx]),
                                    self._mm(P[edge]).transpose(2, 3))
            sc[pos] = lsc[idx]
        return out, sc

    @staticmethod
    def _rescale(x, ls):
        """x [..., C, B, S] over its maximum a site, the log added to ls."""
        mx = x.amax(dim=(-1, -3))
        return x / mx.unsqueeze(-1).unsqueeze(-3), ls + torch.log(mx)

    def _up(self, P, lo, hi):
        """The CLVs [n_inner, C, B, S] and log scales of every inner node
        but the root over sites lo:hi, and the root's."""
        r, n_tips = self.r, self.r.n_tips
        B = hi - lo
        tipsb = self.tips[:, lo:hi].long()
        n_inner = r.n_nodes - n_tips
        clv = torch.empty((n_inner, self.C, B, self.S), dtype=self.dtype,
                          device=self.device)
        lsc = torch.zeros((n_inner, B), dtype=self.dtype, device=self.device)
        for idx, side1, side2 in self._up_plan(B):
            m1, s1 = self._msg(P, tipsb, clv, lsc, side1)
            m2, s2 = self._msg(P, tipsb, clv, lsc, side2)
            clv[idx], lsc[idx] = self._rescale(m1 * m2, s1 + s2)
        kids = np.array(r.children[r.root], np.int64)
        m, s = self._msg(P, tipsb, clv, lsc,
                         self._side(kids[:, 0], kids[:, 1]))
        root, rls = self._rescale(m[0] * m[1] * m[2], s.sum(0))
        return tipsb, clv, lsc, root, rls

    def _site_lnl(self, x, ls):
        """log Σ_c w_c Σ_i π_i x_ci + ls, a site (x [C, B, S])."""
        per_cat = (x * self._t(self.pi)).sum(-1)                 # [C, B]
        return torch.log(self._t(self.cw) @ per_cat) + ls

    def loglik(self, lengths) -> float:
        """Σ over sites of the log-likelihood at ``lengths`` [E]."""
        P = self.pmats(lengths)
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for lo, hi in self._blocks(self.r.n_nodes - self.r.n_tips):
            _, _, _, root, rls = self._up(P, lo, hi)
            total = total + self._site_lnl(root, rls).sum()
        return float(total)

    # -- branch lengths -----------------------------------------------------
    def _edge_sums(self, P, edges):
        """For each edge of ``edges``: the per-site sums T [k, C, sites, S]
        with ℓ_site(t) = Σ_ck T e^{λ_k r_c t}, and the sites' log
        scales [k, sites]. All sites in one block (the BLO cell's fit)."""
        r, n_tips = self.r, self.r.n_tips
        tipsb, clv, lsc, _, _ = self._up(P, 0, self.n_sites)
        B = self.n_sites
        # D[v]: the CLV at v's parent from everything but v's subtree
        D = torch.empty((r.n_nodes, self.C, B, self.S), dtype=self.dtype,
                        device=self.device)
        Dls = torch.zeros((r.n_nodes, B), dtype=self.dtype,
                          device=self.device)
        kids = r.children[r.root]
        rm = [self._msg(P, tipsb, clv, lsc,
                        self._side(np.array([c]), np.array([e])))
              for c, e in kids]
        for i, (c, _) in enumerate(kids):
            o = [rm[j] for j in range(3) if j != i]
            D[c], Dls[c] = self._rescale(o[0][0][0] * o[1][0][0],
                                         o[0][1][0] + o[1][1][0])
        for nodes, parents, pedges in r.down_levels[1:]:
            for sl in self._chunks(len(nodes), B):
                nd, par = nodes[sl], parents[sl]
                sib = np.array([[c for c, _ in r.children[p] if c != v][0]
                                for v, p in zip(nd.tolist(), par.tolist())],
                               np.int64)
                ms, ss = self._msg(P, tipsb, clv, lsc,
                                   self._side(sib, r.pedge[sib]))
                pt = torch.as_tensor(par, device=self.device)
                Pp = self._mm(P[torch.as_tensor(r.pedge[par],
                                                device=self.device)])
                md = torch.matmul(self._mm(D[pt]), Pp.transpose(2, 3))
                idx = torch.as_tensor(nd, device=self.device)
                D[idx], Dls[idx] = self._rescale(ms * md, ss + Dls[pt])
        # the node below each edge
        below = np.empty(self.n_edges, np.int64)
        nodes = np.arange(r.n_nodes)
        below[r.pedge[nodes[r.pedge >= 0]]] = nodes[r.pedge >= 0]
        v = below[edges]
        vt = torch.as_tensor(v, device=self.device)
        U, sq = self._mm(self.U), self._t(self.sqpi)
        F = torch.matmul(self._mm(D[vt] * sq), U)             # [k, C, B, S]
        G = torch.empty_like(F)
        ls = Dls[vt].clone()
        is_tip = v < n_tips
        if is_tip.any():
            pos = torch.as_tensor(np.nonzero(is_tip)[0], device=self.device)
            s = tipsb[torch.as_tensor(v[is_tip], device=self.device)]
            G[pos] = (sq[:, None] * U)[s][:, None].expand(-1, self.C, -1, -1)
        if not is_tip.all():
            pos = torch.as_tensor(np.nonzero(~is_tip)[0], device=self.device)
            idx = torch.as_tensor(v[~is_tip] - n_tips, device=self.device)
            G[pos] = torch.matmul(self._mm(clv[idx] * sq), U)
            ls[pos] = ls[pos] + lsc[idx]
        return F * G * self._t(self.cw)[:, None, None], ls

    def _edge_fn(self, T, ls, t):
        """(lnL, first, second derivative) [k] of each edge at lengths t."""
        rate = self._t(self.lam[None, :] * self.cats[:, None])   # [C, S]
        e = torch.exp(rate[None] * t[:, None, None])[:, :, None]  # [k,C,1,S]
        r = rate[None, :, None]
        l0 = (T * e).sum((1, 3))
        l1 = (T * (e * r)).sum((1, 3))
        l2 = (T * (e * r * r)).sum((1, 3))
        d1 = l1 / l0
        return ((torch.log(l0) + ls).sum(1), d1.sum(1),
                (l2 / l0 - d1 * d1).sum(1))

    def optimize(self, lengths, min_len: float, max_len: float,
                 tol: float):
        """Branch lengths that maximize the logL, from ``lengths``: sweeps
        over the three edge colors, each edge of a color by its own
        Newton iterations on its edge sums, until a sweep gains less than
        ``tol``. Returns (lengths float64 numpy, logL, sweeps)."""
        t_all = torch.as_tensor(np.clip(lengths, min_len, max_len),
                                dtype=self.dtype, device=self.device)
        colors = edge_colors(self.r, self.n_edges)
        lnl = self.loglik(t_all)
        for sweeps in range(1, MAX_SWEEPS + 1):
            for cls in colors:
                T, ls = self._edge_sums(self.pmats(t_all), cls)
                ci = torch.as_tensor(cls, device=self.device)
                t = t_all[ci]
                f, d1, d2 = self._edge_fn(T, ls, t)
                for _ in range(30):
                    step = torch.where(d2 < 0, -d1 / d2,
                                       torch.where(d1 > 0, t, -0.5 * t))
                    t_new = (t + step).clamp(min_len, max_len)
                    for _ in range(8):
                        f_new, d1n, d2n = self._edge_fn(T, ls, t_new)
                        worse = f_new < f - 1e-12 * f.abs()
                        if not worse.any():
                            break
                        t_new = torch.where(worse, 0.5 * (t + t_new), t_new)
                    keep = ~worse
                    moved = float(((t_new - t) * keep).abs().max())
                    t = torch.where(keep, t_new, t)
                    f = torch.where(keep, f_new, f)
                    d1 = torch.where(keep, d1n, d1)
                    d2 = torch.where(keep, d2n, d2)
                    if moved < 1e-10:
                        break
                t_all[ci] = t
            new = self.loglik(t_all)
            gain, lnl = new - lnl, new
            if gain < tol:
                break
        return t_all.double().cpu().numpy(), lnl, sweeps
