"""Sites simulated along a tree on the card: the recipe of the port's
``flagship.simulate`` (a Γ category and a root state a site, then down
every edge a child state drawn from its parent's row of
P(t·r_c) = exp(Q·t·r_c)), rewritten to draw a whole level of the tree
at once from a ``torch.Generator`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from phylobench.model import Rooted, build_q

# bytes of float64 row draws held at once while a level is drawn
_LEVEL_BYTES = 512 << 20


def simulate(rooted: Rooted, lengths, model: dict, n_sites: int,
             gen: torch.Generator, device) -> torch.Tensor:
    """Tip states uint8 [n_tips, n_sites] (state indices 0..S−1) on
    ``device``, every draw from ``gen``. The root (inner node n_tips)
    draws its states from π; each node below draws from its parent's
    row. Inner states are dropped once the level below has read them."""
    Q = build_q(model["subst_rates"], model["freqs"]).to(device)
    S = Q.shape[0]
    cats = torch.as_tensor(model["rate_cats"], dtype=torch.float64,
                           device=device)
    C = cats.shape[0]
    t = torch.as_tensor(np.asarray(lengths), dtype=torch.float64,
                        device=device)
    # cumulative rows [E, C·S, S] of every edge's P matrices
    cum = torch.linalg.matrix_exp(
        Q * (t[:, None] * cats[None, :])[..., None, None]).cumsum(-1)
    cum = cum.reshape(len(t), C * S, S)
    site_cat = torch.randint(0, C, (n_sites,), generator=gen, device=device)
    pi_cum = torch.as_tensor(np.cumsum(model["freqs"]), dtype=torch.float64,
                             device=device)
    u = torch.rand(n_sites, dtype=torch.float64, generator=gen,
                   device=device)
    root_states = (u[:, None] > pi_cum[None, :]).sum(1).clamp_max(S - 1)
    states = {rooted.root: root_states.to(torch.uint8)}
    tips = torch.empty((rooted.n_tips, n_sites), dtype=torch.uint8,
                       device=device)
    row_base = site_cat * S
    chunk = max(1, _LEVEL_BYTES // (n_sites * S * 8))
    for nodes, parents, pedges in rooted.down_levels:
        for lo in range(0, len(nodes), chunk):
            nd = nodes[lo:lo + chunk]
            par = torch.stack([states[p] for p in parents[lo:lo + chunk]
                               .tolist()])
            e = torch.as_tensor(pedges[lo:lo + chunk], device=device)
            rows = cum[e[:, None], row_base[None, :] + par.long()]
            u = torch.rand(len(nd), n_sites, dtype=torch.float64,
                           generator=gen, device=device)
            drawn = (u[..., None] > rows).sum(-1).clamp_max(S - 1) \
                .to(torch.uint8)
            is_tip = nd < rooted.n_tips
            if is_tip.any():
                tips[torch.as_tensor(nd[is_tip], device=device)] = \
                    drawn[torch.as_tensor(is_tip, device=device)]
            for i in np.nonzero(~is_tip)[0].tolist():
                states[int(nd[i])] = drawn[i]
        # a level's parents are read only by that level
        for p in set(parents.tolist()):
            states.pop(p, None)
    return tips
