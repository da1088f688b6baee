"""EM algorithm for free-rate mixture weights (Wang et al. 2008) —
counterpart of ``pllmod_tpu.optimize.em`` (``pllmod_algo_opt_rates_weights``'s
EM core, opt_algorithms.c:1473-1546): given per-site per-category
likelihoods, iterate posterior responsibilities (E) and weight
re-estimation (M) until the weights stabilize, one [patterns, cats]
product an iteration, on the tensors' device (``opt_model`` passes the
E-step's likelihoods as float64 on the host). Under a site mesh the
likelihoods come in the shards' pattern blocks, and the per-category
sums of every iteration are reduced over the blocks in shard order.
"""

from __future__ import annotations

import torch


def em_rates_weights(site_cat_lh, pattern_weights, weights0,
                     max_iters: int = 100, tol: float = 1e-8,
                     min_weight: float = 1e-7):
    """EM update of category weights.

    Args:
      site_cat_lh: [P, C] per-site per-category likelihoods (any common
        per-site scaling cancels in the posterior), or a list of the
        shards' blocks [P_k, C]
      pattern_weights: [P], or a list of the shards' blocks [P_k]
      weights0: [C] starting weights (sum 1)
    Returns:
      weights [C] (the dtype and device of ``site_cat_lh``'s first block)
    """
    if not isinstance(site_cat_lh, (list, tuple)):
        site_cat_lh, pattern_weights = [site_cat_lh], [pattern_weights]
    Ls = [torch.as_tensor(x) for x in site_cat_lh]
    L0 = Ls[0]
    pws = [torch.as_tensor(pw).to(L.device, L.dtype)
           for pw, L in zip(pattern_weights, Ls)]
    w = torch.as_tensor(weights0).to(L0.device, L0.dtype)
    W = sum(pw.sum().to(L0.device) for pw in pws)

    def resp(L, pw, w):
        mix = L * w[None, :]                               # [P, C]
        denom = torch.clamp(mix.sum(dim=1, keepdim=True), min=1e-300)
        return pw @ (mix / denom)

    for _ in range(max_iters):
        # responsibilities, summed over the shards' blocks in order
        num = resp(Ls[0], pws[0], w)
        for L, pw in zip(Ls[1:], pws[1:]):
            num = num + resp(L, pw, w.to(L.device)).to(L0.device)
        w_new = num / W
        w_new = torch.clamp(w_new, min=min_weight)
        w_new = w_new / w_new.sum()
        delta = float((w_new - w).abs().max())
        w = w_new
        if not delta > tol:
            break
    return w
