"""EM algorithm for free-rate mixture weights (Wang et al. 2008) —
counterpart of ``pllmod_tpu.optimize.em`` (``pllmod_algo_opt_rates_weights``'s
EM core, opt_algorithms.c:1473-1546): given per-site per-category
likelihoods, iterate posterior responsibilities (E) and weight
re-estimation (M) until the weights stabilize, one [patterns, cats]
product an iteration, on the tensors' device (``opt_model`` passes the
E-step's likelihoods as float64 on the host).
"""

from __future__ import annotations

import torch


def em_rates_weights(site_cat_lh, pattern_weights, weights0,
                     max_iters: int = 100, tol: float = 1e-8,
                     min_weight: float = 1e-7):
    """EM update of category weights.

    Args:
      site_cat_lh: [P, C] per-site per-category likelihoods (any common
        per-site scaling cancels in the posterior)
      pattern_weights: [P]
      weights0: [C] starting weights (sum 1)
    Returns:
      weights [C] (the dtype and device of ``site_cat_lh``)
    """
    L = torch.as_tensor(site_cat_lh)
    pw = torch.as_tensor(pattern_weights).to(L.device, L.dtype)
    w = torch.as_tensor(weights0).to(L.device, L.dtype)
    W = pw.sum()
    for _ in range(max_iters):
        mix = L * w[None, :]                               # [P, C]
        denom = torch.clamp(mix.sum(dim=1, keepdim=True), min=1e-300)
        w_new = (pw @ (mix / denom)) / W                   # responsibilities
        w_new = torch.clamp(w_new, min=min_weight)
        w_new = w_new / w_new.sum()
        delta = float((w_new - w).abs().max())
        w = w_new
        if not delta > tol:
            break
    return w
