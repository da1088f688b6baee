"""The program's partition handed over as arrays
(``convert.partition_from_arrays``), the path by which a checkpointed or
pre-parsed alignment loads: the sites as patterns of weight 1, the tip
codes built from the simulated states on the device."""

from __future__ import annotations

import numpy as np
import torch

from phylobench.data import Loaded, Stopwatch, draw
from pllmod_tpu_torch import convert
from pllmod_tpu_torch.common import GAMMA_RATES_MEAN
from pllmod_tpu_torch.tree.topology import Tree

PATTERN_PAD = 128


def arrays(tips: torch.Tensor, model: dict, dtype=np.float32):
    """(arrays, meta) of ``partition_from_arrays`` for the states ``tips``
    (uint8 [n_tips, n_sites] on the device): code 0 the gap, code s+1
    state s, every site a pattern of weight 1, the pattern axis padded
    to a multiple of PATTERN_PAD with gaps of weight 0."""
    n, sites = tips.shape
    S = len(model["freqs"])
    C = len(model["rate_cats"])
    pad = -(-sites // PATTERN_PAD) * PATTERN_PAD
    codes = torch.zeros((n, pad), dtype=torch.int32, device=tips.device)
    codes[:, :sites].copy_(tips)
    codes[:, :sites] += 1
    same = (tips == tips[:1]).all(0)
    inv = torch.zeros((pad, S), dtype=torch.float32, device=tips.device)
    cols = torch.nonzero(same)[:, 0]
    inv[cols, tips[0, cols].long()] = 1.0
    code_clv = np.concatenate([np.ones((1, S)), np.eye(S)])
    weights = np.zeros(pad)
    weights[:sites] = 1.0
    out = dict(
        tip_states=codes.cpu().numpy(),
        code_clv=code_clv.astype(dtype),
        pattern_weights=weights.astype(dtype),
        inv_indicator=inv.cpu().numpy().astype(dtype),
        subst_rates=model["subst_rates"][None, :].astype(dtype),
        freqs=model["freqs"][None, :].astype(dtype),
        rate_cats=model["rate_cats"].astype(dtype),
        rate_weights=model["rate_weights"].astype(dtype),
        prop_invar=np.zeros(1, dtype),
        alpha=np.asarray(model["alpha"], dtype),
        param_indices=np.zeros(C, np.int64))
    meta = dict(n_tips=n, states=S, n_patterns=sites,
                gamma_mode=GAMMA_RATES_MEAN, reversible=True)
    return out, meta


def build(config: dict, seed: int, device) -> Loaded:
    clock = Stopwatch()
    edges, lengths, rooted, model, tips = draw(config, seed, device)
    clock("draw_s")
    arr, meta = arrays(tips, model)
    host = tips.cpu()
    del tips
    clock("arrays_s")
    n = int(config["n_taxa"])
    part = convert.partition_from_arrays(arr, meta, device).cache_eigen()
    del arr
    clock("partition_s")
    tree = Tree(n, [f"t{i}" for i in range(n)], edges, lengths,
                n_nodes=2 * n - 2)
    shape = dict(n_tips=n, n_patterns=meta["n_patterns"],
                 C=len(model["rate_cats"]), S=meta["states"],
                 n_codes=part.code_clv.shape[0])
    return Loaded(config, edges, lengths, rooted, model, host, shape, part,
                  tree, clock.stages)
