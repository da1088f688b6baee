"""The program's partition built from text: the simulated states written
as the alignment's characters and read by ``create_partition(...,
compress=True)``, the port's path from an MSA (encode, compress,
tables, upload)."""

from __future__ import annotations

import numpy as np
import torch

from phylobench.data import Loaded, Stopwatch, draw
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree


def build(config: dict, seed: int, device) -> Loaded:
    clock = Stopwatch()
    edges, lengths, rooted, model, tips = draw(config, seed, device)
    clock("draw_s")
    host = tips.cpu()
    del tips
    letters = np.frombuffer(config["alphabet"].encode("ascii"), np.uint8)
    seqs = [row.tobytes().decode("ascii")
            for row in letters[host.numpy()]]
    n = int(config["n_taxa"])
    part = create_partition(
        seqs, states=int(config["states"]),
        n_rate_cats=len(model["rate_cats"]), alpha=model["alpha"],
        subst_rates=model["subst_rates"], freqs=model["freqs"],
        compress=True, dtype=torch.float32, device=device).cache_eigen()
    clock("partition_s")
    tree = Tree(n, [f"t{i}" for i in range(n)], edges, lengths,
                n_nodes=2 * n - 2)
    n_patterns = len(np.unique(host.numpy().T, axis=0))
    shape = dict(n_tips=n, n_patterns=n_patterns,
                 C=len(model["rate_cats"]), S=int(config["states"]),
                 n_codes=part.code_clv.shape[0])
    return Loaded(config, edges, lengths, rooted, model, host, shape, part,
                  tree, clock.stages)
