"""Protein mixture-model demo: the full 37-model registry, LG4X free-rate
mixture fitting, incremental evaluation and memory-bounded evaluation.

Run: python -m pllmod_tpu_torch.examples.protein_mixture_demo [--device cpu]
"""

import numpy as np
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm.opt_model import opt_rates_weights
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.ops.engine import (loglikelihood_bounded,
                                         tree_loglikelihood)
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from pllmod_tpu_torch.utils import models_aa
from pllmod_tpu_torch.utils.aa_data import (LG4X_RATES_DEFAULT,
                                            LG4X_WEIGHTS_DEFAULT)

AA = "ARNDCQEGHILKMFPSTWYV"
NEWICK = ("((t0:0.12,t1:0.18):0.05,((t2:0.21,t3:0.09):0.07,"
          "(t4:0.16,t5:0.11):0.04):0.06,(t6:0.25,t7:0.14):0.08);")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev, f64 = args.device, torch.float64
    rng = np.random.default_rng(1)
    n, sites = 8, 120
    seqs = ["".join(rng.choice(list(AA), sites)) for _ in range(n)]
    tree = Tree.from_newick(NEWICK)

    # -- every registry model evaluates --------------------------------
    print(f"protein registry: {models_aa.count()} models")
    for name in ("LG", "Q.PFAM", "MTART", "HIVB"):
        m = models_aa.info(name)
        part = create_partition(seqs, states=20, n_rate_cats=4, alpha=0.8,
                                subst_rates=m.rates, freqs=m.freqs,
                                dtype=f64, device=dev)
        print(f"  {name:9s} logL = "
              f"{float(tree_loglikelihood(part, tree)):.4f}")

    # -- LG4X: per-category matrices + free rates/weights --------------
    part = create_partition(seqs, states=20, n_rate_cats=4, alpha=None,
                            n_matrices=4, dtype=f64, device=dev)
    part = models_aa.set_protmix(part, "LG4X")
    part = part.replace(
        rate_cats=torch.as_tensor(LG4X_RATES_DEFAULT, dtype=f64,
                                  device=part.device),
        rate_weights=torch.as_tensor(LG4X_WEIGHTS_DEFAULT, dtype=f64,
                                     device=part.device))
    ti = TreeInfo(tree.copy(), [part],
                  params_to_optimize=(common.PARAM_FREE_RATES
                                      | common.PARAM_RATE_WEIGHTS))
    l0 = ti.compute_loglh()
    l1 = opt_rates_weights(ti, max_rounds=2)
    print(f"LG4X: start {l0:.4f} -> optimized rates/weights {l1:.4f}")

    # -- incremental evaluation ----------------------------------------
    ti.compute_loglh(incremental=True)
    before = ti.counters.clv_updates
    ti.set_branch_length(2, 0.3)
    ti.compute_loglh(incremental=True)
    partial_ops = (ti.counters.clv_updates - before) // \
        ti.partitions[0].n_patterns
    print(f"incremental: brlen change recomputed {partial_ops} of "
          f"{n - 2} CLV ops")

    # -- memory-bounded evaluation -------------------------------------
    lb, n_slots = loglikelihood_bounded(ti.partitions[0], tree)
    lf = float(tree_loglikelihood(ti.partitions[0], tree))
    print(f"bounded: logL {float(lb):.4f} with {n_slots} CLV slots "
          f"(full mode {n - 2} slots: {lf:.4f})")
    if not abs(float(lb) - lf) < 1e-8 * abs(lf):
        raise AssertionError(f"bounded {float(lb)} against full {lf}")
    return float(lb), lf


if __name__ == "__main__":
    main()
