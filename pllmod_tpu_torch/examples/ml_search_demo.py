"""End-to-end ML tree search: MSA -> parsimony starting tree -> ml_search.

The full pipeline a reference user assembles from pll-modules + RAxML-NG:
parse sequences, compress site patterns (create_partition does this),
build a parsimony starting tree (pll_tree.c:987-1105), then alternate
model optimization with SPR rounds until the likelihood is stationary
(algo_search.c:1052 composed the RAxML-NG way).

Run: python -m pllmod_tpu_torch.examples.ml_search_demo [--device cpu]
"""

import numpy as np
import torch

from pllmod_tpu_torch import common, flagship
from pllmod_tpu_torch.algorithm.search import ml_search
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.starting import parsimony_stepwise
from pllmod_tpu_torch.tree.treeinfo import TreeInfo

RATES = np.array([1.2, 3.5, 0.8, 1.1, 4.2, 1.0])
FREQS = np.array([0.3, 0.2, 0.2, 0.3])


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    # simulate a small dataset (stand-in for a FASTA read via msa.io)
    rng = np.random.default_rng(7)
    n_taxa, n_sites = 12, 1000
    true_tree = flagship.random_binary_tree(rng, n_taxa, 0.05, 0.3)
    seqs = flagship.simulate(rng, true_tree, n_sites, RATES, FREQS, "ACGT",
                             alpha=0.8)
    labels = [f"t{i}" for i in range(n_taxa)]

    # parsimony starting tree (pllmod_utree_create_parsimony analog)
    start, psteps = parsimony_stepwise(labels, seqs, charmap.DNA, seed=42)
    print(f"parsimony starting tree: {psteps} steps")

    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=1.0,
                            subst_rates=np.ones(6), freqs=FREQS,
                            dtype=torch.float64, device=args.device)
    ti = TreeInfo(start, [part],
                  params_to_optimize=(common.PARAM_SUBST_RATES
                                      | common.PARAM_ALPHA
                                      | common.PARAM_BRANCHES_ITERATIVE))

    res = ml_search(
        ti, radius_step=4, radius_max=8, lh_epsilon=0.05,
        on_round=lambda r: print(
            f"  [{r.mode:8s}] radius={r.radius:2d} "
            f"applied={r.n_applied:2d} logL={r.loglh:.4f}"))

    print(f"search: {res.n_rounds} rounds, "
          f"logL {res.start_loglh:.4f} -> {res.loglh:.4f}")
    print(f"final alpha={float(ti.partitions[0].alpha):.3f}")
    print("final tree:", ti.tree.to_newick()[:120], "...")
    return res


if __name__ == "__main__":
    main()
