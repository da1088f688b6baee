"""Partitioned analysis demo (BASELINE.json config 5, single-host form):
mixed DNA+AA partitions with per-partition models over one topology,
model optimization, bootstrap supports, RF distances and a consensus.

Run: python -m pllmod_tpu_torch.examples.partitioned_demo [--device cpu]
"""

import numpy as np
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm.opt_model import opt_model
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.ops import charmap as cm
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.consensus import consensus
from pllmod_tpu_torch.tree.splits import rf_distance
from pllmod_tpu_torch.tree.starting import (parsimony_stepwise,
                                            parsimony_tree_multi)
from pllmod_tpu_torch.tree.tbe import fbp_support, tbe_support
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from pllmod_tpu_torch.tree.utils import newick_with_support
from pllmod_tpu_torch.utils import model_info


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(11)
    n = 10
    labels = [f"sp{i}" for i in range(n)]
    dna = ["".join(rng.choice(list("ACGT"), 400)) for _ in range(n)]
    aa = ["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), 150))
          for _ in range(n)]

    # multi-partition parsimony starting tree
    tree, pscore = parsimony_tree_multi(
        labels, [(dna, cm.DNA, None), (aa, cm.AA, None)], seed=4)
    print(f"parsimony starting tree: score {pscore}")

    lg = model_info("LG")
    p_dna = create_partition(dna, states=4, n_rate_cats=4, alpha=1.0,
                             dtype=torch.float64, device=args.device)
    p_aa = create_partition(aa, states=20, n_rate_cats=4, alpha=1.0,
                            subst_rates=lg.rates, freqs=lg.freqs,
                            dtype=torch.float64, device=args.device)
    ti = TreeInfo(tree, [p_dna, p_aa], brlen_linkage=common.BRLEN_SCALED,
                  params_to_optimize=[
                      common.PARAM_SUBST_RATES | common.PARAM_ALPHA
                      | common.PARAM_BRANCHES_ITERATIVE,
                      common.PARAM_ALPHA | common.PARAM_BRANCHES_ITERATIVE])
    print(f"start logL: {ti.compute_loglh():.4f}")
    lnl = opt_model(ti)
    print(f"optimized logL: {lnl:.4f}  (scalers: {ti.brlen_scalers})")
    print(ti.counters.report())

    # toy bootstrap: site-resampled DNA partition, parsimony trees
    boots = []
    for b in range(10):
        cols = rng.integers(0, 400, 400)
        bs = ["".join(s[c] for c in cols) for s in dna]
        bt, _ = parsimony_stepwise(labels, bs, cm.DNA, seed=100 + b)
        boots.append(bt)

    fbp = fbp_support(ti.tree, boots)
    tbe = tbe_support(ti.tree, boots)
    print("FBP supports:", {e: round(v, 2) for e, v in fbp.items()})
    print("TBE supports:", {e: round(v, 2) for e, v in tbe.items()})
    print("ML tree with TBE support:")
    print(newick_with_support(ti.tree, tbe, as_fraction=True))

    cons, supp = consensus(boots, threshold=0.5)
    print(f"bootstrap majority consensus ({len(supp)} splits):")
    print(cons.to_newick())
    print("RF(ML, consensus) =", rf_distance(ti.tree, cons))
    return lnl


if __name__ == "__main__":
    main()
