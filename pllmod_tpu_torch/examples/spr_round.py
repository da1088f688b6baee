"""SPR-round tree search demo (reference: examples/spr-round/spr-round.c).

Usage: python -m pllmod_tpu_torch.examples.spr_round [alignment.fasta]
       [tree.nwk] [--device cpu]

Without arguments, draws a small DNA alignment and a random starting
tree, and runs model optimization and SPR rounds from it.
"""

import numpy as np
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm.opt_model import opt_model
from pllmod_tpu_torch.algorithm.spr import spr_round
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.msa import MSA, load_msa
from pllmod_tpu_torch.ops import charmap as cm
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.starting import parsimony_stepwise, random_tree
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("alignment", nargs="?")
    ap.add_argument("tree", nargs="?")
    args = ap.parse_args(argv)
    if args.alignment:
        msa = load_msa(args.alignment)
        if args.tree:
            with open(args.tree) as fh:
                tree = Tree.from_newick(fh.read())
        else:
            tree, score = parsimony_stepwise(msa.labels, msa.sequences,
                                             cm.DNA, seed=42)
            print(f"parsimony starting tree: score {score}")
    else:
        rng = np.random.default_rng(42)
        labels = [f"t{i}" for i in range(12)]
        tree = random_tree(labels, seed=1)
        seqs = ["".join(rng.choice(list("ACGT"), 500)) for _ in labels]
        msa = MSA(labels, seqs)

    part = create_partition(msa.sequences, states=4, n_rate_cats=4,
                            alpha=1.0, dtype=torch.float64,
                            device=args.device)
    ti = TreeInfo(tree, [part],
                  params_to_optimize=(common.PARAM_SUBST_RATES
                                      | common.PARAM_ALPHA
                                      | common.PARAM_FREQUENCIES
                                      | common.PARAM_BRANCHES_ITERATIVE))
    lnl = ti.compute_loglh()
    print(f"starting logL: {lnl:.6f}")
    lnl = opt_model(ti)
    print(f"after model optimization: {lnl:.6f}")
    for rnd in range(10):
        lnl, n_applied, _ = spr_round(ti, radius_min=1, radius_max=10,
                                      thorough=(rnd >= 1))
        print(f"SPR round {rnd + 1}: logL {lnl:.6f}, {n_applied} applied")
        if n_applied == 0 and rnd >= 1:
            break
    print("final tree:")
    print(ti.tree.to_newick())
    return lnl


if __name__ == "__main__":
    main()
