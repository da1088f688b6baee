"""Genotype-model demo (reference: examples/genotype): likelihood + model
optimization on an unphased-genotype alignment with the GT10 model family.

Usage: python -m pllmod_tpu_torch.examples.genotype_demo [alignment.phy]
       [--device cpu]
"""

import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm.opt_model import opt_model
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.msa import read_phylip
from pllmod_tpu_torch.ops import charmap as cm
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.starting import parsimony_stepwise
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from pllmod_tpu_torch.utils import model_info

# a small unphased-genotype alignment (IUPAC het codes M R W S Y K)
DEMO_PHY = """6 20
g1  AMRGGTTACSTAYKAACGGT
g2  AMRGGTAACSTAYKAACGGT
g3  CMRGGTAACGTAYKAACGGT
g4  CARGGTAACGTACKAACGGT
g5  CARGGTAACGTACKATCGGT
g6  CARGCTAACGTACKATCGGT
"""


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("alignment", nargs="?")
    args = ap.parse_args(argv)
    msa = read_phylip(args.alignment or DEMO_PHY)
    model = model_info("GT10")          # GTGTR4 alias family
    print(f"model {model.name}: {model.states} states, "
          f"{model.n_free_rates} free rates")
    tree, pscore = parsimony_stepwise(msa.labels, msa.sequences, cm.GT10,
                                      seed=1)
    print(f"parsimony starting tree score: {pscore}")
    part = create_partition(msa.sequences, charmap=cm.GT10, n_rate_cats=4,
                            alpha=1.0, dtype=torch.float64,
                            device=args.device)
    ti = TreeInfo(tree, [part],
                  params_to_optimize=(common.PARAM_SUBST_RATES
                                      | common.PARAM_ALPHA
                                      | common.PARAM_BRANCHES_ITERATIVE))
    print(f"starting logL: {ti.compute_loglh():.6f}")
    lnl = opt_model(ti, symmetries=[model.rate_sym])
    print(f"optimized logL: {lnl:.6f}")
    print(ti.tree.to_newick())
    return lnl


if __name__ == "__main__":
    main()
