"""Constrained ML tree search.

The RAxML-NG ``--tree-constraint`` workflow on the port's primitives
(reference machinery: utree_constraint.c + the clv_index_map plumbing of
pll_tree.c:1110-1200):

1. a multifurcating, possibly non-comprehensive constraint tree defines
   the split set every visited topology must contain,
2. the starting tree resolves the constraint by PARSIMONY
   (resolve_multi_parsimony: random resolution + constrained parsimony
   SPR rounds),
3. ml_search restricts every SPR to constraint-compatible topologies
   (fast single-split filter + apply-time full check with rollback).

Run: python -m pllmod_tpu_torch.examples.constrained_search_demo [--device cpu]
"""

import numpy as np
import torch

from pllmod_tpu_torch.algorithm.search import ml_search
from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.ops.charmap import DNA
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.constraint import Constraint
from pllmod_tpu_torch.tree.starting import resolve_multi_parsimony
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo

# {t0..t3} and {t6..t9} must each stay monophyletic
CONSTRAINT = ("((t0:1,t1:1,t2:1,t3:1):1,(t4:1,t5:1):1,"
              "(t6:1,t7:1,t8:1,t9:1):1);")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    rng = np.random.default_rng(7)
    n = 10
    seqs = ["".join(rng.choice(list("ACGT"), 200)) for _ in range(n)]
    cons = Tree.from_newick(CONSTRAINT)

    start, steps = resolve_multi_parsimony(cons, [(seqs, DNA, None)],
                                           seed=1, max_spr_rounds=3)
    print(f"constrained parsimony start: {steps} steps")

    # float32: the kernels' path (their plain versions on the CPU)
    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=0.8,
                            dtype=torch.float32, device=args.device)
    constraint = Constraint(cons, start.labels)
    assert constraint.check_tree(start)

    ti = TreeInfo(start, [part])
    res = ml_search(ti, radius_max=6, max_rounds=6, thorough=True,
                    constraint=constraint)
    ok = constraint.check_tree(ti.tree)
    print(f"final logL {res.loglh:.4f} after {res.n_rounds} rounds; "
          f"constraint satisfied: {ok}")
    if not ok:
        raise AssertionError("the search left the constraint")
    print(ti.tree.to_newick())
    return res


if __name__ == "__main__":
    main()
