"""RF-distance demo (reference: examples/rf-distance).

Usage: python -m pllmod_tpu_torch.examples.rf_distance_demo trees.nwk
       computes the pairwise RF matrix over all trees in the file;
       without arguments runs a small built-in demo.

Host code only: ``--device`` is accepted and unused.
"""

import numpy as np

from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.tree.splits import (max_rf_distance,
                                          rf_distance_splits, tree_splits)
from pllmod_tpu_torch.tree.topology import Tree, set_tip_order

NEWICKS = [
    "((a:1,b:1):1,(c:1,d:1):1,e:1);",
    "((a:1,b:1):1,(c:1,e:1):1,d:1);",
    "((a:1,c:1):1,(b:1,d:1):1,e:1);",
]


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("trees", nargs="?")
    args = ap.parse_args(argv)
    if args.trees:
        with open(args.trees) as fh:
            newicks = [ln.strip() for ln in fh if ln.strip()]
    else:
        newicks = NEWICKS
    trees = [Tree.from_newick(n) for n in newicks]
    ref = trees[0]
    splits = []
    for t in trees:
        if t.labels != ref.labels:
            t = set_tip_order(t, ref.labels)
        splits.append(tree_splits(t)[0])
    n = len(trees)
    mat = np.zeros((n, n), int)
    for i in range(n):
        for j in range(i + 1, n):
            mat[i, j] = mat[j, i] = rf_distance_splits(splits[i], splits[j])
    print(f"{n} trees, {ref.n_tips} taxa, max RF = "
          f"{max_rf_distance(ref.n_tips)}")
    print(mat)
    rel = mat / max_rf_distance(ref.n_tips)
    print("relative:")
    print(np.round(rel, 3))
    return mat


if __name__ == "__main__":
    main()
