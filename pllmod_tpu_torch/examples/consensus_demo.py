"""Consensus-tree demo (reference: examples/consensus + weight-consensus).

Usage: python -m pllmod_tpu_torch.examples.consensus_demo trees.nwk [threshold]
       python -m pllmod_tpu_torch.examples.consensus_demo  # built-in demo

Host code only: ``--device`` is accepted and unused.
"""

from pllmod_tpu_torch.examples import parser
from pllmod_tpu_torch.tree.consensus import consensus, consensus_from_file
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.utils import newick_with_support

NEWICKS = [
    "(((a:1,b:1):1,c:1):1,(d:1,e:1):1,f:1);",
    "(((a:1,b:1):1,c:1):1,(d:1,f:1):1,e:1);",
    "(((a:1,b:1):1,d:1):1,(c:1,e:1):1,f:1);",
]
WEIGHTS = [0.5, 0.25, 0.25]


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("trees", nargs="?")
    ap.add_argument("threshold", nargs="?", type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.trees:
        tree, supports = consensus_from_file(args.trees, args.threshold)
        threshold = args.threshold
    else:
        trees = [Tree.from_newick(n) for n in NEWICKS]
        threshold = 0.5
        # weighted consensus: first tree counts double
        tree, supports = consensus(trees, threshold, weights=WEIGHTS)
        print("weighted majority-rule consensus (w = .5/.25/.25):")
    print(newick_with_support(tree, supports, as_fraction=True))
    print(f"threshold: {threshold}, splits kept: {len(supports)}")
    return tree, supports


if __name__ == "__main__":
    main()
