"""Command-line front end of the port — counterpart of ``pllmod_tpu.cli``,
all seven of its subcommands:

    python -m pllmod_tpu_torch eval --msa a.fasta --tree t.nwk \\
        --model GTR+G4 [--opt] [--tol 1e-3] [--device cuda|cpu]
    python -m pllmod_tpu_torch search --msa a.fasta --model GTR+G+I \\
        [--seed 1] [--checkpoint ck.bin [--resume]] [--device cuda|cpu]
    python -m pllmod_tpu_torch parsimony --msa a.fasta [--seed 1]
    python -m pllmod_tpu_torch ancestral --msa a.fasta --tree t.nwk \\
        [--model GTR+G] [--device cuda|cpu]
    python -m pllmod_tpu_torch rf trees1.nwk [trees2.nwk ...]
    python -m pllmod_tpu_torch consensus trees.nwk [--threshold 0.5]
    python -m pllmod_tpu_torch support --tree best.nwk boots.nwk \\
        [--metric tbe]

Model strings follow the downstream convention ``NAME[+G[n]][+I][+FC|+FE]``:
``NAME`` resolves against the DNA, protein, genotype and MULTIx
registries (``utils``); ``+G[n]`` adds n (default 4) discrete Gamma
categories with a free shape; ``+I`` a free proportion of invariant
sites; ``+FE``/``+FC`` force equal / empirical (counted) base
frequencies (default: the model's own frequencies, empirical when the
model leaves them free). ``--opt`` runs ``algorithm.opt_model`` (rates,
frequencies, alpha/p-inv, branches) and prints the optimized logL and
tree. ``search`` runs ``algorithm.ml_search`` from a parsimony starting
tree (or ``--tree``, ``--random-start``, or a ``--constraint`` resolved
by parsimony), checkpointed to ``--checkpoint`` after every round.
``parsimony`` prints a parsimony starting tree and its score.
``ancestral`` prints the most probable state of every site at every
inner node (one FASTA record a node); ``rf`` the pairwise
Robinson-Foulds distances of the trees in its files; ``support`` the
bootstrap support (FBP, TBE) of a best tree's branches; ``consensus``
the majority-rule (or strict, or MRE) consensus of a tree file.
``eval``, ``search`` and ``ancestral`` run on ``--device`` (default:
the CUDA card); the other four are host code.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


# ---------------------------------------------------------------------------
# model-string parsing
# ---------------------------------------------------------------------------
def resolve_model(name: str):
    """Resolve a bare model name against every registry (DNA, GT, AA,
    MULTI). Returns a SubstModel."""
    from pllmod_tpu_torch.common import UtilError
    from pllmod_tpu_torch.utils import models_aa, models_dna, models_gt, \
        models_mult
    for reg in (models_dna, models_gt, models_aa, models_mult):
        try:
            return reg.info(name)
        except (UtilError, KeyError, ValueError):
            continue
    raise SystemExit(f"unknown model: {name!r}")


def parse_model_string(spec: str):
    """``NAME[+G[n]][+I][+FC|+FE]`` -> (SubstModel, n_cats, use_pinv,
    freq_mode). freq_mode in {"model", "empirical", "equal"}."""
    parts = spec.split("+")
    model = resolve_model(parts[0])
    n_cats, use_pinv, freq_mode = 1, False, "model"
    for tok in parts[1:]:
        t = tok.upper()
        if t.startswith("G"):
            n_cats = int(t[1:]) if len(t) > 1 else 4
        elif t == "I":
            use_pinv = True
        elif t in ("FC", "F"):
            freq_mode = "empirical"
        elif t == "FE":
            freq_mode = "equal"
        else:
            raise SystemExit(f"unknown model modifier: +{tok}")
    return model, n_cats, use_pinv, freq_mode


def build_partition(msa, spec: str, dtype=torch.float32,
                    compress: bool = True, device="cuda"):
    """MSA + model string -> (Partition, SubstModel, params_to_optimize)
    on ``device``."""
    from pllmod_tpu_torch import common
    from pllmod_tpu_torch.msa.msa import empirical_frequencies
    from pllmod_tpu_torch.ops import charmap as charmap_mod
    from pllmod_tpu_torch.ops.partition import create_partition

    model, n_cats, use_pinv, freq_mode = parse_model_string(spec)
    cm = charmap_mod.for_states(model.states)
    if freq_mode == "equal":
        freqs = np.full(model.states, 1.0 / model.states)
    elif freq_mode == "empirical" or model.freqs is None:
        freqs = empirical_frequencies(msa, cm)
    else:
        freqs = np.asarray(model.freqs, float)
    n_rates = model.states * (model.states - 1) // 2
    rates = (np.asarray(model.rates, float) if model.rates is not None
             else np.ones(n_rates))
    part = create_partition(
        msa.sequences, charmap=cm, n_rate_cats=n_cats,
        alpha=1.0, subst_rates=rates, freqs=freqs,
        prop_invar=0.02 if use_pinv else 0.0, compress=compress,
        dtype=dtype, device=device)

    mask = common.PARAM_BRANCHES_ITERATIVE
    if n_cats > 1:
        mask |= common.PARAM_ALPHA
    if use_pinv:
        mask |= common.PARAM_PINV
    if model.rates is None:
        mask |= common.PARAM_SUBST_RATES
    if model.freqs is None and freq_mode == "model":
        mask |= common.PARAM_FREQUENCIES
    return part, model, mask


def _read_msa(path):
    from pllmod_tpu_torch.msa.io import load_msa
    return load_msa(path)


def _read_trees(path):
    from pllmod_tpu_torch.tree.topology import Tree
    with open(path) as fh:
        text = fh.read()
    return [Tree.from_newick(chunk.strip() + ";")
            for chunk in text.split(";") if chunk.strip()]


def _order_tree_tips(tree, msa):
    """Reorder MSA rows to the tree's tip order (label match); the taxon
    sets must be identical (a mismatch either way is an error, the
    RAxML-NG behavior)."""
    idx = {lab: i for i, lab in enumerate(msa.labels)}
    tip_labels = list(tree.labels[:tree.n_tips])
    missing = [lab for lab in tip_labels if lab not in idx]
    if missing:
        raise SystemExit(f"taxa in tree but not in MSA: {missing[:5]}")
    extra = sorted(set(msa.labels) - set(tip_labels))
    if extra:
        raise SystemExit(f"taxa in MSA but not in tree: {extra[:5]} "
                         f"(filter the alignment first)")
    msa.sequences = [msa.sequences[idx[lab]] for lab in tip_labels]
    msa.labels = tip_labels


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------
def cmd_eval(args):
    """Evaluate (and with ``--opt`` optimize) a tree's likelihood.
    Returns a dict: the run's ``treeinfo``, its starting ``lnl0``, final
    ``lnl`` and ``stats``, ``opt_model``'s counts and host seconds by
    family (empty without ``--opt``)."""
    from pllmod_tpu_torch.algorithm.opt_model import opt_model
    from pllmod_tpu_torch.ops.engine import tree_loglikelihood
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo

    msa = _read_msa(args.msa)
    tree = _read_trees(args.tree)[0]
    _order_tree_tips(tree, msa)
    part, model, mask = build_partition(msa, args.model, device=args.device)
    print(f"model {model.name}: {part.states} states, "
          f"{part.n_cats} rate cats, {part.n_patterns} patterns")
    lnl0 = lnl = float(tree_loglikelihood(part, tree))
    print(f"logL = {lnl:.6f}")
    ti = TreeInfo(tree, [part], params_to_optimize=mask)
    stats = {}
    if args.opt:
        lnl = opt_model(ti, tol=args.tol, stats=stats)
        print(f"optimized logL = {lnl:.6f} "
              f"(alpha={float(ti.partitions[0].alpha):.4f})")
        print(tree.to_newick())
    return dict(treeinfo=ti, lnl0=lnl0, lnl=lnl, stats=stats)


def cmd_search(args):
    """Full ML search. Returns a dict: the run's ``treeinfo`` (the best
    tree and model) and its :class:`~pllmod_tpu_torch.algorithm.search.
    SearchResult` as ``result``."""
    from pllmod_tpu_torch.algorithm.search import ml_search
    from pllmod_tpu_torch.ops import charmap as charmap_mod
    from pllmod_tpu_torch.tree.starting import (parsimony_stepwise,
                                                random_tree,
                                                resolve_multi_parsimony)
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo

    msa = _read_msa(args.msa)
    constraint = None
    if args.tree:
        start = _read_trees(args.tree)[0]
        # reorder the MSA rows BEFORE encoding tip states: the tree-tip ->
        # partition-row mapping is positional
        _order_tree_tips(start, msa)
        part, model, mask = build_partition(msa, args.model,
                                            device=args.device)
    else:
        part, model, mask = build_partition(msa, args.model,
                                            device=args.device)
        if args.constraint:
            # constrained search (RAxML-NG --tree-constraint semantics):
            # resolve the multifurcating constraint by parsimony, then
            # restrict every SPR to topologies containing its splits
            from pllmod_tpu_torch.tree.constraint import Constraint
            cons_tree = _read_trees(args.constraint)[0]
            cm = charmap_mod.for_states(model.states)
            seq_of = dict(zip(msa.labels, msa.sequences))
            ordered = [seq_of[lb] for lb in cons_tree.labels]
            start, steps = resolve_multi_parsimony(
                cons_tree, [(ordered, cm, None)], seed=args.seed)
            msa = type(msa)(list(cons_tree.labels), ordered)
            part, model, mask = build_partition(msa, args.model,
                                                device=args.device)
            constraint = Constraint(cons_tree, start.labels)
            print(f"constrained parsimony start: {steps} steps")
        elif args.random_start:
            start = random_tree(msa.labels, seed=args.seed)
        else:
            cm = charmap_mod.for_states(model.states)
            start, steps = parsimony_stepwise(msa.labels, msa.sequences,
                                              cm, seed=args.seed)
            print(f"parsimony starting tree: {steps} steps")
    ti = TreeInfo(start, [part], params_to_optimize=mask)
    res = ml_search(
        ti, radius_step=args.radius_step, radius_max=args.radius_max,
        lh_epsilon=args.epsilon, checkpoint_path=args.checkpoint,
        resume=args.resume, constraint=constraint,
        on_round=lambda r: print(f"[{r.mode:8s}] radius={r.radius:2d} "
                                 f"applied={r.n_applied:3d} "
                                 f"logL={r.loglh:.4f}", flush=True))
    print(f"final logL = {res.loglh:.6f} ({res.n_rounds} rounds)")
    print(ti.tree.to_newick())
    return dict(treeinfo=ti, result=res)


def cmd_parsimony(args):
    """Print a parsimony starting tree and its score. Returns (tree,
    score)."""
    from pllmod_tpu_torch.ops import charmap as charmap_mod
    from pllmod_tpu_torch.tree.starting import parsimony_stepwise

    msa = _read_msa(args.msa)
    cm = charmap_mod.for_states(args.states)
    tree, steps = parsimony_stepwise(msa.labels, msa.sequences, cm,
                                     seed=args.seed)
    print(f"parsimony score: {steps}")
    print(tree.to_newick())
    return tree, steps


def cmd_ancestral(args):
    """Print the marginal ancestral states of every inner node, one
    record a node, per site in alignment order (RAxML-NG --ancestral
    prints one state string per inner node). Returns (nodes, states)."""
    from pllmod_tpu_torch.algorithm.ancestral import ancestral_states
    from pllmod_tpu_torch.ops import charmap as charmap_mod

    msa = _read_msa(args.msa)
    tree = _read_trees(args.tree)[0]
    _order_tree_tips(tree, msa)
    # uncompressed: per-site output in alignment order
    part, model, _mask = build_partition(msa, args.model, compress=False,
                                         device=args.device)
    if model.states == 4:
        syms = "ACGT"
    elif model.states == 20:
        syms = charmap_mod.AA_ORDER
    else:
        syms = charmap_mod.MULTI_SYMBOLS[:model.states]
    nodes, states = ancestral_states(part, tree)
    n_sites = len(msa.sequences[0])
    for node, st in zip(nodes, states):
        print(f">node_{node}")
        print("".join(syms[int(s)] for s in st[:n_sites]))
    return nodes, states


def cmd_rf(args):
    """Print the pairwise RF distance matrix of the trees in
    ``args.trees`` (multi-Newick files). Returns the matrix."""
    from pllmod_tpu_torch.tree.splits import max_rf_distance, rf_distance

    trees = []
    for path in args.trees:
        trees.extend(_read_trees(path))
    if len(trees) < 2:
        raise SystemExit("need at least two trees")
    n = len(trees)
    print(f"{n} trees; max RF = {max_rf_distance(trees[0].n_tips)}")
    dist = np.zeros((n, n), int)
    for i in range(n):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = rf_distance(trees[i], trees[j])
    for row in dist:
        print(" ".join(f"{d:4d}" for d in row))
    return dist


def cmd_support(args):
    """Map bootstrap support onto a best tree (the reference's
    tbe_functions.c / pllmod_utree_draw_support workflow): FBP = classic
    Felsenstein proportions (exact split matches), TBE = transfer
    bootstrap expectation (Lemoine et al. 2018, tbe_naive driver).
    Returns {metric: {edge: support}}."""
    from pllmod_tpu_torch.tree.tbe import fbp_support, tbe_support
    from pllmod_tpu_torch.tree.topology import set_tip_order
    from pllmod_tpu_torch.tree.utils import newick_with_support

    ref = _read_trees(args.tree)[0]
    boots = []
    for path in args.bootstraps:
        boots.extend(_read_trees(path))
    if not boots:
        raise SystemExit("need at least one bootstrap tree")
    # normalize tip order once: with --metric both each support function
    # would otherwise redo the label matching for every bootstrap tree
    boots = [set_tip_order(bt, ref.labels) if bt.labels != ref.labels
             else bt for bt in boots]
    print(f"{len(boots)} bootstrap trees")
    out = {}
    for name, fn in (("fbp", fbp_support), ("tbe", tbe_support)):
        if args.metric not in (name, "both"):
            continue
        out[name] = sup = fn(ref, boots)
        print(f"{name.upper()} tree: "
              f"{newick_with_support(ref, sup, as_fraction=args.fraction)}")
    return out


def cmd_consensus(args):
    """Print the consensus of the trees in ``args.trees`` with its
    supports. Returns (tree, supports)."""
    from pllmod_tpu_torch.tree.consensus import consensus_from_file
    from pllmod_tpu_torch.tree.utils import newick_with_support

    tree, supports = consensus_from_file(args.trees, args.threshold)
    print(newick_with_support(tree, supports))
    return tree, supports


def parse_args(argv=None):
    """The command line ``argv`` parsed; ``args.fn(args)`` runs the
    subcommand."""
    ap = argparse.ArgumentParser(prog="pllmod_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("eval", help="evaluate (and optionally optimize) "
                                    "a tree's likelihood")
    p.add_argument("--msa", required=True)
    p.add_argument("--tree", required=True)
    p.add_argument("--model", default="GTR+G")
    p.add_argument("--opt", action="store_true",
                   help="optimize model parameters + branch lengths")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("search", help="full ML tree search")
    p.add_argument("--msa", required=True)
    p.add_argument("--model", default="GTR+G")
    p.add_argument("--tree", help="starting tree (default: parsimony)")
    p.add_argument("--constraint", help="topological constraint tree "
                   "(multifurcating Newick; search is restricted to "
                   "topologies containing its splits)")
    p.add_argument("--random-start", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--radius-step", type=int, default=5)
    p.add_argument("--radius-max", type=int, default=20)
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--checkpoint")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("parsimony", help="parsimony starting tree")
    p.add_argument("--msa", required=True)
    p.add_argument("--states", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_parsimony)

    p = sub.add_parser("ancestral", help="marginal ancestral states at "
                                         "every inner node")
    p.add_argument("--msa", required=True)
    p.add_argument("--tree", required=True)
    p.add_argument("--model", default="GTR+G")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.set_defaults(fn=cmd_ancestral)

    p = sub.add_parser("rf", help="pairwise RF distance matrix")
    p.add_argument("trees", nargs="+")
    p.set_defaults(fn=cmd_rf)

    p = sub.add_parser("support", help="bootstrap support (FBP / TBE) "
                                       "drawn onto a best tree")
    p.add_argument("--tree", required=True, help="best/reference tree")
    p.add_argument("bootstraps", nargs="+",
                   help="bootstrap tree file(s), multi-Newick")
    p.add_argument("--metric", choices=("fbp", "tbe", "both"),
                   default="both")
    p.add_argument("--fraction", action="store_true",
                   help="print supports as fractions instead of percent")
    p.set_defaults(fn=cmd_support)

    p = sub.add_parser("consensus", help="majority-rule consensus")
    p.add_argument("trees")
    p.add_argument("--threshold", type=float, default=0.5)
    p.set_defaults(fn=cmd_consensus)
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv``, run the subcommand, return the exit code."""
    args = parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
