"""Command-line front end of the port — counterpart of ``pllmod_tpu.cli``'s
``eval``, ``ancestral`` and ``rf`` subcommands (the others come with the
slices that port their modules):

    python -m pllmod_tpu_torch eval --msa a.fasta --tree t.nwk \\
        --model GTR+G4 [--opt] [--tol 1e-3] [--device cuda|cpu]
    python -m pllmod_tpu_torch ancestral --msa a.fasta --tree t.nwk \\
        [--model GTR+G] [--device cuda|cpu]
    python -m pllmod_tpu_torch rf trees1.nwk [trees2.nwk ...]

Model strings follow the downstream convention ``NAME[+G[n]][+I][+FC|+FE]``:
``NAME`` resolves against the DNA, protein, genotype and MULTIx
registries (``utils``); ``+G[n]`` adds n (default 4) discrete Gamma
categories with a free shape; ``+I`` a free proportion of invariant
sites; ``+FE``/``+FC`` force equal / empirical (counted) base
frequencies (default: the model's own frequencies, empirical when the
model leaves them free). ``--opt`` runs ``algorithm.opt_model`` (rates,
frequencies, alpha/p-inv, branches) and prints the optimized logL and
tree. ``ancestral`` prints the most probable state of every site at
every inner node (one FASTA record a node); ``rf`` the pairwise
Robinson-Foulds distances of the trees in its files. ``eval`` and
``ancestral`` run on ``--device`` (default: the CUDA card).
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
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv``, run the subcommand, return the exit code."""
    args = parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
