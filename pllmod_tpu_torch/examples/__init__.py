"""The example drivers — the port's counterparts of the JAX package's
``examples/``, one module each, with the same data and seeds:

- :mod:`.consensus_demo` — weighted majority-rule consensus
- :mod:`.constrained_search_demo` — constrained ML search
- :mod:`.genotype_demo` — GT10 likelihood and model optimization
- :mod:`.ml_search_demo` — MSA → parsimony start → ``ml_search``
- :mod:`.partitioned_demo` — DNA + protein partitions, supports, RF,
  consensus
- :mod:`.protein_mixture_demo` — the protein registry, LG4X, incremental
  and memory-bounded evaluation
- :mod:`.rf_distance_demo` — pairwise RF distances
- :mod:`.spr_round` — model optimization and SPR rounds

Each runs as ``python -m pllmod_tpu_torch.examples.<name> [--device
cpu]`` (the device defaults to ``cuda``) and has ``main(argv=None)``.
"""

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """The drivers' command line: their first docstring line, and
    ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the likelihood (default cuda)")
    return ap
