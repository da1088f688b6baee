"""``chip_smoke.py``'s phase 9, the site mesh, alone: builds the kernels,
writes the alignment and tree that phase 6 would leave in
``build/opt_model`` and runs ``chip_smoke.run_mesh`` (``--profile``: each
mesh's busy shares; ``--cards-only``: only the mesh of one shard a card,
on a machine with several). Prints the phase's row as JSON and writes it
with the launches by kernel, cell and path to
``build/mesh_phase.json``.

    python3 scripts/mesh_phase.py [--profile] [--cards-only]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pllmod_tpu_torch import flagship  # noqa: E402
from pllmod_tpu_torch.msa import io as msa_io  # noqa: E402
from pllmod_tpu_torch.msa.msa import MSA  # noqa: E402
from pllmod_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cards-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    print(gpu)
    _build.load()
    os.makedirs(cs.OPT_DIR, exist_ok=True)
    seqs, newick, _, _ = flagship.simulated_data(**cs.FLAGSHIP,
                                                 sim_seed=cs.SIM_SEED)
    n = cs.FLAGSHIP["n_taxa"]
    msa_io.write_fasta(MSA([f"t{i}" for i in range(n)], seqs),
                       os.path.join(cs.OPT_DIR, "flagship.fasta"))
    with open(os.path.join(cs.OPT_DIR, "flagship.nwk"), "w") as fh:
        fh.write(newick)
    if args.cards_only:
        every = cs.mesh_devices
        cs.mesh_devices = lambda: [m for m in every() if "cards" in m[0]]
        if not cs.mesh_devices():
            print("mesh_phase: --cards-only needs two or more cards",
                  file=sys.stderr)
            return 1
    row = cs.run_mesh(gpu, args.profile)
    out = {"mesh": row, "launches": cs.LAUNCH_LOG}
    print(json.dumps(out))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "build", "mesh_phase.json"), "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
