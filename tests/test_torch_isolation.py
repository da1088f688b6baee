"""The PyTorch port stays apart from JAX: no module of it imports JAX or
the JAX package, importing it loads neither, and its entry points run on
the CUDA card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import pllmod_tpu_torch
from pllmod_tpu_torch import common, convert, flagship
from pllmod_tpu_torch.ops import _build
from pllmod_tpu_torch.ops.partition import create_partition

FORBIDDEN = {"jax", "jaxlib", "flax", "ml_dtypes", "pllmod_tpu"}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(pllmod_tpu_torch.__file__)
PORT_FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(_PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(_ROOT, "chip_smoke.py")])


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, _ROOT) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import pllmod_tpu_torch, pllmod_tpu_torch.flagship\n"
            "import pllmod_tpu_torch.convert, pllmod_tpu_torch.ops.engine\n"
            "import pllmod_tpu_torch.ops.deriv, pllmod_tpu_torch.ops.grouped\n"
            "import pllmod_tpu_torch.ops.levels, pllmod_tpu_torch.ops.repeats\n"
            "import pllmod_tpu_torch.ops.packed, pllmod_tpu_torch.profile\n"
            "import pllmod_tpu_torch.tree.treeinfo\n"
            "import pllmod_tpu_torch.optimize.blo\n"
            "import pllmod_tpu_torch.optimize.blo_bounded\n"
            "import pllmod_tpu_torch.algorithm.opt_model\n"
            "import pllmod_tpu_torch.optimize.edge_grad\n"
            "import pllmod_tpu_torch.optimize.params, pllmod_tpu_torch.cli\n"
            "import pllmod_tpu_torch.utils, pllmod_tpu_torch.msa\n"
            "import pllmod_tpu_torch.utils.models_aa\n"
            "import pllmod_tpu_torch.utils.models_gt\n"
            "import pllmod_tpu_torch.utils.models_mult\n"
            "import pllmod_tpu_torch.algorithm.spr\n"
            "import pllmod_tpu_torch.algorithm.ancestral\n"
            "import pllmod_tpu_torch.tree.moves\n"
            "import pllmod_tpu_torch.tree.rtree\n"
            "import pllmod_tpu_torch.tree.splits\n"
            "import pllmod_tpu_torch.tree.constraint\n"
            "import pllmod_tpu_torch.tree.utils\n"
            "import pllmod_tpu_torch.tree.starting\n"
            "import pllmod_tpu_torch.tree.tbe\n"
            "import pllmod_tpu_torch.tree.consensus\n"
            "import pllmod_tpu_torch.tree.show\n"
            "import pllmod_tpu_torch.binary\n"
            "import pllmod_tpu_torch.algorithm.search\n"
            "import pllmod_tpu_torch.examples.consensus_demo\n"
            "import pllmod_tpu_torch.examples.constrained_search_demo\n"
            "import pllmod_tpu_torch.examples.genotype_demo\n"
            "import pllmod_tpu_torch.examples.ml_search_demo\n"
            "import pllmod_tpu_torch.examples.partitioned_demo\n"
            "import pllmod_tpu_torch.examples.protein_mixture_demo\n"
            "import pllmod_tpu_torch.examples.rf_distance_demo\n"
            "import pllmod_tpu_torch.examples.spr_round\n"
            "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
            "print(sorted(new & %r))\n" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(common.PllModError):
        common.resolve_device()
    with pytest.raises(common.PllModError):
        create_partition(["ACGT", "ACGA", "ACTT"], states=4)
    with pytest.raises(common.PllModError):
        flagship.example(6, 32)


def test_convert_default_device_raises_without_cuda(no_cuda):
    part = create_partition(["ACGT", "ACGA", "ACTT"], states=4,
                            device="cpu")
    arrays = {f: getattr(part, f).numpy() for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(part, f) for f in convert.META_FIELDS}
    assert convert.partition_from_arrays(arrays, meta, "cpu").n_tips == 3
    with pytest.raises(common.PllModError):
        convert.partition_from_arrays(arrays, meta)
    with pytest.raises(common.PllModError):
        part.to("cuda")


def test_blo_default_device_raises_without_cuda(no_cuda):
    """The BLO runs where its partition lies: a partition asks for the
    card by default, and a CPU one is the caller's choice."""
    from pllmod_tpu_torch.optimize import blo
    with pytest.raises(common.PllModError):
        part, tree = flagship.example(6, 32)
    part, tree = flagship.example(6, 32, device="cpu")
    _, lnl = blo.optimize_branch_lengths(part, tree, max_sweeps=1)
    assert lnl < 0


def test_model_optimization_default_device_raises_without_cuda(no_cuda,
                                                             tmp_path):
    """The slice-10 entry points (the ``eval`` command, ``build_partition``)
    ask for the card by default; the model optimizers run where their
    partitions lie."""
    from pllmod_tpu_torch import cli
    from pllmod_tpu_torch.algorithm import opt_model
    from pllmod_tpu_torch.msa.msa import MSA
    from pllmod_tpu_torch.msa.io import write_fasta
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    seqs = ["ACGTAC", "ACGAAC", "ACTTAA", "TCGTAC"]
    labels = ["a", "b", "c", "d"]
    msa = MSA(labels, seqs)
    with pytest.raises(common.PllModError):
        cli.build_partition(msa, "GTR+G4")
    write_fasta(msa, str(tmp_path / "a.fasta"))
    (tmp_path / "t.nwk").write_text("((a:0.1,b:0.2):0.1,c:0.3,d:0.2);")
    argv = ["eval", "--msa", str(tmp_path / "a.fasta"), "--tree",
            str(tmp_path / "t.nwk"), "--model", "JC+G4", "--opt"]
    with pytest.raises(common.PllModError):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    args = cli.parse_args(argv + ["--device", "cpu"])
    result = args.fn(args)
    assert result["lnl"] >= result["lnl0"]
    assert result["stats"]
    part, _, mask = cli.build_partition(msa, "K80", device="cpu")
    ti = TreeInfo(result["treeinfo"].tree, [part], params_to_optimize=mask)
    start = ti.compute_loglh()
    assert opt_model.opt_model(ti) >= start


def test_ancestral_command_default_device_raises_without_cuda(no_cuda,
                                                            tmp_path):
    """The ``ancestral`` command asks for the card by default, as
    ``eval`` does, and runs on the CPU only when asked."""
    from pllmod_tpu_torch import cli
    from pllmod_tpu_torch.msa.msa import MSA
    from pllmod_tpu_torch.msa.io import write_fasta
    msa = MSA(["a", "b", "c", "d"], ["ACGTAC", "ACGAAC", "ACTTAA", "TCGTAC"])
    write_fasta(msa, str(tmp_path / "a.fasta"))
    (tmp_path / "t.nwk").write_text("((a:0.1,b:0.2):0.1,c:0.3,d:0.2);")
    argv = ["ancestral", "--msa", str(tmp_path / "a.fasta"), "--tree",
            str(tmp_path / "t.nwk"), "--model", "JC+G4"]
    with pytest.raises(common.PllModError):
        cli.main(argv)
    args = cli.parse_args(argv + ["--device", "cpu"])
    nodes, states = args.fn(args)
    assert len(nodes) == 2 and states.shape[1] >= 6


def test_spr_round_runs_where_its_partitions_lie(no_cuda):
    """``spr_round`` has no device of its own: a CPU TreeInfo runs on
    the CPU (kernel 2's plain walk for float32)."""
    import numpy as np
    from pllmod_tpu_torch.algorithm.spr import spr_round
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    with pytest.raises(common.PllModError):
        flagship.simulated(8, 64)
    part, tree = flagship.simulated(8, 64, device="cpu")
    flagship.random_spr(tree, 1, np.random.default_rng(0))
    ti = TreeInfo(tree, [part])
    start = ti.compute_loglh()
    lnl, _, _ = spr_round(ti, 1, 3)
    assert lnl >= start


def test_search_command_default_device_raises_without_cuda(no_cuda,
                                                         tmp_path):
    """The ``search`` command asks for the card by default, as ``eval``
    does; ``ml_search`` and the checkpoint loader run where they are
    told, and ``parsimony`` is host code."""
    from pllmod_tpu_torch import cli
    from pllmod_tpu_torch.binary import load_treeinfo, save_treeinfo
    from pllmod_tpu_torch.msa.msa import MSA
    from pllmod_tpu_torch.msa.io import write_fasta
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    msa = MSA(["a", "b", "c", "d", "e"],
              ["ACGTACGT", "ACGAACGA", "ACTTAATT", "TCGTACGT", "TCGAACGA"])
    write_fasta(msa, str(tmp_path / "a.fasta"))
    argv = ["search", "--msa", str(tmp_path / "a.fasta"), "--model",
            "JC+G4", "--radius-max", "1"]
    with pytest.raises(common.PllModError):
        cli.main(argv)
    args = cli.parse_args(argv + ["--device", "cpu", "--checkpoint",
                                  str(tmp_path / "ck.bin")])
    result = args.fn(args)
    assert result["result"].loglh >= result["result"].start_loglh
    with pytest.raises(common.PllModError):
        load_treeinfo(str(tmp_path / "ck.bin"))
    ti, _ = load_treeinfo(str(tmp_path / "ck.bin"), device="cpu")
    assert isinstance(ti, TreeInfo)
    save_treeinfo(str(tmp_path / "ck2.bin"), ti)
    assert cli.main(["parsimony", "--msa", str(tmp_path / "a.fasta")]) == 0


def test_kernel_launch_rejects_cpu_tensors():
    """The launch path checks devices before it builds or loads anything:
    a CPU tensor never reaches the kernel."""
    idx8 = torch.zeros((1, 8), dtype=torch.int32)
    P5 = torch.zeros((1, 2, 4, 4, 4))
    codes = torch.zeros((3, 128), dtype=torch.int32)
    tab = torch.ones((1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        _build.launch_walk("pllmod_fused_walk", idx8, P5, codes, tab,
                           torch.empty(2, 16, 128),
                           torch.empty(2, 1, 128, dtype=torch.int32), 2)

