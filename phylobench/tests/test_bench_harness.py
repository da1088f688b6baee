"""The harness driven end to end on the CPU at small sizes: what it
loads, what it finds by name, the program's inputs, the control and the
faults that have to come out as not correct."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tiny
from phylobench import harness
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.optimize import blo

SEED = 2**31 + 11
CELLS = sorted(tiny.TINY_CELLS)


def run(root, workload, trace=False, seconds=0.5, seed=SEED):
    return harness.run_cell(workload, seed, seconds, trace, "cpu",
                            time.perf_counter(), root, log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_runs_correct(tiny_root, workload, trace):
    r = run(tiny_root, workload, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = harness.Bench(tiny_root)
    want = {m["name"] for m in spec.metrics(workload, trace)}
    got = set(r["metrics"])
    # on the CPU nothing runs on a device: the roofline and the device
    # time have nothing to read, and the issue time reads only outside
    # the traced stretch
    assert got <= want and got >= want - {"eval_roofline", "issue_ms.eval",
                                           "blo_device_ms"}
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)


def test_no_jax_loaded_by_a_run(tiny_root):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from phylobench import harness\n"
        f"r = harness.run_cell('dna_tiny.eval', 5, 0.2, False, 'cpu', "
        f"time.perf_counter(), {tiny_root!r}, log=lambda m: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    top, banned = out.stdout.strip().splitlines()[-2:]
    top = eval(top)
    assert "pllmod_tpu_torch" in top
    assert not {"jax", "jaxlib", "flax", "pllmod_tpu"} & set(top)
    assert banned == "[]"


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pllmod_tpu_torch_x", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "pllmod_tpu.ops.engine", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.banned_modules() == ["jaxlib", "pllmod_tpu"]


def imports_of(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", ["reference.py", "model.py", "simulate.py",
                                  "roofline.py", "devtrace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    path = os.path.join(tiny.BENCH_DIR, name)
    assert imports_of(path) <= {"__future__", "numpy", "torch", "phylobench",
                                "heapq", "dataclasses", "math"}


def test_added_by_files_alone(tmp_path):
    root = tiny.make(str(tmp_path))
    pb = os.path.join(root, "phylobench")
    with open(os.path.join(pb, "traffic", "eval.json")) as f:
        mix = json.load(f)
    mix["length_factor"] = [0.99, 1.01]
    with open(os.path.join(pb, "traffic", "narrow.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "eval_ms.p50.py"), "w") as f:
        f.write("import numpy as np\n\n\ndef read(run):\n"
                "    return float(np.median([r['latency_s'] for r in "
                "run.records])) * 1e3\n")
    cfg = tiny.tiny_config("dna_small", "dna10k", 10, 256)
    with open(os.path.join(pb, "configs", "dna_small.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "cells", "dna_tiny.eval.json"),
                os.path.join(pb, "cells", "dna_small.narrow.json"))
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "dna_small", "source": "a test",
                            "file": "phylobench/configs/dna_small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dna_small.narrow",
                              "config": "dna_small", "traffic": "narrow",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "eval_ms.p50", "unit": "ms",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["dna_small.narrow"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    r = run(root, "dna_small.narrow")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"eval_ms.p50", "setup_s"}


def test_arrays_give_the_partition_of_create_partition():
    from phylobench.data import draw
    from phylobench.loaders.arrays import arrays
    from pllmod_tpu_torch import convert
    from pllmod_tpu_torch.ops.partition import create_partition
    cfg = tiny.tiny_config("dna_tiny", "dna10k", 14, 300)
    edges, lengths, rooted, model, tips = draw(cfg, SEED, "cpu")
    arr, meta = arrays(tips, model)
    got = convert.partition_from_arrays(arr, meta, "cpu")
    seqs = ["".join("ACGT"[s] for s in row) for row in tips.tolist()]
    m = cfg["model"]
    want = create_partition(seqs, states=4, n_rate_cats=4, alpha=m["alpha"],
                            subst_rates=model["subst_rates"],
                            freqs=model["freqs"], compress=False,
                            device="cpu")
    for name in convert.ARRAY_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b) or (name == "alpha" and torch.isclose(a, b)), \
            name
    for name in convert.META_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


def test_simulation_is_drawn_from_the_seed():
    from phylobench.data import draw
    cfg = tiny.tiny_config("txt_tiny", "dna246", 12, 200)
    a = draw(cfg, SEED, "cpu")
    b = draw(cfg, SEED, "cpu")
    c = draw(cfg, SEED + 1, "cpu")
    assert np.array_equal(a[0], b[0]) and torch.equal(a[4], b[4])
    assert not torch.equal(a[4], c[4])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    """The reference in TF32, put in the program's place, fails a limit."""
    bench = harness.Bench(tiny_root)
    dev = torch.device("cpu")
    c = harness.setup(bench, workload, SEED, dev)
    records, _, _ = harness.window(c, 0.3, False, dev)
    harness.release(c, dev)
    picked = records[-1:]
    ctl = [dict(r, answer=c.kind.control(c.traffic, c.driver, r))
           for r in picked]
    checks = harness.checked(c.kind.judge(c.traffic, c.driver, ctl),
                             c.checks["limits"])
    assert not harness.passes(checks), checks
    ok = harness.checked(c.kind.judge(c.traffic, c.driver, picked),
                         c.checks["limits"])
    assert harness.passes(ok), ok


def half_weights(part):
    w = part.pattern_weights.clone()
    w[: part.n_patterns // 2] = 0
    return part.replace(pattern_weights=w)


def eval_fault(kind):
    real = engine.compile_fast_eval

    def compile_broken(part, tree, *a, **kw):
        ev = real(part, tree, *a, **kw)
        last = []

        def broken(p, brl):
            if kind == "unchanged":           # the previous answer again
                if not last:
                    last.append(ev(p, brl))
                return last[0]
            if kind == "half":                # half the sites, scaled up
                return 2 * ev(half_weights(p), brl)
            return ev(p, brl) * (1 + 1e-5)    # the answer altered
        return broken
    return "compile_fast_eval", engine, compile_broken


def blo_fault(kind):
    real = blo.optimize_branch_lengths

    def broken(part, tree, *a, **kw):
        if kind == "unchanged":               # lengths left at the start
            lnl = float(engine.tree_loglikelihood(part, tree))
            kw.get("stats", {}).update(sweeps=0)
            return torch.as_tensor(tree.lengths), lnl
        if kind == "half":
            brl, lnl = real(half_weights(part), tree, *a, **kw)
            return brl, 2 * lnl
        brl, lnl = real(part, tree, *a, **kw)
        return brl, lnl + 1e-5 * abs(lnl)
    return "optimize_branch_lengths", blo, broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_program_is_not_correct(tiny_root, workload, fault,
                                       monkeypatch):
    """A run over a broken timed path: the state returned unchanged,
    half the sites left out and the rest scaled up, an answer altered
    where it is produced. One card, so no exchange between chips to
    leave out."""
    make = blo_fault if workload.endswith(".blo") else eval_fault
    name, mod, broken = make(fault)
    monkeypatch.setattr(mod, name, broken)
    r = run(tiny_root, workload)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_the_card(tiny_root, workload, card):
    r = harness.run_cell(workload, SEED, 1.0, True, card,
                         time.perf_counter(), tiny_root, log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
