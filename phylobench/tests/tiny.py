"""A copy of the benchmark with small cells, for the CPU tests: the
checkout's ``BENCHMARK.json`` and ``phylobench/`` copied under a
directory, with configurations, workloads and cells added as files."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


def tiny_config(name: str, base: str, n_taxa: int, n_sites: int) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", f"{base}.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, n_taxa=n_taxa, n_sites=n_sites)
    return cfg


TINY = {
    # config: (base config, taxa, sites)
    "dna_tiny": ("dna10k", 16, 640),
    "txt_tiny": ("dna246", 12, 256),
}
# workload: (config, traffic, check_requests)
TINY_CELLS = {
    "dna_tiny.eval": ("dna_tiny", "eval", 3),
    "txt_tiny.eval": ("txt_tiny", "eval", 3),
    "txt_tiny.blo": ("txt_tiny", "blo", 2),
}


def make(dest: str) -> str:
    """A copy of the benchmark under ``dest`` with the TINY configurations
    and the TINY_CELLS workloads added as files; returns its root."""
    root = os.path.join(dest, "bench")
    shutil.copytree(BENCH_DIR, os.path.join(root, "phylobench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, (base, n, s) in TINY.items():
        path = f"phylobench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(tiny_config(name, base, n, s), f)
        spec["configs"].append({"name": name, "source": "a test", "file": path,
                                "reduced": ["n_taxa", "n_sites"],
                                "why": "a test"})
    for name, (config, traffic, k) in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test"})
        base = [w["name"] for w in spec["workloads"]
                if w["traffic"] == traffic and w["config"] != config][0]
        with open(os.path.join(root, "phylobench", "cells",
                               f"{base}.json")) as f:
            cell = json.load(f)
        cell["check_requests"] = k
        with open(os.path.join(root, "phylobench", "cells", f"{name}.json"),
                  "w") as f:
            json.dump(cell, f)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and base in m["workloads"]:
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root
