"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window produced.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that the harness finds by the name in
``BENCHMARK.json``:

- ``phylobench/configs/<config>.json``: sizes, model, tree recipe and the
  loader (``load``) that builds the program's partition;
- ``phylobench/loaders/<load>.py``: ``build(config, seed, device)``;
- ``phylobench/traffic/<traffic>.json``: the mix's parameters, with the
  request ``kind`` that drives it;
- ``phylobench/kinds/<kind>.py``: ``Driver`` (set-up: it builds through
  the loader what its requests use; ``issue``), ``judge`` (the numbers
  compared) and ``control`` (the reference put in the program's place);
- ``phylobench/cells/<workload>.json``: the cell's limits and how many of
  its requests are checked;
- ``phylobench/metrics/<metric>.py``: ``read(run)``, the metric's value
  or None where the run has nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from phylobench import devtrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "pllmod_tpu")


def load_module(path: str):
    """The Python file ``path`` as a module of its own."""
    name = "phylobench_file_" + os.path.relpath(path, ROOT).replace(
        os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dir = os.path.join(root, self.spec["paths"][0])

    def _json(self, *parts):
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def cell(self, name: str) -> dict:
        return self._json("cells", f"{name}.json")

    def module(self, folder: str, name: str):
        return load_module(os.path.join(self.dir, folder, f"{name}.py"))

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: the end-to-end ones
        (``trace`` false) or the per-layer ones, each where its
        ``workloads`` name the cell or, without that key, where the cell
        reports the end-to-end metric it moves."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


@dataclasses.dataclass
class Run:
    """What a metric reads: the run's requests and its traced stretch."""
    kind: str
    shape: dict
    setup_s: float
    window_s: float
    records: list
    trace: dict | None = None


def span(on: bool, name: str):
    """A ``record_function`` span while the profiler runs, else nothing."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample(n: int, k: int, seed: int) -> list[int]:
    """``k`` request indices of ``n`` drawn from ``seed``, the last one
    always among them."""
    rng = np.random.default_rng([seed % (1 << 63), 1])
    picked = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    picked.add(n - 1)
    return sorted(picked)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclasses.dataclass
class Cell:
    """A workload set up: its files and its driver, which holds what the
    loader built."""
    spec: dict
    traffic: dict
    checks: dict
    kind: object
    driver: object


def setup(bench: Bench, workload: str, seed: int, device,
          traffic: dict | None = None) -> Cell:
    """Load the workload's files and hand the driver the loader: it
    builds what its requests use and drives its warm-up. ``traffic``
    replaces the mix's parameters (calibration only)."""
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = traffic or bench.traffic(w["traffic"])
    kind = bench.module("kinds", traffic["kind"])
    loader = bench.module("loaders", config["load"])
    driver = kind.Driver(lambda s: loader.build(config, s, device), traffic,
                         seed, device)
    sync(device)
    return Cell(w, traffic, bench.cell(workload), kind, driver)


def window(c: Cell, seconds: float, trace: bool, device, log=print):
    """The closed loop: requests one after another until the first that
    completes after ``seconds``; with ``trace``, the last
    ``trace_seconds`` of it under the profiler. Returns (records,
    window seconds, the traced stretch's summary or None)."""
    records, prof = [], None
    trace_from = seconds - float(c.traffic["trace_seconds"])
    start = time.perf_counter()
    while True:
        if (prof is None and trace
                and time.perf_counter() - start >= trace_from):
            # the profiler's own start-up is not the window's work
            t = time.perf_counter()
            prof = devtrace.Window(device)
            prof.__enter__()
            c.driver.traced = True
            seconds += time.perf_counter() - t
        try:
            rec = c.driver.issue(len(records))
        except Exception as exc:          # a failed request is counted
            log(f"request {len(records)} failed:\n{traceback.format_exc()}")
            rec = {"failed": repr(exc)}
        rec["traced"] = prof is not None
        records.append(rec)
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    tsum = None
    if prof is not None:
        prof.__exit__(None, None, None)
        c.driver.traced = False
        tsum = prof.summary(sum(r["traced"] for r in records))
    return records, window_s, tsum


def release(c: Cell, device) -> None:
    """Drop the program's state before the reference runs."""
    c.driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def judge(c: Cell, records: list, seed: int) -> dict:
    """The numbers compared, over a sample of the completed requests
    drawn from ``seed``."""
    ok = [r for r in records if "failed" not in r]
    if not ok:
        return {}
    picked = [ok[j] for j in sample(len(ok), int(c.checks["check_requests"]),
                                    seed)]
    return c.kind.judge(c.traffic, c.driver, picked)


def checked(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit}}; a number that could not be read (no
    answer, or not finite) is null, and fails."""
    out = {}
    for name, lim in limits.items():
        v = numbers.get(name)
        out[name] = {"value": (float(v) if v is not None and math.isfinite(v)
                               else None), "limit": lim}
    return out


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, root: str = ROOT, log=print) -> dict:
    """One run of ``workload``; returns the result line as a dict. ``t0``
    is the process's start on ``time.perf_counter``."""
    bench = Bench(root)
    dev = torch.device(device)
    c = setup(bench, workload, seed, dev)
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up {setup_s:.3f} s: {c.driver.shape}; {c.driver.timings}")
    records, window_s, tsum = window(c, seconds, trace, dev, log)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run = Run(c.traffic["kind"], c.driver.shape, setup_s, window_s, records,
              tsum)
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum("failed" in r for r in records)
    release(c, dev)
    t = time.perf_counter()
    checks = checked(judge(c, records, seed), c.checks["limits"])
    log(f"checked in {time.perf_counter() - t:.3f} s")
    result = {
        "correct": failed == 0 and passes(checks),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, c.spec["chips"], peak, tsum),
    }
    if tsum is not None:
        result["breakdown"] = tsum["breakdown"]
    result["checks"] = checks
    return result


def device_info(dev, chips: int, peak: int, tsum) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if tsum is not None:
        info["busy_s"] = tsum["busy_s"]
        info["window_s"] = tsum["window_s"]
    return info
