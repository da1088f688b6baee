"""Closed-loop branch-length optimizations, one caller, over a fixed set
of problems: ``problem_seeds`` draw that many alignments of the cell's
configuration (each with its own simulating tree), the same for every
run; the run's seed only shuffles the order in which the calls take
them, so that every run does the same work. Each call copies its
problem's start tree (the simulating topology, every length at
``start_length``) and runs ``blo.optimize_branch_lengths`` with the
port's defaults and ``stats=`` to its own convergence; its logL comes
back to the host as a float.

Judged, on a sample of the window's calls, against the float64
reference of the call's problem: ``lnl_gap``, the returned logL against
the reference's logL at the returned lengths; ``opt_gap``, the returned
logL against the reference's optimum, found by the reference's own
Newton sweeps from the returned lengths (both relative)."""

from __future__ import annotations

import time

import numpy as np
import torch

from phylobench.data import seed63
from phylobench.harness import span
from phylobench.reference import Reference, rel_gap, worst
from pllmod_tpu_torch.optimize import blo


class Driver:
    def __init__(self, build, traffic, seed, device):
        self.traced, self.device = False, device
        self.problems = [build(int(s)) for s in traffic["problem_seeds"]]
        self.shape = self.problems[0].shape
        self.timings = {k: sum(p.timings[k] for p in self.problems)
                        for k in self.problems[0].timings}
        t = time.perf_counter()
        self.order = np.random.default_rng(seed63(seed)).permutation(
            len(self.problems))
        self.starts = []
        for p in self.problems:
            start = p.tree.copy()
            start.lengths[:] = float(traffic["start_length"])
            self.starts.append(start)
        for _ in range(int(traffic["warmup"])):
            for p, start in zip(self.problems, self.starts):
                blo.optimize_branch_lengths(p.part, start.copy())
        self.timings["warmup_s"] = time.perf_counter() - t

    def issue(self, i: int) -> dict:
        k = int(self.order[i % len(self.order)])
        tree = self.starts[k].copy()
        stats = {}
        t0 = time.perf_counter()
        with span(self.traced, "phylobench.blo.call"):
            _, lnl = blo.optimize_branch_lengths(self.problems[k].part,
                                                 tree, stats=stats)
        t1 = time.perf_counter()
        return {"latency_s": t1 - t0, "stats": stats, "problem": k,
                "answer": (tree.lengths.copy(), float(lnl))}

    def release(self) -> None:
        for p in self.problems:
            p.release()

    def reference(self, k: int, **kw) -> Reference:
        p = self.problems[k]
        return Reference(p.rooted, p.model, p.tips.to(self.device), **kw)


def judge(traffic, driver, records) -> dict:
    lo, hi = float(traffic["min_length"]), float(traffic["max_length"])
    gaps, seen = {"lnl_gap": 0.0, "opt_gap": 0.0}, {}
    for rec in records:
        lengths, lnl = rec["answer"]
        key = (rec["problem"], lengths.tobytes(), lnl)
        if key not in seen:
            ref = driver.reference(rec["problem"])
            at = ref.loglik(lengths)
            _, best, _ = ref.optimize(lengths, lo, hi,
                                      float(traffic["reference_tol"]))
            seen[key] = (rel_gap(lnl, at), rel_gap(lnl, best))
        gaps["lnl_gap"] = worst([gaps["lnl_gap"], seen[key][0]])
        gaps["opt_gap"] = worst([gaps["opt_gap"], seen[key][1]])
    return gaps


def control(traffic, driver, rec):
    """The reference in TF32 put in the program's place: the lengths the
    call returned, and the logL that TF32 arithmetic gives there (the
    number a lower precision would change; the optimizer's path to the
    lengths is not run again)."""
    ref = driver.reference(rec["problem"], dtype=torch.float32, tf32=True)
    lengths, _ = rec["answer"]
    return lengths, ref.loglik(lengths)
