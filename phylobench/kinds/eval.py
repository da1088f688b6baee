"""Closed-loop evaluations, one caller: the program's compiled evaluator
(``engine.compile_fast_eval``, schedule ``auto``) is built once in
set-up; each request evaluates the tree at a new branch-length vector
(the tree's lengths, each times a factor drawn from U(lo, hi), as in an
optimizer's line search) and reads the logL back to the host before the
next is issued.

Judged: the logL of a sample of the window's requests against the
float64 reference at the same lengths (``lnl_gap``, relative)."""

from __future__ import annotations

import time

import torch

from phylobench.data import seed63
from phylobench.harness import span
from phylobench.reference import Reference, rel_gap, worst
from pllmod_tpu_torch.ops import engine


class Driver:
    def __init__(self, build, traffic, seed, device):
        self.cell = cell = build(seed)
        self.shape, self.traced = cell.shape, False
        t = time.perf_counter()
        self.ev = engine.compile_fast_eval(cell.part, cell.tree)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed63(seed) ^ 0x5EED)
        lo, hi = traffic["length_factor"]
        base = torch.as_tensor(cell.lengths, dtype=torch.float32,
                               device=device)
        u = torch.rand((int(traffic["vectors"]), len(base)), generator=gen,
                       device=device)
        self.lengths = base * (lo + (hi - lo) * u)
        for i in range(int(traffic["warmup"])):
            float(self.ev(cell.part, self.lengths[i]))
        self.timings = dict(cell.timings, warmup_s=time.perf_counter() - t)

    def issue(self, i: int) -> dict:
        k = i % len(self.lengths)
        brl = self.lengths[k]
        t0 = time.perf_counter()
        with span(self.traced, "phylobench.eval.call"):
            v = self.ev(self.cell.part, brl)
        t1 = time.perf_counter()
        with span(self.traced, "phylobench.eval.readback"):
            lnl = float(v)
        t2 = time.perf_counter()
        return {"latency_s": t2 - t0, "issue_s": t1 - t0, "vector": k,
                "answer": lnl}

    def release(self) -> None:
        self.ev = None
        self.cell.release()

    def inputs(self, rec):
        return self.lengths[rec["vector"]]


def judge(traffic, driver, records) -> dict:
    cell = driver.cell
    ref = Reference(cell.rooted, cell.model, cell.tips.to(
        driver.lengths.device))
    return {"lnl_gap": worst(rel_gap(rec["answer"],
                                     ref.loglik(driver.inputs(rec)))
                             for rec in records)}


def control(traffic, driver, rec):
    """The answer of the reference in TF32, put in the program's place."""
    cell = driver.cell
    ref = Reference(cell.rooted, cell.model,
                    cell.tips.to(driver.lengths.device),
                    dtype=torch.float32, tf32=True)
    return ref.loglik(driver.inputs(rec))
