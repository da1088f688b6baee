"""Observability — the port's ``pllmod_tpu.profile``: work counters
(:class:`Counters` and :func:`timed`, copies of the JAX package's: the
reference's ``treeinfo->counter`` CLV-op accumulator, treeinfo.c:1017)
and :func:`trace`, the profiler context, over ``torch.profiler`` where
the JAX package's is over ``jax.profiler``. Importing the JAX package's
module would run its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Counters:
    """Work counters (units of the north-star metric)."""
    clv_updates: int = 0      # inner-node × pattern CLV recomputations
    loglh_evals: int = 0
    newton_iters: int = 0
    wall_s: float = 0.0

    def add_traversal(self, n_inner: int, n_patterns: int):
        self.clv_updates += n_inner * n_patterns
        self.loglh_evals += 1

    @property
    def updates_per_s(self) -> float:
        return self.clv_updates / self.wall_s if self.wall_s > 0 else 0.0

    def report(self) -> str:
        return (f"clv_updates={self.clv_updates} "
                f"loglh_evals={self.loglh_evals} "
                f"wall={self.wall_s:.3f}s "
                f"rate={self.updates_per_s / 1e9:.3f}G updates/s")


@contextlib.contextmanager
def timed(counters: Counters):
    """Accumulate host wall time into ``counters``."""
    t0 = time.perf_counter()
    try:
        yield counters
    finally:
        counters.wall_s += time.perf_counter() - t0



@contextlib.contextmanager
def trace(logdir: str = "/tmp/pllmod_trace"):
    """Profile the block with ``torch.profiler`` (``profile.trace``):
    host (CPU) activity always, the card's (CUDA) activity where torch
    sees one. On exit the trace is written into ``logdir`` as a Chrome
    trace (``torch.profiler.tensorboard_trace_handler``: one
    ``<host>_<pid>.<ms>.pt.trace.json`` a block, which chrome://tracing,
    Perfetto and TensorBoard's profiler plugin read). Yields ``logdir``,
    as the JAX package's does. Nothing starts at import."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
