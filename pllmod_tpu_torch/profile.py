"""Work counters — the port's copy of ``pllmod_tpu.profile``'s
:class:`Counters` and :func:`timed` (the reference's ``treeinfo->counter``
CLV-op accumulator, treeinfo.c:1017). Importing the JAX package's module
would run its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


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
