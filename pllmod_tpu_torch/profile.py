"""Observability — the port's ``pllmod_tpu.profile`` and its one tracing
system:

- work counters (:class:`Counters` and :func:`timed`, copies of the JAX
  package's: the reference's ``treeinfo->counter`` CLV-op accumulator,
  treeinfo.c:1017);
- the launch registry :data:`LAUNCHES`: every C entry point's launches,
  counted in one place, ``ops/_build.launch``; beside it
  :data:`RESIDENT_LAUNCHES`, kernel 1's launches by kind;
- spans (:func:`span`, :func:`spanned`) at the layer boundaries of the
  evaluator and the BLO driver: while a ``torch.profiler`` session runs,
  each span is a ``record_function`` event in the profiler's trace, on
  the clock of the device's kernels, and a :class:`Span` record in this
  process's recorder (:data:`SPANS`, :func:`summary`); with no session a
  span is one flag read and a shared no-op context;
- :func:`trace`, the profiler context, over ``torch.profiler`` where the
  JAX package's is over ``jax.profiler``.

Importing the JAX package's module would run its ``__init__``, which
imports JAX. Nothing here starts at import.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import tempfile
import time

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class Counters:
    """Work counters (units of the north-star metric)."""
    clv_updates: int = 0      # inner-node × pattern CLV recomputations
    loglh_evals: int = 0
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


@dataclasses.dataclass
class Span:
    """One recorded span. Times are ``time.time_ns()``, the base of the
    profiler's own events (``start_ns()``, and the Chrome trace's
    ``baseTimeNanoseconds`` + ``ts``), so a span lies inside its
    ``record_function`` event. ``parent`` and ``root`` are indices into
    :data:`SPANS` (``parent`` −1 for a root, ``root`` its own index), so
    the spans of one call share their root's index; ``launches`` counts
    the launches issued inside the span, its children's included."""
    name: str
    start_ns: int
    end_ns: int = 0           # 0 while the span is open
    parent: int = -1
    root: int = -1
    launches: int = 0


# the recorder (the spans in the order entered) and the launch registry
# (launches by C entry point, kernel 10's K > 1 form under its own key,
# counted by ops/_build.launch alone); beside the registry, the resident
# walk's launches by kind (ops/_build.RESIDENT_KINDS: "tile", "global",
# "thread", "split"; counted by ops/_build.launch_walk), which LAUNCHES.total()
# does not count again; reset() empties all three
SPANS, LAUNCHES = [], collections.Counter()
RESIDENT_LAUNCHES = collections.Counter()
_OPEN: list[int] = []         # indices of the spans entered, not yet left


_OFF = contextlib.nullcontext()   # the span while no session runs


class _On:
    """The span under a profiler session: a ``record_function`` event and
    a :class:`Span` record."""
    __slots__ = ("name", "event", "index", "launched")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.event = torch.profiler.record_function(self.name)
        self.event.__enter__()
        self.index = i = len(SPANS)
        parent = _OPEN[-1] if _OPEN else -1
        root = SPANS[parent].root if parent >= 0 else i
        self.launched = LAUNCHES.total()
        _OPEN.append(i)
        SPANS.append(Span(self.name, time.time_ns(), parent=parent,
                          root=root))
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        i = self.index
        if _OPEN and _OPEN[-1] == i:          # not dropped by a reset()
            _OPEN.pop()
            rec = SPANS[i]
            rec.end_ns = end
            rec.launches = LAUNCHES.total() - self.launched
        self.event.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name``
    while a ``torch.profiler`` session runs, and does nothing otherwise
    (the test is the profiler's own module flag)."""
    if _autograd_profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that every call of it is the span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def summary() -> dict:
    """The recorder by span name: ``count``, ``total_ns``, ``self_ns``
    (each span's duration less the part its child spans cover) and
    ``launches`` (children's included), over the closed spans."""
    covered = [0] * len(SPANS)
    for s in SPANS:
        if s.end_ns and s.parent >= 0:
            covered[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s, child_ns in zip(SPANS, covered):
        if not s.end_ns:
            continue
        row = out.setdefault(s.name, dict(count=0, total_ns=0, self_ns=0,
                                          launches=0))
        row["count"] += 1
        row["total_ns"] += s.end_ns - s.start_ns
        row["self_ns"] += s.end_ns - s.start_ns - child_ns
        row["launches"] += s.launches
    return out


def reset() -> None:
    """Clear the recorder and zero :data:`LAUNCHES` and
    :data:`RESIDENT_LAUNCHES` (between spans: a span open across a reset
    is not recorded)."""
    SPANS.clear()
    _OPEN.clear()
    LAUNCHES.clear()
    RESIDENT_LAUNCHES.clear()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (``profile.trace``):
    host (CPU) activity always, the card's (CUDA) activity where torch
    sees one; the recorder is reset on entry, so that it holds the
    block's spans. On exit the trace is written into ``logdir`` (by
    default a new ``pllmod_trace_*`` directory under the temporary
    directory) as a Chrome trace (``torch.profiler.tensorboard_trace_
    handler``: one ``<host>_<pid>.<ms>.pt.trace.json`` a block, which
    chrome://tracing, Perfetto and TensorBoard's profiler plugin read;
    the spans are in it beside the kernels). Yields ``logdir``, as the
    JAX package's does."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="pllmod_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
