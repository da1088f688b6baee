"""The per-layer metrics that read the program's spans, on a recorder
filled by hand: each reads its value, and nothing for the other request
kind or where no span was recorded."""

import pytest

from phylobench import harness
from pllmod_tpu_torch import profile

BLO = ("blo_host_ms", "blo_wait_ms", "blo_prep_ms", "blo_launches")
MS = 1_000_000


@pytest.fixture(autouse=True)
def empty_recorder():
    profile.reset()
    yield
    profile.reset()


def metric(name):
    return harness.Bench().module("metrics", name)


def run_of(kind, problems=()):
    records = [{"latency_s": 0.1, "problem": k, "traced": True}
               for k in problems]
    return harness.Run(kind, {}, 1.0, 2.0, records, trace={})


def record(name, start_ms, end_ms, parent=-1, launches=0):
    """Append a closed span to the recorder; returns its index."""
    i = len(profile.SPANS)
    root = profile.SPANS[parent].root if parent >= 0 else i
    profile.SPANS.append(profile.Span(name, start_ms * MS, end_ms * MS,
                                      parent, root, launches))
    return i


def blo_call(t, launches):
    """A 10 ms BLO call from ``t``: 2 ms of prep, a 6 ms sweep holding a
    1 ms wait, and a 0.5 ms wait at the end."""
    root = record("pllmod.blo", t, t + 10, launches=launches)
    record("pllmod.blo.prep", t, t + 2, root)
    sweep = record("pllmod.blo.sweep", t + 2, t + 8, root, launches)
    record("pllmod.blo.wait", t + 7, t + 8, sweep)
    record("pllmod.blo.wait", t + 9.5, t + 10, root)


def test_blo_metrics_read_the_recorder():
    for t, n in ((0, 100), (20, 80), (40, 100)):
        blo_call(t, n)
    run = run_of("blo", problems=(0, 1, 0))
    assert metric("blo_host_ms").read(run) == pytest.approx(8.5)
    assert metric("blo_wait_ms").read(run) == pytest.approx(1.5)
    assert metric("blo_prep_ms").read(run) == pytest.approx(2.0)
    # problem 0's calls launch 100, problem 1's 80: 90, not 280 / 3
    assert metric("blo_launches").read(run) == pytest.approx(90.0)


def test_blo_launches_without_matching_requests():
    for t, n in ((0, 100), (20, 80), (40, 100)):
        blo_call(t, n)
    run = run_of("blo", problems=(0, 1))
    assert metric("blo_launches").read(run) == pytest.approx(280 / 3)


def test_eval_host_ms_reads_the_recorder():
    for t in (0, 5, 10):
        root = record("pllmod.eval", t, t + 2)
        record("pllmod.eval.walk", t + 1, t + 1.5, root, launches=1)
    assert metric("eval_host_ms").read(run_of("eval")) == pytest.approx(2.0)


@pytest.mark.parametrize("name", BLO + ("eval_host_ms",))
def test_nothing_for_the_other_kind_or_an_empty_recorder(name):
    kind = "eval" if name == "eval_host_ms" else "blo"
    other = "blo" if kind == "eval" else "eval"
    assert metric(name).read(run_of(kind)) is None
    blo_call(0, 100)
    root = record("pllmod.eval", 20, 22)
    record("pllmod.eval.walk", 20.5, 21, root, launches=1)
    assert metric(name).read(run_of(other)) is None
    assert metric(name).read(run_of(kind)) is not None
