"""The port's spans, recorder and launch registry
(``pllmod_tpu_torch.profile``): a span is a shared no-op outside a
profiler session; under ``profile.trace`` one BLO call records its root
and its steps, nested, on the clock of the profiler's own events and in
its Chrome trace; ``reset`` empties the recorder and the registry; CPU
tensors launch nothing. On a card (tests marked ``cuda``, which skip
without one) the spans' launches are the registry's.

JAX-free, so the card tests run where the JAX package does not:

    python -m pytest tests/test_torch_spans.py -q -m cuda
"""

import glob
import json
import os
import shutil

import pytest
import torch

from pllmod_tpu_torch import flagship, profile
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.optimize import blo

BLO_STEPS = ("prep", "sweep", "subsweep", "walk", "sumtables", "newton",
             "final", "wait")
# where each step's span opens (None: a root)
PARENTS = {"pllmod.blo": (None,),
           "pllmod.blo.prep": ("pllmod.blo",),
           "pllmod.blo.sweep": ("pllmod.blo",),
           "pllmod.blo.subsweep": ("pllmod.blo.sweep",),
           "pllmod.blo.walk": ("pllmod.blo.subsweep", "pllmod.blo.final"),
           "pllmod.blo.sumtables": ("pllmod.blo.subsweep",
                                    "pllmod.blo.final"),
           "pllmod.blo.newton": ("pllmod.blo.subsweep",),
           "pllmod.blo.final": ("pllmod.blo",),
           "pllmod.blo.wait": ("pllmod.blo", "pllmod.blo.sweep")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profile.reset()
    yield
    profile.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    return flagship.example(10, 96, dtype=torch.float64, device="cpu")


def _blo(part, tree):
    return blo.optimize_branch_lengths(part, tree.copy(), max_sweeps=2)


def _chrome_events(logdir):
    """(name, start ns, end ns) of every complete event of the Chrome
    trace in ``logdir``, on the clock of ``time.time_ns``."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    return [(e["name"], base + 1e3 * e["ts"], base + 1e3 * (e["ts"]
                                                          + e["dur"]))
            for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_span_is_a_shared_noop_outside_a_session(case):
    assert not torch.autograd._profiler_enabled()
    assert profile.span("pllmod.a") is profile.span("pllmod.b")
    _blo(*case)
    assert profile.SPANS == [] and profile.summary() == {}


def test_blo_call_records_its_steps(case, tmp_path):
    logdir = str(tmp_path / "trace")
    with profile.trace(logdir):
        _blo(*case)
    spans = profile.SPANS
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["pllmod.blo"]
    assert {s.name for s in spans} == {"pllmod.blo"} | {
        f"pllmod.blo.{step}" for step in BLO_STEPS}
    for s in spans:
        assert s.root == roots[0] and s.end_ns >= s.start_ns > 0
        parent = spans[s.parent] if s.parent >= 0 else None
        assert (parent and parent.name) in PARENTS[s.name], s
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    got = profile.summary()
    root = got["pllmod.blo"]
    assert root["count"] == 1
    self_ns = sum(row["self_ns"] for row in got.values())
    assert abs(self_ns - root["total_ns"]) <= 0.01 * root["total_ns"]
    # each span inside its own profiler event, give or take 1 ms
    events = {}
    for name, s, e in sorted(_chrome_events(logdir), key=lambda x: x[1]):
        events.setdefault(name, []).append((s, e))
    for name in got:
        assert len(events[name]) == got[name]["count"], name
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        for (s, e), (ks, ke) in zip(mine, events[name]):
            assert ks - 1e6 <= s <= e <= ke + 1e6, name


def test_reset_empties_the_recorder_and_the_registry(case, tmp_path):
    with profile.trace(str(tmp_path)):
        _blo(*case)
    profile.LAUNCHES["pllmod_fused_walk"] += 1
    profile.RESIDENT_LAUNCHES["thread"] += 1
    assert profile.SPANS and profile.LAUNCHES.total() == 1
    profile.reset()
    assert profile.SPANS == [] and not profile.LAUNCHES
    assert not profile.RESIDENT_LAUNCHES
    assert profile.summary() == {}


def test_cpu_tensors_launch_nothing(tmp_path):
    part, tree = flagship.example(10, 96, device="cpu")    # float32
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32)
    with profile.trace(str(tmp_path)):
        ev = engine.compile_fast_eval(part, tree)
        float(ev(part, brl))
        _blo(part, tree)
    got = profile.summary()
    assert {"pllmod.eval", "pllmod.eval.pmats", "pllmod.eval.walk",
            "pllmod.eval.root", "pllmod.blo.newton"} <= set(got)
    assert all(row["launches"] == 0 for row in got.values())
    assert not profile.LAUNCHES and not profile.RESIDENT_LAUNCHES


def test_trace_writes_a_fresh_directory(case):
    with profile.trace() as logdir:
        _blo(*case)
    try:
        assert os.path.basename(logdir).startswith("pllmod_trace_")
        assert os.path.abspath(logdir) != "/tmp/pllmod_trace"
        with open(glob.glob(os.path.join(logdir, "*.pt.trace.json"))[0]) \
                as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert {"pllmod.blo", "pllmod.blo.sweep", "pllmod.blo.wait"} <= names
    finally:
        shutil.rmtree(logdir)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_blo_launches_are_the_registrys(cuda, tmp_path):
    """A 246 × 4465 BLO call: the launches inside ``pllmod.blo`` are the
    registry's, all of them kernels 2, 8, 9 and 10."""
    part, tree = flagship.example(246, 4465, device=cuda)
    part = part.cache_eigen()
    blo.optimize_branch_lengths(part, tree.copy())         # warm
    with profile.trace(str(tmp_path)):
        blo.optimize_branch_lengths(part, tree.copy())
    got = profile.summary()["pllmod.blo"]
    kernels = ("pllmod_fused_walk", "pllmod_edge_sumtables",
               "pllmod_edge_derivs", "pllmod_newton_edges")
    assert got["count"] == 1 and got["launches"] > 0
    assert got["launches"] == profile.LAUNCHES.total() == sum(
        profile.LAUNCHES[k] for k in kernels)


@pytest.mark.cuda
def test_eval_span_holds_one_resident_launch(cuda, tmp_path):
    part, tree = flagship.example(64, 4096, device=cuda)
    ev = engine.compile_fast_eval(part, tree, schedule="resident")
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32, device=cuda)
    float(ev(part, brl))                                   # warm
    with profile.trace(str(tmp_path)):
        float(ev(part, brl))
    assert profile.summary()["pllmod.eval"]["launches"] == 1
    assert dict(profile.LAUNCHES) == {"pllmod_resident_walk": 1}
    # DNA +G4: kernel 1's thread kind, counted beside the registry
    assert dict(profile.RESIDENT_LAUNCHES) == {"thread": 1}
