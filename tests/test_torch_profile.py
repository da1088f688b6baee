"""``pllmod_tpu_torch.profile``: ``trace`` (the JAX package's
``profile.trace`` over ``torch.profiler``) writes a Chrome trace of the
serial engine's ops on the CPU, yields its directory and starts nothing
at import; the counters match the JAX package's."""

import glob
import json
import os

import numpy as np
import torch

from pllmod_tpu import profile as jax_profile
from pllmod_tpu_torch import flagship, profile
from pllmod_tpu_torch.ops import engine
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def test_trace_writes_the_serial_engines_ops(tmp_path):
    assert not torch.autograd._profiler_enabled()
    part, tree = flagship.example(8, 64, dtype=torch.float64, device="cpu")
    logdir = str(tmp_path / "trace")
    with profile.trace(logdir) as got:
        assert got == logdir
        assert torch.autograd._profiler_enabled()
        lnl = float(engine.tree_loglikelihood(part, tree, schedule="scan"))
    assert not torch.autograd._profiler_enabled()
    assert np.isfinite(lnl)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    # the serial engine: the pruning products and the frexp rescale
    assert {"aten::einsum", "aten::frexp"} <= names
    with profile.trace(logdir):
        engine.tree_loglikelihood(part, tree, schedule="scan")
    assert len(glob.glob(os.path.join(logdir, "*.pt.trace.json"))) == 2


def test_counters_match_jax():
    want, got = jax_profile.Counters(), profile.Counters()
    for c in (want, got):
        c.add_traversal(126, 16384)
        c.add_traversal(126, 16384)
        c.wall_s = 0.5
    assert got.report() == want.report()
    assert got.updates_per_s == want.updates_per_s
