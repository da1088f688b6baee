"""The port's model-parameter optimization at 20 states against the JAX
package's, in float64 on the CPU (the bars of ``test_torch_opt_model.py``):

- the rates and alpha+pinv families and one ``opt_model`` round (LG-like:
  the exchangeabilities fixed) on an 8-taxon case of 200 sites simulated
  along the tree;
- the rates family runs under a 10-class symmetry: the all-free
  189-dimension L-BFGS on 200 simulated sites is a flat ridge where the
  two packages' rounding sends their one-call endpoints apart by more
  than the bar, and a second call moves each by more than it; the
  189-dimension case is the PROTGTR canary below, with its own
  criterion;
- the PROTGTR canary of ``tools/tpu_parity.py`` (10 taxa × 256 random
  sites, 20 states, ``opt_subst_rates`` at tol 1e-3) in float32 (the
  plain kernel path) and float64: a float64 restart from the endpoint
  gains ≤ 0.05.
"""

import numpy as np
import pytest
import torch

from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm import opt_model as om
from pllmod_tpu_torch.flagship import random_newick
from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.test_torch_opt_model import _case, check_family
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

SYM20 = np.arange(190) % 10


@pytest.fixture(scope="module")
def case():
    return _case(20, 8, 200, 6)


@pytest.mark.parametrize("family", ["rates", "alpha_pinv", "opt_model"])
def test_family_matches_jax(case, family):
    check_family(*case, 20, family, sym=[SYM20])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_protgtr_canary(dtype):
    """The 189-dimension PROTGTR canary (tools/tpu_parity.py:306-370)
    at its own size: the float64 restart from the endpoint gains ≤ 0.05
    logL (host-polish stationarity)."""
    rng = np.random.default_rng(0)
    n, sites = 10, 256
    tree = Tree.from_newick(random_newick(n, rng))
    syms = np.array(list(charmap.MULTI_SYMBOLS[:20]))
    seqs = ["".join(r) for r in syms[rng.integers(0, 20, (n, sites))]]

    def part(dt, rates=None):
        r = np.random.default_rng(5)
        p = create_partition(seqs, states=20, n_rate_cats=4,
                             charmap=charmap.multistate(20), alpha=0.8,
                             subst_rates=r.uniform(0.5, 2.0, 190),
                             freqs=r.dirichlet([8] * 20), compress=False,
                             dtype=dt, device="cpu")
        if rates is not None:
            p = p.with_model_params(subst_rates=rates)
        return p.cache_eigen()

    ti = TreeInfo(tree.copy(), [part(dtype)],
                  params_to_optimize=common.PARAM_SUBST_RATES)
    start = ti.compute_loglh()
    lnl = om.opt_subst_rates(ti, tol=1e-3)
    assert lnl > start
    rates = ti.partitions[0].subst_rates.to(torch.float64)
    polish = TreeInfo(tree.copy(), [part(torch.float64, rates)],
                      params_to_optimize=common.PARAM_SUBST_RATES)
    at_end = polish.compute_loglh()
    assert at_end == pytest.approx(lnl, rel=1e-6)
    gain = om.opt_subst_rates(polish, tol=1e-3) - at_end
    assert gain <= 0.05
