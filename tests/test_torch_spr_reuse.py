"""The dirty-node protocol of the port's SPR round (``FULL_CLV_REUSE``
in ``algorithm/spr.py``: the full tree's directed CLVs kept across
applied moves, rebuilt only when a candidate's pruned subtree touches a
node an applied move changed) against a rebuild after every applied
move, in float64 on the CPU.

The case is 10 taxa × 150 sites simulated along the tree and started
after 4 random SPR moves: there the round applies moves and then reads
kept subtree CLVs whose subtrees hold changed nodes, so a protocol that
missed a dirty node would score those candidates from stale CLVs and
end elsewhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.algorithm import spr
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def case():
    c = make_case(11, 10, 150, symbols="ACGT", dtype=jnp.float64)
    start = c.tree.copy()
    flagship.random_spr(start, 4, np.random.default_rng(2))
    return c, start


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["fast", "thorough"])
def test_full_clv_reuse_matches_rebuild(case, monkeypatch, thorough):
    """With the protocol and without it, through the same batched driver
    (``SPR_BATCH_MAX`` 8): the same moves, top list (each entry's logL
    included), tree and lengths, and the same logL bit for bit; the
    protocol builds the full-tree CLVs fewer times."""
    c, start = case
    monkeypatch.setattr(spr, "SPR_BATCH_MAX", 8)
    out = {}
    for reuse in (True, False):
        monkeypatch.setattr(spr, "FULL_CLV_REUSE", reuse)
        ti = TreeInfo(start.copy(), [c.tpart])
        stats = {}
        lnl, n, top = spr.spr_round(ti, radius_min=1,
                                    radius_max=5 if thorough else 10,
                                    thorough=thorough, stats=stats)
        out[reuse] = (lnl, n, [(e.prune_edge, e.junction, e.regraft_edge,
                                e.lnl) for e in top], ti.tree, stats)
    lnl, n, top, tree, stats = out[True]
    lnl0, n0, top0, tree0, stats0 = out[False]
    assert n > 1 and stats["full_builds"] < stats0["full_builds"]
    assert (n, top, lnl) == (n0, top0, lnl0)
    assert np.array_equal(tree.edge_nodes, tree0.edge_nodes)
    assert np.array_equal(tree.lengths, tree0.lengths)
