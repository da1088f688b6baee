"""The port's drivers against a site-sharded TreeInfo
(``parallel.shard_treeinfo``) on CPU devices, in float64, each against
the same driver unsharded (within 1e-10 relative) and, where the JAX
package's run is cheap, against its unsharded driver (1e-9):

- the BLO: the single-partition driver (``mesh=``) and the treeinfo
  BLO, LINKED and SCALED (every Newton iteration's derivatives reduced
  over the shards);
- ``opt_alpha`` (the Brent lanes through a reducing evaluator) and
  ``opt_subst_rates`` (L-BFGS over the edge decomposition, reduced);
- one fast and one thorough ``spr_round`` on ``tests/test_torch_spr.py``'s
  case (whose unsharded rounds that file holds against the JAX
  package's): the same applied moves, RF 0;
- a two-round ``ml_search`` on ``tests/test_torch_search.py``'s case:
  RF 0 to the unsharded run; its checkpoint holds whole partitions
  (loads unsharded) and a resume re-shards onto the TreeInfo's mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pllmod_tpu.algorithm.opt_model import opt_alpha as jax_opt_alpha
from pllmod_tpu.algorithm.opt_model import \
    opt_subst_rates as jax_opt_subst_rates
from pllmod_tpu.common import BRLEN_LINKED as JAX_LINKED
from pllmod_tpu.common import BRLEN_SCALED as JAX_SCALED
from pllmod_tpu.optimize.blo import optimize_branch_lengths as jax_blo
from pllmod_tpu.optimize.blo import \
    optimize_branch_lengths_treeinfo as jax_blo_treeinfo
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import common, flagship
from pllmod_tpu_torch.algorithm import spr
from pllmod_tpu_torch.algorithm.opt_model import opt_alpha, opt_subst_rates
from pllmod_tpu_torch.algorithm.search import ml_search
from pllmod_tpu_torch.binary import load_treeinfo
from pllmod_tpu_torch.optimize.blo import (optimize_branch_lengths,
                                           optimize_branch_lengths_treeinfo)
from pllmod_tpu_torch.parallel import is_sharded, make_mesh, shard_treeinfo
from pllmod_tpu_torch.tree import splits
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case, rel_err
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

SCALERS = (1.0, 1.7)
LINKAGE = {"LINKED": (common.BRLEN_LINKED, JAX_LINKED),
           "SCALED": (common.BRLEN_SCALED, JAX_SCALED)}
MESH4 = ["cpu"] * 4
MESH2 = ["cpu"] * 2


@pytest.fixture(scope="module")
def pair_case():
    """Two alignments simulated along one 10-taxon tree (200 sites each;
    the second from another seed), float64."""
    return (make_case(21, 10, 200, symbols="ACGT", dtype=jnp.float64),
            make_case(22, 10, 200, symbols="ACGT", dtype=jnp.float64))


def _tis(cases, linkage="LINKED", mesh=MESH4):
    """(unsharded port TreeInfo, sharded port TreeInfo, JAX TreeInfo) of
    the two partitions on the first case's tree."""
    mine, theirs = LINKAGE[linkage]
    tree, jtree = cases[0].tree, cases[0].jtree
    out = []
    for _ in range(2):
        ti = TreeInfo(tree.copy(), [c.tpart for c in cases],
                      brlen_linkage=mine)
        ti.brlen_scalers[:] = SCALERS if linkage == "SCALED" else (1, 1)
        out.append(ti)
    shard_treeinfo(out[1], make_mesh(mesh))
    jti = JaxTreeInfo(jtree.copy(), [c.jpart for c in cases],
                      brlen_linkage=theirs)
    jti.brlen_scalers[:] = SCALERS if linkage == "SCALED" else (1, 1)
    return out[0], out[1], jti


@pytest.mark.parametrize("linkage", ["LINKED", "SCALED"])
def test_sharded_treeinfo_blo(pair_case, linkage):
    ref, ti, jti = _tis(pair_case, linkage)
    stats = {}
    got = optimize_branch_lengths_treeinfo(ti, stats=stats)
    assert stats["newton_edges"] == 0 and stats["iterative_edges"] > 0
    want = optimize_branch_lengths_treeinfo(ref, fused_newton=False)
    assert rel_err(got, want) < 1e-10
    np.testing.assert_allclose(ti.tree.lengths, ref.tree.lengths,
                               rtol=1e-8, atol=1e-12)
    assert rel_err(got, jax_blo_treeinfo(jti)) < 1e-9
    assert rel_err(ti.compute_loglh(), got) < 1e-10


def test_sharded_single_partition_blo(pair_case):
    """``optimize_branch_lengths(mesh=...)``: the colored smoothing driver
    on a partition sharded four ways (kernel 10 off) against the same
    driver unsharded over kernel 9's route and the JAX package's."""
    c = pair_case[0]
    part = c.tpart.cache_eigen()
    stats = {}
    new, got = optimize_branch_lengths(part, c.tree.copy(), stats=stats,
                                       mesh=make_mesh(MESH4))
    assert stats["newton_edges"] == 0
    want_brl, want = optimize_branch_lengths(part, c.tree.copy(),
                                             fused_newton=False)
    assert rel_err(got, want) < 1e-10
    np.testing.assert_allclose(new.numpy(), want_brl.numpy(), rtol=1e-8,
                               atol=1e-12)
    assert rel_err(got, jax_blo(c.jpart, c.jtree.copy())[1]) < 1e-9


@pytest.mark.parametrize("family", ["opt_alpha", "opt_subst_rates"])
def test_sharded_opt_model_families(pair_case, family):
    """The Brent lanes (alpha) and the L-BFGS lanes (rates), sharded four
    ways: logL, per-partition logL and parameters as unsharded."""
    mine, theirs = {"opt_alpha": (opt_alpha, jax_opt_alpha),
                    "opt_subst_rates": (opt_subst_rates,
                                        jax_opt_subst_rates)}[family]
    ref, ti, jti = _tis(pair_case)
    got = mine(ti)
    assert rel_err(got, mine(ref)) < 1e-10
    assert rel_err(got, theirs(jti)) < 1e-9
    np.testing.assert_allclose(ti.partition_loglh, ref.partition_loglh,
                               rtol=1e-10)
    for p, q in zip(ti.partitions, ref.partitions):
        assert is_sharded(p)
        for f in ("alpha", "subst_rates", "rate_cats"):
            np.testing.assert_allclose(getattr(p, f).numpy(),
                                       getattr(q, f).numpy(), rtol=1e-8)
            for s in p.shards:
                assert torch.equal(getattr(s, f), getattr(p, f))


@pytest.fixture(scope="module")
def spr_case():
    """tests/test_torch_spr.py's case and start."""
    c = make_case(11, 9, 150, symbols="ACGT", dtype=jnp.float64)
    start = c.tree.copy()
    flagship.random_spr(start, 3, np.random.default_rng(2))
    return c, start


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["fast", "thorough"])
def test_sharded_spr_round(spr_case, thorough):
    c, start = spr_case
    kw = dict(radius_min=1, radius_max=5 if thorough else 10,
              thorough=thorough)
    ref = TreeInfo(start.copy(), [c.tpart])
    ti = shard_treeinfo(TreeInfo(start.copy(), [c.tpart]), make_mesh(MESH2))
    want, n_ref, top_ref = spr.spr_round(ref, **kw)
    got, n, top = spr.spr_round(ti, **kw)
    assert n == n_ref and n > 0
    assert [(e.prune_edge, e.junction, e.regraft_edge) for e in top] == [
        (e.prune_edge, e.junction, e.regraft_edge) for e in top_ref]
    assert np.array_equal(ti.tree.edge_nodes, ref.tree.edge_nodes)
    assert splits.rf_distance(ti.tree, ref.tree) == 0
    assert rel_err(got, want) < 1e-10


SEARCH_KW = dict(radius_step=2, radius_max=2, max_rounds=2, lh_epsilon=0.01)


def test_sharded_ml_search_and_resume(tmp_path):
    """tests/test_torch_search.py's case: a two-round search sharded two
    ways against the unsharded one (the same rounds, RF 0); its
    checkpoint holds whole partitions; a resume into a sharded TreeInfo
    re-shards the restored partitions, one into a plain TreeInfo keeps
    them whole, and both end where the first run ended."""
    c = make_case(31, 8, 150, symbols="ACGT", dtype=jnp.float64)
    start = c.tree.copy()
    flagship.random_spr(start, 2, np.random.default_rng(32))
    mask = common.PARAM_BRANCHES_ITERATIVE

    def fresh(sharded):
        ti = TreeInfo(start.copy(), [c.tpart], params_to_optimize=mask)
        return shard_treeinfo(ti, make_mesh(MESH2)) if sharded else ti

    ck = str(tmp_path / "search.ck")
    ref, ti = fresh(False), fresh(True)
    want = ml_search(ref, **SEARCH_KW)
    got = ml_search(ti, checkpoint_path=ck, **SEARCH_KW)
    assert [(r.mode, r.radius, r.n_applied) for r in got.rounds] == [
        (r.mode, r.radius, r.n_applied) for r in want.rounds]
    assert rel_err(got.loglh, want.loglh) < 1e-10
    assert splits.rf_distance(ti.tree, ref.tree) == 0
    loaded, _ = load_treeinfo(ck, device="cpu")
    assert not is_sharded(loaded.partitions[0])
    for f in ("tip_states", "pattern_weights", "inv_indicator"):
        assert torch.equal(getattr(loaded.partitions[0], f),
                           getattr(c.tpart, f))
    for sharded in (True, False):
        ti2 = fresh(sharded)
        ti2.compute_loglh()                  # warm caches to be dropped
        res = ml_search(ti2, checkpoint_path=ck, resume=True, **SEARCH_KW)
        p = ti2.partitions[0]
        assert is_sharded(p) == sharded
        if sharded:
            assert len(p.shards) == 2 and p.mesh == ti2.mesh
        assert res.rounds == got.rounds
        assert rel_err(res.loglh, got.loglh) < 1e-9
