"""The port's full ML search (``algorithm/search.py``) on the CPU.

- One JAX ``ml_search`` and one of the port from the same start (8 taxa
  × 150 sites simulated along the tree, float64, two SPR moves off the
  simulating tree; two fast rounds, then a thorough one): the same
  rounds (mode, radius, applied moves), each round's logL within 1e-9
  relative, the same final tree.
- The port's checkpoint after its first round, resumed into a fresh
  TreeInfo: the first round kept, the end at or above the uninterrupted
  run's less 0.1 (the cutoff's ``drops`` are not checkpointed, as in the
  JAX package, so a resumed round may apply other moves); resumed into a
  float32 TreeInfo with warm caches: the restored partitions in its
  dtype, no cache of the state before the swap left, and its logL equal
  bit for bit to a fresh TreeInfo's on the restored state.
- Two SCALED partitions through the search.
- The ``search`` command at ``--device cpu`` equals ``ml_search`` called
  directly from the same parsimony start.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.algorithm.search import ml_search as jax_ml_search
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import cli, common, flagship
from pllmod_tpu_torch.algorithm import search
from pllmod_tpu_torch.algorithm.opt_model import opt_model
from pllmod_tpu_torch.algorithm.search import ml_search
from pllmod_tpu_torch.msa.io import write_fasta
from pllmod_tpu_torch.msa.msa import MSA
from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree import starting
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

MASK = common.PARAM_BRANCHES_ITERATIVE
KW = dict(radius_step=2, radius_max=2, max_rounds=3, lh_epsilon=0.01)


@pytest.fixture(scope="module")
def case():
    """The simulated case and its start, two random SPR moves off the
    simulating tree."""
    c = make_case(31, 8, 150, symbols="ACGT", dtype=jnp.float64)
    start = c.tree.copy()
    flagship.random_spr(start, 2, np.random.default_rng(32))
    return c, start


@pytest.fixture(scope="module")
def jax_search(case):
    c, start = case
    jti = JaxTreeInfo(JaxTree(start.n_tips, list(start.labels),
                              start.edge_nodes.copy(), start.lengths.copy(),
                              start.n_nodes), [c.jpart],
                      params_to_optimize=MASK)
    return jax_ml_search(jti, **KW), jti


@pytest.fixture(scope="module")
def port_search(case, tmp_path_factory):
    """The port's search, checkpointed; the checkpoint after round 1
    copied aside. Returns (result, TreeInfo, the copy's path)."""
    c, start = case
    d = tmp_path_factory.mktemp("search")
    ck, ck1 = str(d / "search.ck"), str(d / "round1.ck")
    seen = []

    def on_round(rec):
        seen.append(rec)
        if len(seen) == 1:
            shutil.copy(ck, ck1)

    ti = TreeInfo(start.copy(), [c.tpart], params_to_optimize=MASK)
    res = ml_search(ti, checkpoint_path=ck, on_round=on_round, **KW)
    assert res.rounds == seen
    return res, ti, ck1


def test_ml_search_matches_jax(case, jax_search, port_search):
    (jres, jti), (res, ti, _) = jax_search, port_search
    assert [(r.mode, r.radius, r.n_applied) for r in res.rounds] == [
        (r.mode, r.radius, r.n_applied) for r in jres.rounds]
    assert {r.mode for r in res.rounds} == {"fast", "thorough"}
    assert res.rounds[0].n_applied > 0
    for got, want in zip([res.start_loglh, res.loglh]
                         + [r.loglh for r in res.rounds],
                         [jres.start_loglh, jres.loglh]
                         + [r.loglh for r in jres.rounds]):
        assert abs(got - want) <= 1e-9 * abs(want)
    np.testing.assert_array_equal(ti.tree.edge_nodes, jti.tree.edge_nodes)
    assert res.loglh > res.start_loglh
    assert abs(ti.compute_loglh() - res.loglh) <= 1e-9 * abs(res.loglh)


def test_resume_keeps_history(case, port_search, tmp_path):
    """Resumed into a fresh TreeInfo from the start tree: the first
    round kept, the rest run from the recorded stage and radius."""
    c, start = case
    res_full, _, ck1 = port_search
    ck = str(tmp_path / "resume.ck")      # the resumed run writes on it
    shutil.copy(ck1, ck)
    ti = TreeInfo(start.copy(), [c.tpart], params_to_optimize=MASK)
    res = ml_search(ti, checkpoint_path=ck, resume=True, **KW)
    assert res.rounds[0] == res_full.rounds[0]
    assert res.n_rounds == res_full.n_rounds
    assert res.start_loglh == res_full.start_loglh
    assert res.loglh >= res_full.loglh - 0.1
    assert abs(ti.compute_loglh() - res.loglh) <= 1e-9 * abs(res.loglh)


def test_resume_replaces_state_in_place(case, port_search, monkeypatch,
                                        tmp_path):
    """Resumed into a float32 TreeInfo whose evaluator, incremental
    buffers and edge tables are warm: at the first round after the swap
    none is left, the partitions are float32 on the CPU, and the logL
    equals a fresh TreeInfo's on the restored state bit for bit."""
    c, start = case
    res_full, _, ck1 = port_search
    ck = str(tmp_path / "resume.ck")
    shutil.copy(ck1, ck)
    ti = TreeInfo(start.copy(), [c.tpart.to(dtype=torch.float32)],
                  params_to_optimize=MASK | common.PARAM_FREQUENCIES)
    ti.compute_loglh()
    ti.compute_loglh(incremental=True)
    opt_model(ti, tol=1e-2)
    assert ti._fast_cache and ti._incr_cache and ti._edge_tables
    seen = []
    real = search.spr_round

    def spy(treeinfo, **kw):
        if not seen:
            fresh = TreeInfo(treeinfo.tree.copy(), list(treeinfo.partitions),
                             brlen_linkage=treeinfo.brlen_linkage,
                             params_to_optimize=treeinfo.params_to_optimize)
            fresh.brlen_scalers = treeinfo.brlen_scalers.copy()
            seen.append(dict(
                empty=not (treeinfo._fast_cache or treeinfo._incr_cache
                           or treeinfo._edge_tables),
                dtypes={p.dtype for p in treeinfo.partitions},
                devices={p.device.type for p in treeinfo.partitions},
                masks=list(treeinfo.params_to_optimize),
                lnl=treeinfo.compute_loglh(), fresh=fresh.compute_loglh()))
        return real(treeinfo, **kw)

    monkeypatch.setattr(search, "spr_round", spy)
    res = ml_search(ti, checkpoint_path=ck, resume=True,
                    **dict(KW, max_rounds=2))
    s = seen[0]
    assert s["empty"] and s["dtypes"] == {torch.float32}
    assert s["devices"] == {"cpu"} and s["masks"] == [MASK]
    assert s["lnl"] == s["fresh"]
    assert res.rounds[0] == res_full.rounds[0] and res.n_rounds == 2
    assert (res.rounds[1].mode, res.rounds[1].radius) == (
        res_full.rounds[1].mode, res_full.rounds[1].radius)


def test_ml_search_two_scaled_partitions():
    """Two SCALED-linkage partitions: summed scores drive the rounds and
    the interleaved model optimization; the final state is consistent
    and above the start."""
    rng = np.random.default_rng(41)
    labels = [f"t{i}" for i in range(7)]
    truth = starting.random_tree(labels, seed=5)
    truth.lengths = rng.uniform(0.05, 0.3, len(truth.lengths))
    rates, freqs = np.array([1.0, 3.0, 1.0, 1.0, 3.0, 1.0]), np.full(4, 0.25)
    parts = [create_partition(
        flagship.simulate(rng, truth, n, rates, freqs, "ACGT", alpha=a),
        states=4, n_rate_cats=k, alpha=a, subst_rates=rates, freqs=freqs,
        dtype=torch.float64, device="cpu")
        for n, a, k in ((120, 1.0, 4), (90, 0.6, 2))]
    start = truth.copy()
    flagship.random_spr(start, 2, np.random.default_rng(42))
    ti = TreeInfo(start, parts, brlen_linkage=common.BRLEN_SCALED,
                  params_to_optimize=(common.PARAM_ALPHA
                                      | common.PARAM_BRANCH_LEN_SCALER
                                      | common.PARAM_BRANCHES_ITERATIVE))
    res = ml_search(ti, radius_step=2, radius_max=2, lh_epsilon=0.05,
                    max_rounds=2, thorough=False)
    assert res.loglh > res.start_loglh and res.n_rounds == 2
    assert abs(ti.compute_loglh() - res.loglh) < 1e-4
    assert np.all(ti.brlen_scalers > 0)
    assert ti.brlen_scalers[0] != ti.brlen_scalers[1]


def test_search_command_matches_ml_search(tmp_path):
    """``search`` at ``--device cpu`` (parsimony start, JC+G4) against
    ``ml_search`` from the same start: equal rounds, logL and tree."""
    c = make_case(43, 6, 60, symbols="ACGT", dtype=jnp.float64)
    msa = MSA(list(c.tree.labels), c.seqs)
    path = str(tmp_path / "a.fasta")
    write_fasta(msa, path)
    args = cli.parse_args(["search", "--msa", path, "--model", "JC+G4",
                           "--radius-max", "2", "--seed", "3",
                           "--device", "cpu"])
    got = args.fn(args)
    part, _, mask = cli.build_partition(msa, "JC+G4", device="cpu")
    start, _ = starting.parsimony_stepwise(msa.labels, msa.sequences,
                                           charmap.DNA, seed=3)
    ti = TreeInfo(start, [part], params_to_optimize=mask)
    want = ml_search(ti, radius_step=5, radius_max=2, lh_epsilon=0.1)
    assert got["result"].rounds == want.rounds
    assert got["result"].loglh == want.loglh
    np.testing.assert_array_equal(got["treeinfo"].tree.edge_nodes,
                                  ti.tree.edge_nodes)
