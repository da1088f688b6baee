"""The port's model-parameter optimization (``algorithm/opt_model.py``)
against the JAX package's, in float64 on the CPU, both started from the
same ``TreeInfo`` state (``convert.treeinfo_from_state``):

- each ``opt_*`` family and one ``opt_model`` round on a 10-taxon DNA
  case (sequences simulated along the tree; the 8-taxon 20-state case
  is ``test_torch_opt_protein.py``): the endpoint logLs agree within
  max(1e-6·|lnL|, 1e-3), after one call and after a second call from
  each package's own endpoint, and the port's second call gains no more
  than the reference's + 1e-3 (≤ 1e-3 where the reference is
  stationary; an ``opt_model`` round and the EM alternation are not, in
  either package);
- a family that lowers the logL is reverted: the logL after it is the
  logL before it, the partition and the lengths restored;
- the float32 partitions (the kernels' plain versions) reach the
  float64 endpoint within 1e-3·|lnL| through ``opt_model``.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import common as jc
from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import common
from pllmod_tpu_torch.algorithm import opt_model as om
from pllmod_tpu_torch.convert import (ARRAY_FIELDS, META_FIELDS,
                                      treeinfo_from_state)
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests import reference_impl as ref
from tests.torch_cases import simulate
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

jom = importlib.import_module("pllmod_tpu.algorithm.opt_model")

MODEL_MASK = (jc.PARAM_SUBST_RATES | jc.PARAM_FREQUENCIES | jc.PARAM_ALPHA
              | jc.PARAM_PINV | jc.PARAM_BRANCHES_ITERATIVE)


def jax_state(jti) -> dict:
    """A JAX TreeInfo's state as numpy, for ``treeinfo_from_state``."""
    t = jti.tree
    return dict(
        tree=dict(n_tips=t.n_tips, labels=t.labels, edge_nodes=t.edge_nodes,
                  lengths=t.lengths, n_nodes=t.n_nodes),
        partitions=[None if p is None else dict(
            arrays={f: np.asarray(getattr(p, f)) for f in ARRAY_FIELDS},
            meta={f: getattr(p, f) for f in META_FIELDS})
            for p in jti.partitions],
        brlen_linkage=jti.brlen_linkage, brlens=jti.brlens,
        brlen_scalers=jti.brlen_scalers,
        params_to_optimize=jti.params_to_optimize)


def _case(states, n_taxa, n_sites, seed):
    rng = np.random.default_rng(seed)
    tree = ref.random_binary_tree(rng, n_taxa, 0.03, 0.4)
    R = states * (states - 1) // 2
    seqs = simulate(rng, tree, n_sites, rng.uniform(0.5, 2.0, R),
                    rng.dirichlet([8] * states),
                    "ACGT" if states == 4 else jax_charmap.AA_ORDER)
    return tree, seqs


@pytest.fixture(scope="module")
def cases():
    return {4: _case(4, 10, 300, 5)}


def _pair(tree, jparts, mask, linkage=jc.BRLEN_LINKED):
    jti = JaxTreeInfo(tree.copy(), jparts, brlen_linkage=linkage,
                      params_to_optimize=mask)
    return jti, treeinfo_from_state(jax_state(jti), device="cpu")


FAMILIES = {
    "rates": (MODEL_MASK, lambda ti, m, sym: m.opt_subst_rates(
        ti, symmetries=sym)),
    "freqs": (MODEL_MASK, lambda ti, m, sym: m.opt_frequencies(ti)),
    "alpha_pinv": (MODEL_MASK, lambda ti, m, sym: m.opt_alpha_pinv(ti)),
    "alpha": (MODEL_MASK, lambda ti, m, sym: m.opt_alpha(ti)),
    "pinv": (MODEL_MASK, lambda ti, m, sym: m.opt_pinv(ti)),
    "brlen": (MODEL_MASK, lambda ti, m, sym: m.opt_brlen(ti)),
    "opt_model": (MODEL_MASK, lambda ti, m, sym: m.opt_model(
        ti, symmetries=sym)),
}
RUNS = [(4, f) for f in FAMILIES]


def _close(got, want, what):
    bar = max(1e-6 * abs(want), 1e-3)
    assert abs(got - want) <= bar, f"{what}: {got} vs {want}"


def _two_calls(jti, tti, fn, sym):
    """Each package's logL after one call and after a second one
    (``compute_loglh`` of the result)."""
    out = []
    for ti, mod in ((jti, jom), (tti, om)):
        fn(ti, mod, sym)
        first = float(ti.compute_loglh())
        fn(ti, mod, sym)
        out.append((first, float(ti.compute_loglh())))
    return out


def check_family(tree, seqs, states, family, sym=None):
    """One family from the same start in both packages, two calls each
    (the module docstring's bars)."""
    mask, fn = FAMILIES[family]
    if states == 20 and family == "opt_model":
        mask &= ~jc.PARAM_SUBST_RATES      # LG-like: fixed exchangeabilities
    jp = jax_create(seqs, states=states, n_rate_cats=4, alpha=1.0,
                    prop_invar=0.05, dtype=jnp.float64)
    jti, tti = _pair(tree, [jp], mask)
    start = float(jti.compute_loglh())
    assert float(tti.compute_loglh()) == pytest.approx(start, rel=1e-12)
    (j1, j2), (t1, t2) = _two_calls(jti, tti, fn, sym)
    _close(t1, j1, f"{family} first call")
    _close(t2, j2, f"{family} second call")
    assert t1 >= start - 1e-9 * abs(start)
    assert t2 - t1 <= max(j2 - j1, 0.0) + 1e-3
    tp, jpart = tti.partitions[0], jti.partitions[0]
    for f in ("subst_rates", "freqs", "rate_cats", "prop_invar"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jpart, f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("states,family", RUNS,
                         ids=[f"{s}states-{f}" for s, f in RUNS])
def test_family_matches_jax(cases, states, family):
    check_family(*cases[states], states, family)


def test_rates_weights_matches_jax(cases):
    """Free rates and weights (+R4: alpha NaN), EM + L-BFGS rounds, the
    Σwr = 1 factor pushed into the lengths."""
    tree, seqs = cases[4]
    jp = jax_create(seqs, states=4, n_rate_cats=4, alpha=None,
                    dtype=jnp.float64)
    jti, tti = _pair(tree, [jp], jc.PARAM_FREE_RATES | jc.PARAM_RATE_WEIGHTS)
    start = float(jti.compute_loglh())
    (j1, j2), (t1, t2) = _two_calls(
        jti, tti, lambda ti, m, sym: m.opt_rates_weights(ti), None)
    _close(t1, j1, "first call")
    _close(t2, j2, "second call")
    assert t1 > start
    tp = tti.partitions[0]
    w, r = tp.rate_weights.numpy(), tp.rate_cats.numpy()
    assert float(w @ r) == pytest.approx(1.0, rel=1e-12)
    np.testing.assert_allclose(tti.tree.lengths, jti.tree.lengths,
                               rtol=1e-3)


def test_brlen_scalers_match_jax(cases):
    """SCALED linkage, two partitions: Brent on each scaler, then the
    scalers normalized into the shared lengths."""
    tree, seqs = cases[4]
    jparts = [jax_create(s, states=4, n_rate_cats=4, alpha=0.8 + 0.4 * k,
                         dtype=jnp.float64)
              for k, s in enumerate((seqs, [x[::-1] for x in seqs]))]
    jti, tti = _pair(tree, jparts, jc.PARAM_BRANCH_LEN_SCALER,
                     jc.BRLEN_SCALED)
    jti.brlen_scalers[:] = tti.brlen_scalers[:] = [1.0, 2.0]
    want = float(jom.opt_brlen_scalers(jti))
    got = float(om.opt_brlen_scalers(tti))
    _close(got, want, "scalers")
    np.testing.assert_allclose(tti.brlen_scalers, jti.brlen_scalers,
                               rtol=1e-4)
    _close(tti.compute_loglh(), jti.compute_loglh(), "after normalization")


def test_failed_family_is_reverted(cases, monkeypatch):
    """A family that lowers the logL is rolled back: the total after it
    is the total before it, the partition object and lengths restored,
    and the families after it still run."""
    tree, seqs = cases[4]
    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=1.0,
                            dtype=torch.float64, device="cpu")
    ti = TreeInfo(Tree(tree.n_tips, tree.labels, tree.edge_nodes.copy(),
                       tree.lengths.copy()), [part],
                  params_to_optimize=common.PARAM_FREQUENCIES
                  | common.PARAM_ALPHA)

    def bad_freqs(treeinfo, **kw):
        p = treeinfo.partitions[0]
        treeinfo.partitions[0] = p.with_model_params(
            freqs=torch.tensor([[0.97, 0.01, 0.01, 0.01]],
                               dtype=torch.float64))
        treeinfo.tree.lengths = treeinfo.tree.lengths * 3.0
        return 0.0

    seen = {}

    def watch_alpha(treeinfo, **kw):
        seen["part"] = treeinfo.partitions[0]
        seen["lnl"] = treeinfo.compute_loglh()
        return real_alpha(treeinfo, **kw)

    real_alpha = om.opt_alpha
    monkeypatch.setattr(om, "opt_frequencies", bad_freqs)
    monkeypatch.setattr(om, "opt_alpha", watch_alpha)
    before = ti.compute_loglh()
    lengths = ti.tree.lengths.copy()
    final = om.opt_model(ti)
    assert seen["part"] is part
    assert seen["lnl"] == before
    np.testing.assert_array_equal(ti.tree.lengths, lengths)
    assert final > before
    assert ti.params_to_optimize == [common.PARAM_FREQUENCIES
                                     | common.PARAM_ALPHA]


def test_float32_opt_model_reaches_float64():
    """The float32 route (kernels 1, 2, 8-10 through their plain
    versions) ends near the float64 route, and its logL is the float64
    engine's at its own parameters."""
    tree, seqs = _case(4, 8, 200, 9)
    out = {}
    for dt in (torch.float64, torch.float32):
        part = create_partition(seqs, states=4, n_rate_cats=4, alpha=1.0,
                                prop_invar=0.05, dtype=dt, device="cpu")
        ti = TreeInfo(Tree(tree.n_tips, tree.labels, tree.edge_nodes.copy(),
                           tree.lengths.copy()), [part],
                      params_to_optimize=common.PARAM_ALL)
        out[dt] = (om.opt_model(ti), ti)
    l64, _ = out[torch.float64]
    l32, ti32 = out[torch.float32]
    assert abs(l32 - l64) <= 1e-3 * abs(l64)
    ti = TreeInfo(ti32.tree, [ti32.partitions[0].to(dtype=torch.float64)])
    assert l32 == pytest.approx(ti.compute_loglh(), rel=1e-6)
