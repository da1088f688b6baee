"""The grouped walk of the port (``ops/grouped.py``) against the JAX
package's grouped megakernel (``pallas_grouped``):

- the GroupedSchedule tables (G, nG, side_meta, dst_meta, grp_meta,
  e_sides, root_info) are equal, and the single-consumer guard raises;
- the walk's plain version against the JAX kernel in interpret mode on
  the same P-matrices: every position a member writes (the landing rows
  and the dummies' trash rows included; tip positions hold nothing in
  either), CLVs within 1e-5 relative, scaler rows equal;
- ``loglikelihood_grouped`` within 1e-6 relative of JAX (interpret) and
  of the JAX float64 scan, on the cases of ``tests/test_grouped.py``:
  one pattern tile (the TPU kernel's all-fence mode), a root on a tip
  edge, C = 1 with G = 16, no cached eigendecomposition, plus protein
  (C·S = 80, G = 1) and a caterpillar tree. The first three run with the
  walk's comparison above, on its JAX buffers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_grouped as jgrouped
from pllmod_tpu_torch.ops import grouped
from tests.torch_cases import (lengths, level_case, make_case, rel_err,
                               tip_edge)
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

LOGL_RTOL = 1e-6
CLV_RTOL = 1e-5


def _schedules(case, root_edge=None, group=0):
    return (jgrouped.GroupedSchedule(case.jpart, case.jtree, root_edge, group),
            grouped.GroupedSchedule(case.tpart, case.tree, root_edge, group))


@pytest.mark.parametrize("n_taxa,states,cats,root_edge,group,caterpillar", [
    (24, 4, 4, None, 0, False),      # C·S = 16: G = 4
    (17, 4, 4, "tip", 0, False),     # root on a tip edge
    (40, 4, 1, None, 0, False),      # C·S = 4: G = 16
    (12, 20, 4, 3, 0, False),        # C·S = 80: G = 1
    (30, 4, 4, None, 3, False),      # G given
    (10, 4, 4, None, 0, True)])      # caterpillar
def test_grouped_schedule_matches_jax(n_taxa, states, cats, root_edge, group,
                                      caterpillar):
    case = level_case(500 + n_taxa, n_taxa, 16, states, cats,
                      caterpillar=caterpillar)
    if root_edge == "tip":
        root_edge = tip_edge(case.tree)
    js, ts = _schedules(case, root_edge, group)
    assert (ts.G, ts.nG, ts.Q, ts.GM, ts.CS) == \
        (js.G, js.nG, js.Q, js.GM, js.CS)
    for name in ("side_meta", "dst_meta", "grp_meta", "e_sides"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_array_equal(ts.e_sides_np, js.e_sides_np)
    assert ts.root_info == tuple(int(x) for x in js.root_info)
    assert grouped.pick_group(states * cats) == jgrouped._pick_group(
        states * cats)


@pytest.mark.parametrize("n_taxa,states,cats", [(14, 4, 4), (40, 4, 1),
                                                (8, 20, 4)])
def test_grouped_walk_matches_jax(n_taxa, states, cats):
    """C·S = 16, 4 (G = 16) and 80 (G = 1), one pattern tile (the TPU
    kernel's all-fence mode): the written positions, then the logL of
    JAX's landing buffer against the port's and the JAX float64 scan."""
    case = make_case(520 + n_taxa, n_taxa, 100, states=states, cats=cats)
    assert case.tpart.n_patterns_padded == 128
    js, ts = _schedules(case)
    P = case.jpart.prob_matrices(jnp.asarray(case.jtree.lengths, jnp.float32))
    jb, jsb = jgrouped.update_partials_grouped(
        case.jpart, js, jgrouped._pq_from_pmats(case.jpart, P, js.e_sides),
        interpret=True)
    PQ = torch.as_tensor(np.array(P))[ts.e_sides].contiguous()
    b, sb = grouped.update_partials_grouped(case.tpart, ts, PQ)
    n, Q, CS, Ppad = ts.nG + 1, ts.Q, ts.CS, case.tpart.n_patterns_padded
    # the JAX buffers are tile-major: [n, nP, 2GM, T] and [n, nP, Q, 1, T]
    jb = np.asarray(jb).transpose(0, 2, 1, 3).reshape(n, Q, CS, Ppad)
    jsb = np.asarray(jsb).transpose(0, 2, 3, 1, 4).reshape(n, Q, Ppad)
    dst = ts.dst_meta.numpy()
    dg, dq = dst[..., 0].ravel(), dst[..., 1].ravel()
    assert {0, 1} & {int(q) for g, q in zip(dg, dq) if g == ts.nG}
    np.testing.assert_array_equal(sb.numpy()[dg, dq], jsb[dg, dq])
    np.testing.assert_allclose(b.numpy()[dg, dq], jb[dg, dq], rtol=CLV_RTOL,
                               atol=0)
    u, v, e = js.root_info
    want = float(jgrouped.root_loglikelihood_csp(
        case.jpart, jnp.asarray(jb[ts.nG].reshape(Q, CS, Ppad)),
        jnp.asarray(jsb[ts.nG][:, None]), u, v, P[e]))
    got = grouped.loglikelihood_grouped(case.tpart, lengths(case.tree), ts)
    want64 = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                                 schedule="scan"))
    assert rel_err(got, want) < LOGL_RTOL
    assert rel_err(got, want64) < LOGL_RTOL


@pytest.mark.parametrize("kind", ["tip_root", "no_eigen", "caterpillar"])
def test_grouped_logl_matches_jax(kind):
    """``loglikelihood_grouped`` against the JAX kernel's (interpret)."""
    root_edge = None
    if kind == "no_eigen":
        case = make_case(533, 14, 96, cache=False)
        assert case.tpart.eigen_lam is None
    elif kind == "caterpillar":
        case = level_case(535, 10, 96, caterpillar=True)
    else:
        case = make_case(536, 10, 96)
        root_edge = tip_edge(case.tree)
    js, ts = _schedules(case, root_edge)
    if kind == "tip_root":
        assert min(ts.root_info[:2]) < case.tpart.n_tips
    want = float(jgrouped.loglikelihood_grouped(
        case.jpart, jnp.asarray(case.jtree.lengths, jnp.float32), js, True))
    want64 = float(jax_engine.tree_loglikelihood(
        case.jpart64, case.jtree, root_edge=root_edge, schedule="scan"))
    got = grouped.loglikelihood_grouped(case.tpart, lengths(case.tree), ts)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < LOGL_RTOL
    assert rel_err(got, want64) < LOGL_RTOL


def test_grouped_single_consumer_guard():
    """Multi-consumer op tables (directed-CLV tables) are refused."""
    case = make_case(541, 8, 64)
    ops, root_info = case.tree.traversal_ops()
    live = ops[ops[:, 0] >= 0].copy()
    inner = np.nonzero(live[:, 1] >= case.tpart.n_tips)[0]
    live[-1, 3] = live[inner[0], 1]

    class FakeTree:
        def traversal_ops(self, root_edge=None):
            return live, root_info

    with pytest.raises(ValueError, match="single-consumer"):
        grouped.GroupedSchedule(case.tpart, FakeTree())
