"""The partitioned layer of the port (``tree/treeinfo.py``, the
multi-partition BLO, kernel 10 over K partitions) against the JAX
package's ``TreeInfo`` on the same two partitions (DNA+Γ4 and
protein+Γ4, sequences simulated along one tree), carried over by
``convert.partition_from_arrays`` from the JAX package's float64 ones:

- ``compute_loglh`` in the three linkage modes and the per-site vectors
  against JAX's float64 serial engine: 1e-6 relative for the port's
  float32 partitions (the kernels' plain versions), 1e-10 for float64;
  scoping and remote (None) partitions;
- incremental evaluation (the scenarios of ``tests/test_incremental.py``)
  for float32 (the fused walk on cached buffers) and float64 (the serial
  engine): the incremental logL equals a full evaluation to 1e-6
  (float32) / 1e-9 (float64) relative, with fewer rows after one change
  and none after no change;
- snapshots, scaling and ``normalize_brlen_scalers`` as in JAX;
- ``optimize_branch_lengths_treeinfo`` in the three modes on two DNA
  partitions (the port in float32): the port ends at or above JAX's
  result − 1e-4·|l|, and its logL is within 1e-5 relative of the port's
  float64 engine at the returned lengths;
- kernel 10's plain version for K = 2 partitions with scalers against
  JAX's ``newton_edges_pallas_multi`` (interpret), at the tolerances of
  ``test_torch_deriv.py``; for K = 1 it is the single-partition Newton
  of ``optimize/newton.py``, and a partition given twice lands on the
  same lengths with twice the logL."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import common as jax_common
from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops import pallas_deriv
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu.optimize import blo as jax_blo
from pllmod_tpu.tree import moves as jax_moves
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch.common import (BRLEN_LINKED, BRLEN_SCALED,
                                     BRLEN_UNLINKED, MAX_BRANCH_LEN,
                                     MIN_BRANCH_LEN, TOL_BRANCH_LEN)
from pllmod_tpu_torch.ops import deriv, engine
from pllmod_tpu_torch.optimize import blo, newton
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests import reference_impl as ref
from tests.torch_cases import (simulate, to_torch, to_torch_tree,
                               with_eigen)
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

RTOL = {"f32": 1e-6, "f64": 1e-10}
INCR_RTOL = {"f32": 1e-6, "f64": 1e-9}
MODES = {"linked": BRLEN_LINKED, "scaled": BRLEN_SCALED,
         "unlinked": BRLEN_UNLINKED}
XMIN, XMAX, TOL = MIN_BRANCH_LEN, MAX_BRANCH_LEN, TOL_BRANCH_LEN


@pytest.fixture(scope="module")
def data():
    """Three alignments simulated along one 8-taxon tree (DNA 150 sites,
    protein 80, a second DNA 150), with their models: (JAX tree, JAX
    float64 partitions, the port's partitions by dtype, carried over
    from them)."""
    rng = np.random.default_rng(701)
    jtree = ref.random_binary_tree(rng, 8, 0.03, 0.4)
    jparts = []
    for k, (states, n_sites, symbols) in enumerate(
            ((4, 150, "ACGT"), (20, 80, jax_charmap.AA_ORDER),
             (4, 150, "ACGT"))):
        rates = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
        freqs = rng.dirichlet([8] * states)
        seqs = simulate(rng, jtree, n_sites, rates, freqs, symbols)
        jparts.append(with_eigen(jax_create(
            seqs, states=states, n_rate_cats=4, alpha=0.8 - 0.2 * k,
            subst_rates=rates, freqs=freqs, dtype=jnp.float64)))
    tparts = [to_torch(p) for p in jparts]
    return jtree, jparts, {"f64": tparts,
                           "f32": [p.to(dtype=torch.float32)
                                   for p in tparts]}


def _treeinfos(data, dt, mode=BRLEN_LINKED, which=(0, 1)):
    """The JAX TreeInfo (float64, the reference of both dtypes) and the
    port's in ``dt`` over the same partitions (``which`` of the data's:
    DNA + protein by default) and tree: SCALED takes scalers (1.0, 0.5),
    UNLINKED scales partition 1's lengths by 1.3."""
    jtree, jparts, tparts = data
    jti = JaxTreeInfo(jtree.copy(), [jparts[k] for k in which],
                      brlen_linkage=mode)
    ti = TreeInfo(to_torch_tree(jtree), [tparts[dt][k] for k in which],
                  brlen_linkage=mode)
    for t in (jti, ti):
        if mode == BRLEN_SCALED:
            t.brlen_scalers[:] = [1.0, 0.5]
        if mode == BRLEN_UNLINKED:
            t.scale_branches_partition(1, 1.3)
    return jti, ti


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("mode", list(MODES))
def test_compute_loglh_matches_jax(data, mode):
    for dt in ("f32", "f64"):
        jti, ti = _treeinfos(data, dt, MODES[mode])
        want = jti.compute_loglh()
        got = ti.compute_loglh()
        assert _rel(got, want) < RTOL[dt]
        np.testing.assert_allclose(ti.partition_loglh, jti.partition_loglh,
                                   rtol=RTOL[dt])
        assert ti.counters.loglh_evals == 2
        # the same traversals as JAX's, counted in unpadded patterns
        # (JAX's counter counts padded ones)
        assert ti.counters.clv_updates * sum(
            p.n_patterns_padded for p in ti.partitions) == \
            jti.counters.clv_updates * sum(
                p.n_patterns for p in ti.partitions)


def test_scoping_and_remote_partitions(data):
    jti, ti = _treeinfos(data, "f64")
    full = ti.compute_loglh()
    ti.set_active_partition(1)
    jti.set_active_partition(1)
    assert list(ti.local_indices()) == [1]
    assert _rel(ti.compute_loglh(), jti.compute_loglh()) < RTOL["f64"]
    assert _rel(ti.compute_loglh(), ti.partition_loglh[1]) == 0.0
    ti.set_active_partition(-1)
    remote = TreeInfo(ti.tree, [ti.partitions[0], None])
    assert list(remote.local_indices()) == [0]
    assert _rel(remote.compute_loglh() + ti.partition_loglh[1], full) < 1e-12
    total, persite = remote.compute_loglh_persite()
    assert persite[1] is None


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_persite_matches_jax(data, dt):
    jti, ti = _treeinfos(data, dt, BRLEN_SCALED)
    want, jsites = jti.compute_loglh_persite(fast=False)
    got, sites = ti.compute_loglh_persite()
    assert _rel(got, want) < RTOL[dt]
    for k, (s, js) in enumerate(zip(sites, jsites)):
        np.testing.assert_allclose(s, js, rtol=10 * RTOL[dt], atol=1e-5
                                   if dt == "f32" else 1e-9)
        w = ti.partitions[k].pattern_weights.numpy()
        assert _rel((s * w).sum(), ti.partition_loglh[k]) < RTOL[dt]
    # float32: the fused kernel's site vector and the serial engine's
    # agree
    if dt == "f32":
        ops, root_info = ti.tree.traversal_ops()
        ri = tuple(int(x) for x in root_info)
        for k, s in enumerate(sites):
            _, slow = engine.loglikelihood_persite(
                ti.partitions[k], ops, ti._brlens_tensor(k), ri)
            np.testing.assert_allclose(s, slow.numpy(), rtol=1e-5,
                                       atol=1e-4)


def _inner_edge(tree):
    for e in np.nonzero(tree.edge_nodes[:, 0] >= 0)[0]:
        u, v = (int(x) for x in tree.edge_nodes[e])
        if not tree.is_tip(u) and not tree.is_tip(v):
            return int(e)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("scenario", ["one_change", "no_change", "model",
                                      "topology", "sequential",
                                      "after_plain_eval"])
def test_incremental(data, dt, scenario):
    """The scenarios of tests/test_incremental.py on the two-partition
    TreeInfo: the incremental logL against a full evaluation of the same
    state (and against JAX's full evaluation after one change)."""
    jti, ti = _treeinfos(data, dt)
    tree = ti.tree
    tol = INCR_RTOL[dt]
    n_pat = sum(p.n_patterns for p in ti.partitions)
    l0 = ti.compute_loglh(incremental=True)             # seeds the caches
    assert _rel(l0, ti.compute_loglh()) < tol
    live = np.nonzero(tree.edge_nodes[:, 0] >= 0)[0]
    if scenario == "one_change":
        edge = int(live[3])
        new = float(tree.lengths[edge]) * 1.7
        for t in (ti, jti):
            t.set_branch_length(edge, new)
        before = ti.counters.clv_updates
        inc = ti.compute_loglh(incremental=True)
        rows = (ti.counters.clv_updates - before) // n_pat
        assert 0 < rows < tree.n_tips - 2
        assert _rel(inc, ti.compute_loglh()) < tol
        assert _rel(inc, jti.compute_loglh()) < RTOL[dt]
    elif scenario == "no_change":
        before = ti.counters.clv_updates
        assert ti.compute_loglh(incremental=True) == l0
        assert ti.counters.clv_updates == before
    elif scenario == "model":
        ti.set_partition(0, ti.partitions[0].with_alpha(1.5))
        inc = ti.compute_loglh(incremental=True)
        assert _rel(inc, ti.compute_loglh()) < tol
        assert _rel(inc, l0) > 1e-6
    elif scenario == "topology":
        jt = JaxTree(tree.n_tips, tree.labels, tree.edge_nodes.copy(),
                     tree.lengths.copy(), tree.n_nodes)
        jax_moves.nni(jt, _inner_edge(jt), jax_moves.NNI_LEFT)
        tree.restore((jt.edge_nodes, jt.lengths, jt.n_nodes))
        inc = ti.compute_loglh(incremental=True)
        assert _rel(inc, ti.compute_loglh()) < tol
        assert _rel(inc, l0) > 1e-6
    elif scenario == "sequential":
        for k, e in enumerate(live[:4]):
            ti.set_branch_length(int(e), 0.05 + 0.03 * k)
            inc = ti.compute_loglh(incremental=True)
            assert _rel(inc, ti.compute_loglh()) < tol, k
    else:
        old = float(tree.lengths[1])
        ti.set_branch_length(1, old * 3.0)
        ti.compute_loglh()                           # plain eval at B1
        ti.set_branch_length(1, old)                 # rollback to B0
        assert _rel(ti.compute_loglh(incremental=True), l0) < tol


def test_snapshots_scaling_and_normalize(data):
    jti, ti = _treeinfos(data, "f64", BRLEN_SCALED)
    snap = ti.get_topology()
    l0 = ti.compute_loglh()
    for t in (ti, jti):
        t.scale_branches_all(1.25)
        t.brlen_scalers[:] = [0.8, 1.6]
    np.testing.assert_array_equal(ti.tree.lengths, jti.tree.lengths)
    assert _rel(ti.compute_loglh(), jti.compute_loglh()) < RTOL["f64"]
    with pytest.raises(ValueError, match="UNLINKED"):
        ti.scale_branches_partition(0, 2.0)
    for t in (ti, jti):
        t.normalize_brlen_scalers()
    np.testing.assert_allclose(ti.brlen_scalers, jti.brlen_scalers,
                               rtol=1e-12)
    np.testing.assert_allclose(ti.tree.lengths, jti.tree.lengths, rtol=1e-12)
    assert _rel(ti.compute_loglh(), jti.compute_loglh()) < RTOL["f64"]
    ti.set_topology(snap)
    assert _rel(ti.compute_loglh(), l0) < 1e-12
    np.testing.assert_array_equal(ti.brlen_scalers, [1.0, 0.5])
    un_j, un = _treeinfos(data, "f64", BRLEN_UNLINKED)
    for t in (un, un_j):
        t.scale_branches_partition(0, 0.7)
    np.testing.assert_array_equal(un.brlens, un_j.brlens)
    assert jax_common.BRLEN_SCALED == BRLEN_SCALED


@pytest.mark.parametrize("mode", list(MODES))
def test_blo_treeinfo_matches_jax(data, mode):
    """On two DNA partitions (the JAX optimizer compiles its sweep once
    for partitions of one shape); the DNA + protein mixture of C·S is
    held in test_newton_multi_plain_matches_jax."""
    jti, ti = _treeinfos(data, "f32", MODES[mode], which=(0, 2))
    start = ti.compute_loglh()
    want = jax_blo.optimize_branch_lengths_treeinfo(jti, max_sweeps=8)
    stats = {}
    kw = {} if mode == "unlinked" else dict(stats=stats)
    got = blo.optimize_branch_lengths_treeinfo(ti, max_sweeps=8, **kw)
    assert got >= start
    assert got >= want - 1e-4 * abs(want)
    parts64 = [data[2]["f64"][k] for k in (0, 2)]
    l64 = sum(float(engine.tree_loglikelihood(
        p, ti.tree, brlens=torch.as_tensor(ti.partition_brlens(i)),
        schedule="scan")) for i, p in enumerate(parts64))
    assert _rel(got, l64) < 1e-5
    if mode != "unlinked":
        # kernel 10 for both partitions took every edge
        assert stats["newton_edges"] > 0 and stats["iterative_edges"] == 0
        none = {}
        blo.optimize_branch_lengths_treeinfo(
            _treeinfos(data, "f32", MODES[mode], which=(0, 2))[1],
            max_sweeps=1, fused_newton=False, stats=none)
        assert none["newton_edges"] == 0 and none["iterative_edges"] > 0
    else:
        assert not np.allclose(ti.brlens[0], ti.brlens[1])


def _sumtables(ti, scalers, brl):
    trav = blo.DirectedTraversal(ti.tree)
    sts, scs = [], []
    for part, s in zip(ti.partitions, scalers):
        tabs = blo._compile_tables(part, trav)
        clvs, sc = blo._directed_clvs(part, tabs, brl * s)
        st, sc = deriv.edge_sumtables(part, clvs, sc, tabs.eref6,
                                      tabs.basis)
        sts.append(st)
        scs.append(sc)
    return sts, scs, trav.edge_mask


def test_newton_multi_plain_matches_jax(data):
    """K = 2 with scalers (1.0, 0.5), each sumtable at b·s: JAX's
    interpret-mode kernel on the port's sumtables. Where JAX's Newton
    ends at a stationary point the lengths agree to 5e-4; the port's
    logL at its lengths is never below JAX's (see test_torch_deriv)."""
    jparts = data[1][:2]
    _, ti = _treeinfos(data, "f32")
    scalers = (1.0, 0.5)
    brl = torch.as_tensor(np.clip(ti.tree.lengths, XMIN, XMAX),
                          dtype=torch.float32)
    sts, scs, live = _sumtables(ti, scalers, brl)
    t, lnl0, iters = deriv.newton_edges_multi_plain(
        ti.partitions, sts, scs, brl, scalers, XMIN, XMAX, TOL, 10)
    jt, jl = pallas_deriv.newton_edges_pallas_multi(
        jparts, [jnp.asarray(s.numpy()) for s in sts],
        [jnp.asarray(s.numpy()) for s in scs], jnp.asarray(brl.numpy()),
        scalers, XMIN, XMAX, TOL, 10, interpret=True)
    jt = torch.as_tensor(np.array(jt))

    def summed(x):
        out = [deriv.edge_derivatives_plain(p, st, sc, x * s,
                                            deriv._lam_weight_rows(p))
               for p, st, sc, s in zip(ti.partitions, sts, scs, scalers)]
        return (sum(o[0].double() for o in out),
                sum(o[1].double() * s for o, s in zip(out, scalers)),
                sum(o[2].double() * s * s for o, s in zip(out, scalers)))

    l_j, df_j, ddf_j = summed(jt)
    settled = (((df_j / ddf_j).abs() < 10 * TOL) & (ddf_j < 0)).numpy()
    settled &= live
    assert settled.sum() >= 0.8 * live.sum()
    rel_t = np.abs(t.numpy() - jt.numpy()) / np.maximum(np.abs(jt.numpy()),
                                                        1e-4)
    assert rel_t[settled].max() < 5e-4
    l_t = summed(t)[0]
    assert bool((l_t >= l_j - 1e-6 * l_j.abs()).numpy()[live].all())
    jl = np.asarray(jl)
    rel_l = np.abs(lnl0.numpy() - jl) / np.maximum(np.abs(jl), 1e-2)
    assert rel_l[live].max() < 2e-6
    assert int(iters.min()) >= 1 and int(iters.max()) <= 10


def test_newton_multi_k1_is_single(data):
    """K = 1 of the multi-partition Newton is the single-partition one:
    its lengths equal ``newton.minimize_newton_multi`` over the same
    derivatives and its lnl0 their logL at t0, bit for bit. The same
    partition given twice (K = 2) doubles every sum exactly, so it lands
    on the same lengths in as many iterations with twice the logL."""
    _, ti = _treeinfos(data, "f32")
    brl = torch.as_tensor(np.clip(ti.tree.lengths, XMIN, XMAX),
                          dtype=torch.float32)
    sts, scs, _ = _sumtables(ti, (1.0,), brl)
    part = ti.partitions[0]
    t, lnl0, iters = deriv.newton_edges_multi_plain(
        [part], sts, scs, brl, (1.0,), XMIN, XMAX, TOL, 10)

    def derivs(x):
        return deriv.edge_derivatives_plain(part, sts[0], scs[0], x)[1:]

    assert torch.equal(t, newton.minimize_newton_multi(derivs, brl, XMIN,
                                                       XMAX, TOL, 10))
    assert torch.equal(lnl0, deriv.edge_derivatives_plain(
        part, sts[0], scs[0], brl)[0])
    t2, lnl2, iters2 = deriv.newton_edges_multi_plain(
        [part, part], sts * 2, scs * 2, brl, (1.0, 1.0), XMIN, XMAX, TOL, 10)
    assert torch.equal(t2, t) and torch.equal(iters2, iters)
    assert torch.equal(lnl2, 2 * lnl0)
    # on CPU tensors the wrapper runs the plain version
    wrapped = deriv.newton_edges(part, sts[0], scs[0], brl, XMIN, XMAX, TOL,
                                 10)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, (t, lnl0, iters)))
    assert deriv.newton_fits(*ti.partitions)
    assert deriv.newton_config([16, 80], [p.n_patterns_padded for p in
                                          ti.partitions], 1)["smem"] == \
        12 * 96 + 768
