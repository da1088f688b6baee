"""The port's chunked, memory-bounded BLO (``optimize/blo.py``:
``compile_chunked_blo``, ``_blo_window``,
``optimize_branch_lengths_chunked``) against the JAX package's: the
window tables equal exactly, the float64 driver (the serial engine and
the float64 derivative passes) within 1e-8 of JAX's logL and 1e-6 of its
lengths, the traversal buffer O(log n), the SAFE revert a no-op on a
benign case, and float32 (kernels 2, 8, 9, 10 through their plain
versions on the CPU) within 1e-5 of float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu.optimize import blo as jax_blo
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.optimize import blo
from tests import reference_impl as ref
from tests.torch_cases import (make_case, rel_err, to_torch, to_torch_tree,
                               with_eigen)
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _case(seed, n, sites):
    """The JAX package's ``test_bounded_slots._parts`` recipe in float64:
    (JAX partition, JAX tree, the port's partition, the port's tree)."""
    rng = np.random.default_rng(seed)
    jtree = ref.random_binary_tree(rng, n)
    seqs = ref.random_sequences(rng, n, sites)
    jpart = with_eigen(jax_create(seqs, states=4, n_rate_cats=4, alpha=0.9,
                                  prop_invar=0.1, dtype=jnp.float64))
    return jpart, jtree, to_torch(jpart), to_torch_tree(jtree)


@pytest.fixture(scope="module")
def case12():
    return _case(42, 12, 160)


@pytest.mark.parametrize("n,window", [(12, 4), (12, 7), (40, 8), (40, 16)])
def test_compile_chunked_blo_matches_jax(n, window):
    jpart, jtree, tpart, tree = _case(n, n, 16)
    want = jax_blo.compile_chunked_blo(jpart, jtree, window)
    got = blo.compile_chunked_blo(tpart, tree, window)
    for g, w in zip(got[:4], want[:4], strict=True):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[4] == want[4]


@pytest.mark.parametrize("window", [4, 7])
def test_chunked_blo_matches_jax(case12, window):
    """window=7 pads the color classes (masked rows)."""
    jpart, jtree, tpart, tree = case12
    want_b, want_l = jax_blo.optimize_branch_lengths_chunked(
        jpart, jtree.copy(), window=window)
    t = tree.copy()
    stats = {}
    got_b, got_l = blo.optimize_branch_lengths_chunked(
        tpart, t, window=window, stats=stats)
    assert rel_err(got_l, want_l) < 1e-8
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(t.lengths, got_b.numpy())
    assert stats["windows"] == len(blo.compile_chunked_blo(
        tpart, tree, window)[0])
    assert 1 <= stats["sweeps"] <= 32


def test_chunked_blo_slot_bound():
    """The window's traversal buffer stays O(log n) a traversal: W ×
    the bounded slot count, never the 3(n − 2) directed buffer."""
    _, _, tpart, tree = _case(40, 40, 64)
    ops_w, refs_w, _, _, n_slots = blo.compile_chunked_blo(tpart, tree, 8)
    assert n_slots <= int(np.ceil(np.log2(40))) + 3
    for dtype in (torch.float64, torch.float32):
        tabs = blo._window_tables(tpart.to(dtype=dtype), ops_w[0],
                                  refs_w[0], n_slots)
        assert tabs.n_slots <= 8 * n_slots + 1 < 3 * (40 - 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_rows_give_the_tree_logl(dtype):
    """Every row of a window faces its edge from both sides, so each
    row's logL at the incoming lengths is the tree's: the stacked table's
    slot offsets and references are right for every traversal."""
    _, _, tpart, tree = _case(7, 14, 96)
    part = tpart.to(dtype=dtype)
    ops_w, refs_w, edge_ids, _, n_slots = blo.compile_chunked_blo(
        part, tree, 5)
    consts = None
    if dtype == torch.float32:
        from pllmod_tpu_torch.ops import deriv
        consts = (deriv.sumtable_basis(part), deriv._lam_weight_rows(part),
                  deriv.invar_log_plane(part))
    brl = torch.as_tensor(tree.lengths, dtype=dtype)
    ops, ri = tree.traversal_ops()
    want = float(engine.loglikelihood(tpart, ops, brl.double(), ri))
    for w in range(len(ops_w)):
        tabs = blo._window_tables(part, ops_w[w], refs_w[w], n_slots,
                                  consts)
        derivs, _ = blo._edge_evaluator(part, tabs, brl,
                                        torch.arange(len(edge_ids[w])))
        lnl = derivs(brl[torch.as_tensor(edge_ids[w]).long()])[0]
        tol = 1e-10 if dtype == torch.float64 else 1e-6
        for v in lnl.tolist():
            assert rel_err(v, want) < tol


def test_chunked_blo_safe_noop_equivalence():
    """safe=True (the per-edge SAFE revert in each window) is bit for bit
    the default on a benign case, in float64 (the serial engine) and
    float32 (kernel 9's revert after kernel 10)."""
    _, _, tpart, tree = _case(10, 10, 120)
    for dtype in (torch.float64, torch.float32):
        part = tpart.to(dtype=dtype).with_model_params().cache_eigen()
        b1, l1 = blo.optimize_branch_lengths_chunked(part, tree.copy(),
                                                     window=4)
        b2, l2 = blo.optimize_branch_lengths_chunked(part, tree.copy(),
                                                     window=4, safe=True)
        assert l1 == l2
        assert torch.equal(b1, b2)


def test_chunked_blo_float32_matches_float64():
    """Tree-signal data: the float32 driver (kernels 2, 8, 10 and 9
    through their plain versions, the final score on kernel 2) ends
    within 1e-5 of the float64 driver, each written back and each at or
    above the start."""
    case = make_case(21, 12, 160, symbols="ACGT")
    part64 = to_torch(case.jpart64)
    part32 = case.tpart
    ops, ri = case.tree.traversal_ops()
    start = float(engine.loglikelihood(
        part64, ops, torch.as_tensor(case.tree.lengths), ri))
    got = {}
    for part in (part64, part32):
        t = case.tree.copy()
        _, lnl = blo.optimize_branch_lengths_chunked(part, t, window=6)
        assert lnl >= start
        at_f64 = float(engine.loglikelihood(
            part64, ops, torch.as_tensor(t.lengths), ri))
        assert rel_err(lnl, at_f64) < 1e-6
        got[part.dtype] = lnl
    assert rel_err(got[torch.float32], got[torch.float64]) < 1e-5
