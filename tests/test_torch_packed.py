"""The packed walk of the port (``ops/packed.py``) against the JAX
package's node-packed megakernel (``pallas_clv``):

- the PackedSchedule tables (G, nG, idxm, idxg, e1, e2, n_slots_pad,
  contig_frac, root_info) are equal on a random tree, a caterpillar, a
  root on a tip edge and a ``group=`` override;
- the walk's plain version against the JAX kernel in interpret mode on
  the same P-matrices, every slot of the padded buffers (the dummy rows'
  included): CLVs within 1e-6 of the largest |value| (float32 dot
  summation orders differ), scaler rows equal; at 12 taxa × 200 sites
  DNA+Γ4 (G = 8) and 10 × 100 protein+Γ4 (G = 1);
- ``loglikelihood_packed`` within 1e-6 relative of JAX's (its root term
  on the interpret-mode buffers, the computation of
  ``pallas_clv.loglikelihood_packed``) and of the JAX float64 scan.

The JAX kernel runs once a cell (a module-scoped fixture): each
interpret-mode call compiles for seconds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_clv
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import packed
from tests import reference_impl as ref
from tests.torch_cases import (caterpillar_newick, lengths, make_case,
                               rel_err, tip_edge, to_torch_tree)
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

LOGL_RTOL = 1e-6
CLV_TOL = 1e-6          # of the largest |CLV value|
# the DNA cell takes the JAX package's own eigendecomposition: some of
# its all-gap (padded) patterns' products lie within rounding of 1.0, so
# which power of two their scalers take depends on the last bit of P's
# row sums
CELLS = {"dna": dict(seed=601, n_taxa=12, n_sites=200, jax_eigen=True),
         "protein": dict(seed=602, n_taxa=10, n_sites=100, states=20)}


class Shape:
    """What a schedule reads of a partition: its tip count, categories,
    states and device (DNA+Γ4, C·S = 16)."""

    def __init__(self, n_tips):
        self.n_tips, self.n_cats, self.states = n_tips, 4, 4
        self.device = torch.device("cpu")


@pytest.mark.parametrize("kind", ["random", "caterpillar", "tip_root",
                                  "group"])
def test_packed_schedule_matches_jax(kind):
    if kind == "caterpillar":
        jtree = JaxTree.from_newick(caterpillar_newick(13))
    else:
        jtree = ref.random_binary_tree(np.random.default_rng(610), 19)
    tree = to_torch_tree(jtree)
    root_edge = tip_edge(tree) if kind == "tip_root" else None
    group = 3 if kind == "group" else 0
    shape = Shape(tree.n_tips)
    js = pallas_clv.PackedSchedule(shape, jtree, root_edge, group)
    ts = packed.PackedSchedule(shape, tree, root_edge, group)
    assert (ts.G, ts.nG, ts.n_slots_pad) == (js.G, js.nG, js.n_slots_pad)
    assert ts.G == (3 if kind == "group" else 8)
    for name in ("idxm", "idxg", "e1", "e2"):
        got = getattr(ts, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.contig_frac == js.contig_frac
    assert ts.root_info == tuple(int(x) for x in js.root_info)
    if kind == "tip_root":
        assert min(ts.root_info[:2]) < tree.n_tips
    assert ts.n_slots_pad % ts.G == 0 and ts.n_slots_pad >= ts.n_slots


@pytest.fixture(scope="module", params=list(CELLS))
def cell(request):
    """A cell with both schedules, the P-matrices and the JAX kernel's
    interpret-mode buffers."""
    case = make_case(**CELLS[request.param])
    js = pallas_clv.PackedSchedule(case.jpart, case.jtree)
    ts = packed.PackedSchedule(case.tpart, case.tree)
    P = case.jpart.prob_matrices(jnp.asarray(case.jtree.lengths,
                                             jnp.float32))
    jclv, jsc = pallas_clv.update_partials_packed(case.jpart, P, js,
                                                  interpret=True)
    CS = case.tpart.n_cats * case.tpart.states
    jclv = np.asarray(jclv).reshape(js.n_slots_pad, CS, -1)
    return dict(case=case, js=js, ts=ts, P=P, jclv=jclv,
                jsc=np.asarray(jsc))


def test_packed_walk_matches_jax(cell):
    case, ts = cell["case"], cell["ts"]
    assert ts.G == (8 if case.tpart.states == 4 else 1)
    clvs, scalers = packed.update_partials_packed(
        case.tpart, torch.as_tensor(np.array(cell["P"])), ts)
    assert clvs.shape == cell["jclv"].shape
    np.testing.assert_array_equal(scalers.numpy(), cell["jsc"])
    err = np.abs(clvs.numpy() - cell["jclv"]).max()
    assert err <= CLV_TOL * np.abs(cell["jclv"]).max()
    # kernel and plain version are one function on a CPU tensor
    again = packed.packed_walk_plain(ts.idxm, ts.e1, ts.e2,
                                     torch.as_tensor(np.array(cell["P"])),
                                     case.tpart.tip_states,
                                     packed.code_table(case.tpart), ts.G)
    assert torch.equal(again[0], clvs) and torch.equal(again[1], scalers)


def test_loglikelihood_packed_matches_jax(cell):
    case, js, P = cell["case"], cell["js"], cell["P"]
    u, v, e = js.root_info
    want = float(pallas_clv.root_loglikelihood_csp(
        case.jpart, jnp.asarray(cell["jclv"]), jnp.asarray(cell["jsc"]), u,
        v, P[e]))
    want64 = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                                 schedule="scan"))
    got = packed.loglikelihood_packed(case.tpart, lengths(case.tree),
                                      cell["ts"])
    assert got.dtype == torch.float32
    assert rel_err(got, want) < LOGL_RTOL
    assert rel_err(got, want64) < LOGL_RTOL


def test_loglikelihood_packed_rejects_float64():
    part64, tree = flagship.example(6, 32, dtype=torch.float64, device="cpu")
    ts = packed.PackedSchedule(part64, tree)
    with pytest.raises(PllModError, match="float32"):
        packed.loglikelihood_packed(part64, lengths(tree), ts)
