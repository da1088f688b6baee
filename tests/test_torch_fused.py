"""The fused path of the port (ops/fused.py) against the JAX package's
fused megakernel (``pallas_clv``) in interpret mode with the exact
split=False contract: the same tables, every CLV slot (1e-5 relative:
float32 dot summation orders differ and compound along tree depth) with
equal scaler rows, and the fuse_root logL (1e-6 relative) at C·S = 16,
4 and 80."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_clv
from pllmod_tpu_torch.ops import fused
from tests.torch_cases import lengths, make_case, rel_err
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

LOGL_RTOL = 1e-6
CLV_RTOL = 1e-5


@pytest.mark.parametrize("seed,n_taxa,root_edge,fuse_root", [
    (1, 9, None, False), (2, 33, 4, True), (3, 48, 0, True)])
def test_compile_fused_matches_jax(seed, n_taxa, root_edge, fuse_root):
    case = make_case(seed, n_taxa, 16)
    want = pallas_clv.compile_fused(case.jpart, case.jtree, root_edge,
                                    fuse_root=fuse_root)
    got = fused.compile_fused(case.tpart, case.tree, root_edge,
                              fuse_root=fuse_root)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == tuple(int(x) for x in want[3])
    assert got[4] == want[4]


@pytest.mark.parametrize("seed,n_taxa,n_sites,states,cats", [
    (5, 32, 256, 4, 4), (6, 12, 128, 20, 4)])
def test_plain_fused_matches_jax_kernel_slots(seed, n_taxa, n_sites, states,
                                              cats):
    """Same P-matrices into both walks (JAX builds them, float32)."""
    case = make_case(seed, n_taxa, n_sites, states=states, cats=cats)
    idx8, e1, e2, _, ns = pallas_clv.compile_fused(case.jpart, case.jtree)
    P = case.jpart.prob_matrices(jnp.asarray(case.jtree.lengths,
                                             jnp.float32))
    want_clv, want_sc = pallas_clv.update_partials_fused(
        case.jpart, P, idx8, e1, e2, ns, interpret=True, split=False)
    Pt = torch.as_tensor(np.array(P))
    e1t = torch.as_tensor(np.array(e1), dtype=torch.int64)
    e2t = torch.as_tensor(np.array(e2), dtype=torch.int64)
    P5 = torch.stack([Pt[e1t], Pt[e2t]], dim=1).contiguous()
    got_clv, got_sc = fused.fused_walk(
        torch.as_tensor(np.array(idx8)), P5, case.tpart.tip_states,
        fused.code_table(case.tpart), ns)
    written = np.unique(np.asarray(idx8)[:, 6])
    np.testing.assert_array_equal(got_sc.numpy()[written],
                                  np.asarray(want_sc)[written])
    np.testing.assert_allclose(got_clv.numpy()[written],
                               np.asarray(want_clv)[written],
                               rtol=CLV_RTOL, atol=0)


@pytest.mark.parametrize("states,cats,pinv", [(4, 4, 0.0), (4, 1, 0.2),
                                              (20, 4, 0.1)])
def test_fuse_root_logl_matches_jax(states, cats, pinv):
    """C·S = 16, 4 and 80: the fuse_root logL against the JAX fused
    kernel (interpret, split=False) and the JAX float64 scan."""
    case = make_case(60 + cats, 20, 256, states=states, cats=cats, pinv=pinv)
    brl = case.jtree.lengths
    idx8, e1, e2, ri, ns = pallas_clv.compile_fused(
        case.jpart, case.jtree, fuse_root=True)
    want = float(pallas_clv.loglikelihood_fused(
        case.jpart, idx8, jnp.asarray(brl, jnp.float32), e1, e2, ri, ns,
        True, False))
    want64 = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                                 schedule="scan"))
    t = fused.compile_fused(case.tpart, case.tree, fuse_root=True)
    got = fused.loglikelihood_fused(case.tpart, t[0], lengths(case.tree),
                                    t[1], t[2], t[3], t[4])
    assert rel_err(got, want) < LOGL_RTOL
    assert rel_err(got, want64) < LOGL_RTOL


def test_fused_needs_fuse_root_table():
    case = make_case(71, 8, 64)
    t = fused.compile_fused(case.tpart, case.tree)
    with pytest.raises(ValueError, match="fuse_root"):
        fused.loglikelihood_fused(case.tpart, t[0], lengths(case.tree),
                                  t[1], t[2], t[3], t[4])

