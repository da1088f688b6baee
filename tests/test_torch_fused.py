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

from pllmod_tpu.ops import clv as jax_clv
from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_clv
from pllmod_tpu_torch.ops import _build, fused
from pllmod_tpu_torch.ops import clv as clv_mod
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



# ---------------------------------------------------------------------------
# the redesigned kernel's host pieces: tip tables, the pre-pass layout,
# the forwarded children and the launch configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4), (4, 1)])
def test_tip_lookup_plain_matches_expanded_tips(states, cats):
    """A tip child looked up in its table equals the per-pattern product
    on the expanded tip, bit for bit (the same sums in the same order)."""
    case = make_case(90 + states, 8, 128, states=states, cats=cats)
    part = case.tpart
    P = part.prob_matrices(torch.tensor([0.05, 0.2, 0.7])).float()
    tab = fused.code_table(part)
    PT = fused.tip_tables_plain(P, tab)
    for t in range(part.n_tips):
        codes = part.tip_states[t]
        x = tab[codes.long()].T[None].expand(cats, states, codes.shape[0])
        for k in range(P.shape[0]):
            assert torch.equal(fused.tip_lookup_plain(PT[k], codes),
                               clv_mod.apply_pmat(P[k], x))


def _walk_from_tables(idx8, mats, tip_codes, codetab, n_slots, C, S, SP):
    """The redesigned kernel's arithmetic in plain torch: tip children
    looked up in the pre-pass's tables, inner children multiplied by its
    transposed matrices."""
    Ppad = tip_codes.shape[1]
    n_codes = codetab.shape[0]
    clvs = torch.zeros((n_slots, C * S, Ppad))
    scs = torch.zeros((n_slots, 1, Ppad), dtype=torch.int32)
    for w, row in enumerate(idx8.tolist()):
        sides = []
        for k in (0, 1):
            m = mats[w, k]
            if row[2 + k]:
                PT = m[:C * n_codes * SP].view(C, n_codes, SP)[..., :S]
                sides.append((fused.tip_lookup_plain(PT, tip_codes[row[4 + k]]),
                              torch.zeros(Ppad, dtype=torch.int32)))
            else:
                Pt = m[:C * S * SP].view(C, S, SP)[..., :S]
                x = clvs[row[k]].view(C, S, Ppad)
                sides.append((clv_mod.apply_pmat(Pt.transpose(-1, -2), x),
                              scs[row[k], 0]))
        scaled, e = clv_mod.rescale_bits(sides[0][0] * sides[1][0])
        clvs[row[6]] = scaled.reshape(C * S, Ppad)
        scs[row[6], 0] = sides[0][1] + sides[1][1] + e
    return clvs, scs


@pytest.mark.parametrize("states,cats,fuse_root", [
    (4, 4, True), (20, 4, False), (4, 1, True)])
def test_walk_tables_drive_the_plain_walk(states, cats, fuse_root):
    """The pre-pass's layout (``walk_tables_plain``): a walk that reads
    only its tables gives the plain walk's CLVs and scalers bit for bit,
    on the JAX package's table."""
    case = make_case(95 + states, 14, 128, states=states, cats=cats)
    part = case.tpart
    idx8, e1, e2, _, ns = pallas_clv.compile_fused(case.jpart, case.jtree,
                                                   fuse_root=fuse_root)
    idx8 = torch.as_tensor(np.array(idx8))
    P5 = fused.pair_pmats(part, lengths(case.tree),
                          torch.as_tensor(np.asarray(e1)).long(),
                          torch.as_tensor(np.asarray(e2)).long(),
                          root_row=fuse_root)
    tab = fused.code_table(part)
    C, S = cats, states
    T = _build.fused_tile(C, S, tab.shape[0], part.n_patterns_padded)
    cf = _build.fused_config(C, S, tab.shape[0], T)
    mats = fused.walk_tables(idx8, P5, tab, T)
    assert mats.shape == (len(idx8), 2, cf["Q"])
    got = _walk_from_tables(idx8, mats, part.tip_states, tab, ns, C, S,
                            cf["SP"])
    want = fused.fused_walk_plain(idx8, P5, part.tip_states, tab, ns)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _forwarded_rule(idx8, n_slots, depth, lookback):
    """The forwarding rule written out row by row."""
    out = np.zeros((len(idx8), 2), bool)
    for w in range(len(idx8)):
        for back in range(1, lookback + 1):
            if w - back < 0:
                continue
            prev = min(max(int(idx8[w - back][6]), 0), n_slots - 1)
            for k in range(min(depth, 2)):
                slot = min(max(int(idx8[w][k]), 0), n_slots - 1)
                out[w, k] |= not idx8[w][2 + k] and slot == prev
    return out


@pytest.mark.parametrize("serial", [False, True])
def test_forwarded_children_match_jax_tables(serial):
    """The children the kernel forwards from the row before: the rule on
    the JAX package's level-ordered and serial (slot-recycled) tables,
    which the port's tables equal; the serial table has some at every
    pipeline depth."""
    case = make_case(77, 30, 64)
    ops, _ = case.jtree.traversal_ops(None)
    if serial:
        ops = jax_clv.bounded_slot_ops(np.asarray(ops), case.jpart.n_tips)[0]
    want = pallas_clv.compile_fused_ops(case.jpart, np.asarray(ops),
                                        serial=serial)
    got = fused.compile_fused_ops(case.tpart, np.asarray(ops), serial=serial)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    ns = got[3]
    for depth in (0, 1, 2):
        for lookback in (1, 2):
            flags = fused.forwarded_children(got[0], ns, depth, lookback)
            np.testing.assert_array_equal(
                flags.numpy(),
                _forwarded_rule(np.asarray(want[0]), ns, depth, lookback))
            if serial:
                assert bool(flags.any()) == (depth > 0)


@pytest.mark.parametrize("C,S,n_codes,Ppad,T,NB,kind", [
    (4, 4, 16, 16384, 64, 3, "thread"),     # flagship DNA
    (4, 20, 24, 4096, 16, 3, "tile"),       # protein
    (4, 64, 65, 4096, 32, 2, "tile"),       # 64 states: 128 CTAs
    (8, 64, 65, 4096, 16, 1, "tile"),
    (64, 64, 65, 4096, 4, 3, "fallback"),
    (256, 8, 2000, 4096, 1, 0, "thread"),   # tables in device memory
])
def test_fused_tile_and_config(C, S, n_codes, Ppad, T, NB, kind):
    """The fused walk's tile and configuration for the cells' shapes and
    the deep and fallback corners; every configuration fits a block."""
    assert _build.fused_tile(C, S, n_codes, Ppad) == T
    cf = _build.fused_config(C, S, n_codes, T)
    assert (cf["NB"], cf["kind"]) == (NB, kind)
    for T in _build.TILES:
        cf = _build.fused_config(C, S, n_codes, T)
        if cf:
            assert cf["threads"] <= _build.MAX_THREADS
            assert cf["smem"] <= _build.SMEM_PER_BLOCK
            assert cf["SP"] % 4 == 0 and cf["SP"] >= S
            assert cf["Q"] == C * max(S, n_codes) * cf["SP"]
            assert (cf["depth"], cf["lookback"]) == (
                (2, 2) if cf["kind"] == "thread" else (cf["NB"] - 1, 1))
