"""The level schedules of the port (``ops/levels.py``, and the engine's
"pallas", "levels" and "repeats" schedules) against the JAX package:

- the LevelSchedule tables (levels, offsets, remapped root, slot count)
  and the per-level ``level_idx`` rows are equal;
- the per-level kernels' plain versions (``child_pass``,
  ``child2_pass``, ``level_update_combined``) and ``level_update``
  against the JAX Pallas kernels in interpret mode on the same
  P-matrices and the same input buffers, every level: CLVs within 1e-5
  relative (float32 dot summation orders differ), scaler rows equal;
- the logL of every level path within 1e-6 relative of JAX (interpret
  for the kernels) and of the JAX float64 scan, at C·S = 16, 4 and 80 and
  on a caterpillar tree (every level one row)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops import pallas_clv
from pllmod_tpu_torch.common import PllModError
from pllmod_tpu_torch.ops import _build, engine, fused, levels
from tests.torch_cases import level_case, lengths, make_case, rel_err, to_torch
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

LOGL_RTOL = 1e-6
CLV_RTOL = 1e-5
# (states, cats, pinv): C·S = 16, 4 and 80
SHAPES = [(4, 4, 0.0), (4, 1, 0.2), (20, 4, 0.1)]


@pytest.mark.parametrize("n_taxa,root_edge,caterpillar", [
    (9, None, False), (33, 5, False), (48, 0, False), (12, None, True)])
def test_level_tables_match_jax(n_taxa, root_edge, caterpillar):
    case = level_case(80 + n_taxa, n_taxa, 16, caterpillar=caterpillar)
    want = jax_engine.compile_schedule(case.jpart, case.jtree, root_edge)
    got = engine.compile_schedule(case.tpart, case.tree, root_edge)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            levels.level_idx(case.tpart, g),
            np.asarray(pallas_clv._level_idx(case.jpart, w)))
    assert got[1:] == tuple(want[1:])
    if caterpillar:
        assert all(len(lv) == 1 for lv in got[0])
    idx, e1, e2 = levels.level_tables(case.tpart, got[0])
    np.testing.assert_array_equal(
        idx.numpy(), np.concatenate([levels.level_idx(case.tpart, lv)
                                     for lv in got[0]]))
    ops = np.concatenate(got[0])
    np.testing.assert_array_equal(e1.numpy(), ops[:, 2])
    np.testing.assert_array_equal(e2.numpy(), ops[:, 4])


def _assert_block(got_clv, got_sc, want_clv, want_sc):
    np.testing.assert_array_equal(np.asarray(got_sc), np.asarray(want_sc))
    np.testing.assert_allclose(np.asarray(got_clv), np.asarray(want_clv),
                               rtol=CLV_RTOL, atol=0)


# seeds whose 5-taxon tree has two levels, of two rows and one
@pytest.mark.parametrize("seed,states,cats,pinv", [
    (201, *SHAPES[0]), (209, *SHAPES[1]), (221, *SHAPES[2])])
def test_level_kernels_match_jax(seed, states, cats, pinv):
    """Every level: kernel 3 (side 0), kernel 4, kernel 5 and
    level_update on JAX's buffers as they stand before the level; then
    the logL of JAX's kernel pipeline (``loglikelihood_pallas``: kernels
    3 and 4 on every level, the state carried here) against the port's
    and the JAX float64 scan."""
    case = make_case(seed, 5, 100, states=states, cats=cats, pinv=pinv)
    jp, tp = case.jpart, case.tpart
    lvls, offsets, ri, ns = jax_engine.compile_schedule(jp, case.jtree)
    P = jp.prob_matrices(jnp.asarray(case.jtree.lengths, jnp.float32))
    Pbd = pallas_clv.block_diag_pmats(P)
    jtab, n_codes = pallas_clv._code_table(jp)
    jcodes = jp.tip_states[:, None, :].astype(jnp.int32)
    Pt = torch.as_tensor(np.array(P))
    tab, codes = fused.code_table(tp), tp.tip_states
    CS, Ppad = states * cats, tp.n_patterns_padded
    jclv = jnp.zeros((ns, CS, Ppad), jnp.float32)
    jsc = jnp.zeros((ns, 1, Ppad), jnp.int32)
    assert [len(lv) for lv in lvls] == [2, 1]
    for lv, off in zip(lvls, offsets):
        W = lv.shape[0]
        jidx = pallas_clv._level_idx(jp, lv)
        idx = torch.as_tensor(levels.level_idx(tp, np.asarray(lv)))
        P1, P2 = Pbd[lv[:, 2]], Pbd[lv[:, 4]]
        p1 = Pt[torch.as_tensor(np.array(lv[:, 2]), dtype=torch.int64)]
        p2 = Pt[torch.as_tensor(np.array(lv[:, 4]), dtype=torch.int64)]

        def bufs():
            return (torch.as_tensor(np.array(jclv)),
                    torch.as_tensor(np.array(jsc)))

        left, s1 = pallas_clv._child_pass(jclv, jsc, jidx[:, (0, 2, 4)],
                                          jcodes, jtab, P1, n_codes, True)
        got_left, got_s1 = levels.child_pass(idx, 0, *bufs(), codes, tab, p1)
        _assert_block(got_left, got_s1, left, s1)

        blk, blk_sc = pallas_clv._child2_pass(
            jclv, jsc, jidx[:, (1, 3, 5)], jcodes, jtab, P2, left, s1,
            n_codes, True)
        clvs, scs = bufs()
        levels.child2_pass(idx, clvs, scs, codes, tab, p2,
                           torch.as_tensor(np.array(left)),
                           torch.as_tensor(np.array(s1)), off)
        _assert_block(clvs[off:off + W], scs[off:off + W], blk, blk_sc)

        comb = pallas_clv.level_update_combined(
            jclv, jsc, jidx, jcodes, jtab, P1, P2, off, n_codes, True)
        clvs, scs = levels.level_update_combined(*bufs(), idx, codes, tab,
                                                 p1, p2, off)
        _assert_block(clvs[off:off + W], scs[off:off + W],
                      comb[0][off:off + W], comb[1][off:off + W])

        split = pallas_clv.level_update(jclv, jsc, jidx, jcodes, jtab, P1,
                                        P2, off, n_codes, True)
        clvs, scs = levels.level_update(*bufs(), idx, codes, tab, p1, p2,
                                        off)
        _assert_block(clvs[off:off + W], scs[off:off + W],
                      split[0][off:off + W], split[1][off:off + W])
        jclv = jclv.at[off:off + W].set(blk)
        jsc = jsc.at[off:off + W].set(blk_sc)
    want = float(pallas_clv.root_loglikelihood_csp(jp, jclv, jsc, ri[0],
                                                   ri[1], P[ri[2]]))
    got = levels.loglikelihood_pallas(tp, [np.asarray(lv) for lv in lvls],
                                      lengths(case.tree), offsets, ri, ns)
    assert rel_err(got, want) < LOGL_RTOL
    want64 = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                                 schedule="scan"))
    assert rel_err(got, want64) < LOGL_RTOL


@pytest.mark.parametrize("states,cats,pinv,caterpillar", [
    *[(*s, False) for s in SHAPES], (4, 4, 0.1, True)])
def test_level_logl_matches_jax(states, cats, pinv, caterpillar):
    """``loglikelihood_pallas`` (all three steps), ``loglikelihood_levels``
    (float32 and float64) and ``schedule="repeats"`` on deeper trees
    against JAX's level-batched engine and repeats engine and the JAX
    float64 scan (the JAX kernels run in the test above)."""
    case = level_case(340 + states + cats, 10 if caterpillar else 14, 160,
                      states, cats, pinv, caterpillar=caterpillar)
    jp, tp = case.jpart, case.tpart
    jbrl = jnp.asarray(case.jtree.lengths, jnp.float32)
    lvls, offsets, ri, ns = jax_engine.compile_schedule(jp, case.jtree)
    want_lv = float(jax_engine.loglikelihood_levels(jp, lvls, jbrl, offsets,
                                                    ri, ns))
    want64 = float(jax_engine.tree_loglikelihood(case.jpart64, case.jtree,
                                                 schedule="scan"))
    want_rep = jax_engine.tree_loglikelihood(jp, case.jtree,
                                             schedule="repeats")
    tl, toff, tri, tns = engine.compile_schedule(tp, case.tree)
    got = {s: levels.loglikelihood_pallas(tp, tl, lengths(case.tree), toff,
                                          tri, tns, step=s)
           for s in levels.STEPS}
    assert got["child2"] == engine.tree_loglikelihood(tp, case.tree,
                                                      schedule="pallas")
    for g in got.values():
        assert rel_err(g, want_lv) < LOGL_RTOL
        assert rel_err(g, want64) < LOGL_RTOL
    got_lv = engine.tree_loglikelihood(tp, case.tree, schedule="levels")
    assert got_lv.dtype == torch.float32
    assert rel_err(got_lv, want_lv) < LOGL_RTOL
    assert rel_err(got_lv, want64) < LOGL_RTOL
    got64 = engine.tree_loglikelihood(to_torch(case.jpart64), case.tree,
                                      schedule="levels")
    assert got64.dtype == torch.float64
    assert rel_err(got64, want64) < 1e-10
    got_rep = engine.tree_loglikelihood(tp, case.tree, schedule="repeats")
    assert isinstance(got_rep, float)
    assert rel_err(got_rep, want_rep) < LOGL_RTOL
    assert rel_err(got_rep, want64) < LOGL_RTOL


def test_level_engines_share_buffers():
    """The level-batched engine's CLVs ([slots, P, C, S]) and the
    per-level kernels' (C·S×P, ``csp_to_standard``) hold the same slots:
    equal scaler rows, CLVs within 1e-5 relative (sums in another
    order); ``csp_from_standard`` inverts the conversion."""
    from pllmod_tpu_torch.ops import clv as clv_mod
    case = make_case(61, 20, 96, cats=4, jax_eigen=True)
    tp = case.tpart
    lvls, offsets, _, ns = engine.compile_schedule(tp, case.tree)
    P = tp.prob_matrices(lengths(case.tree))
    std, std_sc = clv_mod.update_partials_sched(tp, P, lvls, offsets, ns)
    for step in levels.STEPS:
        csp, csp_sc = levels.update_partials_pallas(tp, P, lvls, offsets, ns,
                                                    step)
        got = levels.csp_to_standard(csp, tp.n_cats, tp.states)
        np.testing.assert_array_equal(csp_sc[:, 0].numpy(), std_sc.numpy())
        np.testing.assert_allclose(got.numpy(), std.numpy(), rtol=CLV_RTOL,
                                   atol=0)
        assert torch.equal(levels.csp_from_standard(got), csp)


def test_repeats_stats_match_jax():
    """The site-repeat classes and work counts of a repeat-heavy
    alignment (few distinct sites) equal the JAX package's."""
    from pllmod_tpu.ops import repeats as jax_repeats
    from pllmod_tpu_torch.ops import repeats
    case = make_case(41, 16, 96)
    want = jax_repeats.repeats_stats(case.jpart, case.jtree)
    got = repeats.repeats_stats(case.tpart, case.tree)
    assert got == want
    assert got["work_ratio"] < 1.0
    _, st = repeats.loglikelihood_repeats(case.tpart, case.tree,
                                          return_stats=True)
    assert st == {k: want[k] for k in ("unique_work", "dense_work")}


def test_level_schedules_reject_bad_input():
    case = make_case(51, 8, 32)
    with pytest.raises(PllModError, match="float32"):
        engine.tree_loglikelihood(to_torch(case.jpart64), case.tree,
                                  schedule="pallas")
    tl, toff, tri, tns = engine.compile_schedule(case.tpart, case.tree)
    with pytest.raises(ValueError, match="step"):
        levels.loglikelihood_pallas(case.tpart, tl, lengths(case.tree), toff,
                                    tri, tns, step="packed")
    with pytest.raises(ValueError, match="LevelSchedule"):
        levels.level_tables(case.tpart, tl[::-1])
    with pytest.raises(ValueError, match="side"):
        levels.child_pass(torch.zeros((1, 6), dtype=torch.int32), 2,
                          None, None, None, None, None)


@pytest.mark.parametrize("states,cats", [(4, 4), (20, 4)])
def test_child_pass_tip_lookup_matches_jax_levels(states, cats):
    """Kernel 3's tip lookup in plain form: on every level of the JAX
    package's schedule, the tip children's rows of the plain child pass
    equal their lookup in the row's tip table (``fused.tip_tables_plain``)
    bit for bit, both sides."""
    case = make_case(240 + states, 20, 128, states=states, cats=cats)
    tp = case.tpart
    lvls, offsets, _, ns = jax_engine.compile_schedule(case.jpart,
                                                       case.jtree)
    idx, e1, e2 = levels.level_tables(tp, [np.asarray(lv) for lv in lvls])
    P = tp.prob_matrices(lengths(case.tree)).float()
    tab = fused.code_table(tp)
    Ppad = tp.n_patterns_padded
    clvs = torch.zeros((ns, cats * states, Ppad))
    sc = torch.zeros((ns, 1, Ppad), dtype=torch.int32)
    n_tips = 0
    for lv, off in zip(lvls, offsets):
        s = slice(off, off + len(lv))
        for side, e in ((0, e1), (1, e2)):
            out, _ = levels.child_pass_plain(idx[s], side, clvs, sc,
                                             tp.tip_states, tab, P[e[s]])
            for w, row in enumerate(idx[s].tolist()):
                if row[2 + side]:
                    PT = fused.tip_tables_plain(P[e[s]][w], tab)
                    got = fused.tip_lookup_plain(
                        PT, tp.tip_states[row[4 + side]])
                    assert torch.equal(got.reshape(-1, Ppad), out[w])
                    n_tips += 1
    assert n_tips >= tp.n_tips - 2     # the root's children are no row's


@pytest.mark.parametrize("C,S,n_codes,Ppad,W,T,lookup", [
    (4, 20, 24, 4096, 24, 128, 1),   # protein, a wide level
    (4, 20, 24, 4096, 1, 128, 1),    # W = 1: one category a CTA
    (4, 20, 24, 512, 1, 4, 0),       # few patterns: small tiles
    (4, 4, 16, 16384, 7, 128, 1),    # flagship
    (4, 4, 16, 16384, 1, 128, 1),
    (4, 4, 16, 1024, 2, 16, 1),
    (4, 64, 65, 4096, 4, 128, 1),    # one category a CTA
])
def test_child_tile_follows_level_width(C, S, n_codes, Ppad, W, T, lookup):
    """Kernel 3's tile fills the card at every width (a CTA an SM or
    more), looks tips up where the tile has as many patterns as the table
    has codes, and every configuration fits a block."""
    assert _build.child_tile(C, S, n_codes, Ppad, W) == T
    cf = _build.child_config(C, S, n_codes, T)
    assert cf["lookup"] == lookup
    for T in _build.TILES:
        cf = _build.child_config(C, S, n_codes, T)
        if cf:
            assert cf["threads"] <= _build.MAX_THREADS
            assert cf["smem"] <= _build.SMEM_PER_BLOCK
            assert 1 <= cf["CB"] <= C and cf["SP"] >= S


@pytest.mark.parametrize("C,S,n_codes,Ppad,W,T2,T5,kind", [
    (4, 4, 16, 16384, 1, 128, 128, "tile"),     # flagship, W = 1
    (4, 4, 16, 16384, 2, 256, 256, "tile"),
    (4, 4, 16, 16384, 44, 256, 256, "tile"),    # its widest level
    (4, 20, 24, 4096, 1, 32, 32, "tile"),       # protein, W = 1
    (4, 20, 24, 4096, 2, 64, 64, "tile"),
    (4, 20, 24, 4096, 172, 64, 64, "tile"),     # its widest level
    (4, 64, 65, 4096, 44, 64, 32, "tile"),      # 64 states
    (256, 4, 16, 512, 1, 4, 4, "tile"),         # 256 categories
    (256, 20, 24, 512, 4, 1, 1, "simple"),      # ... beyond the tiles
    (4, 20, 24, 100, 1, 8, 8, "tile"),          # few patterns: a warp
])
def test_level_tile_follows_level_width(C, S, n_codes, Ppad, W, T2, T5, kind):
    """Kernels 4 and 5's tile fills the card at every width where a tile
    can (else a CTA keeps a warp), takes the simple kernel only where the
    tiled one fits no tile, sizes each side's table from the pre-pass for
    the larger of the matrix and the tip table (the scratch of a level
    holds W·sides of them), and every configuration fits a block's
    threads and shared memory."""
    for mode, want in (("child2", T2), ("combined", T5)):
        T = _build.level_tile(mode, C, S, n_codes, Ppad, W)
        assert T == want
        cf = _build.level_config(mode, C, S, n_codes, T)
        assert cf["kind"] == kind
        sides = _build.LEVEL_MODES.index(mode) + 1
        assert levels.level_scratch_floats(mode, C, S, n_codes, Ppad, W) \
            == W * sides * cf["Q"]
        if W == 1 and kind == "tile" and Ppad >= 4096:
            assert -(-Ppad // T) >= _build.LEVEL_CTAS
        for T in _build.LEVEL_TILES:
            cf = _build.level_config(mode, C, S, n_codes, T)
            if cf is None:
                assert C * T > _build.MAX_THREADS
                continue
            assert cf["smem"] <= _build.SMEM_PER_BLOCK and cf["SP"] >= S
            if cf["kind"] == "tile":
                assert cf["threads"] == C * cf["IG"] * T // 4
                assert cf["threads"] <= 512
                assert cf["RI"] * cf["IG"] == cf["SP"]
                assert cf["Q"] == C * max(S, n_codes) * cf["SP"]
            else:
                assert cf["threads"] == C * T <= _build.MAX_THREADS
                assert cf["Q"] == 0
