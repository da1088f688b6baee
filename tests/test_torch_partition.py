"""The port's partition, Γ rates and P-matrices against the JAX package
(float64: 1e-12) and the reference's blopt-minimal goldens (1e-4, the
printed precision); the flagship example against the JAX entry point's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jax_entry
from pllmod_tpu.common import GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN
from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops import gamma as jax_gamma
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.ops import charmap, gamma
from pllmod_tpu_torch.ops.partition import create_partition
from tests import reference_impl as ref
from tests.test_reference_parity import (ALPHA, BRLENS, FREQS4,
                                         PMAT_GOLDEN_TEXT, SUBST,
                                         _parse_pmat)
from tests.torch_cases import make_case, to_torch
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("tip_states", "code_clv", "pattern_weights", "inv_indicator",
          "subst_rates", "freqs", "rate_cats", "rate_weights", "prop_invar",
          "param_indices")
ODD5 = {"A": 0x01, "B": 0x02, "C": 0x04, "D": 0x08, "E": 0x0c,
        "-": 0x1f, "?": 0x1f}


def _seqs(kind, rng):
    if kind == "dna":
        return ref.random_sequences(rng, 9, 300, alphabet="ACGTRYN",
                                    gap_frac=0.1), {"states": 4}, {}
    if kind == "protein":
        return ref.random_sequences(rng, 7, 200,
                                    alphabet=jax_charmap.AA_ORDER + "BX"
                                    ), {"states": 20}, {}
    seqs = ["".join(rng.choice(list("ABCDE-"), 150)) for _ in range(6)]
    return (seqs, {"charmap": jax_charmap.custom(5, ODD5, "odd5")},
            {"charmap": charmap.custom(5, ODD5, "odd5")})


@pytest.mark.parametrize("kind", ["dna", "protein", "odd5"])
@pytest.mark.parametrize("compress", [True, False])
def test_create_partition_matches_jax(kind, compress):
    rng = np.random.default_rng(11)
    seqs, jkw, tkw = _seqs(kind, rng)
    S = jkw.get("states", 5)
    rates = rng.uniform(0.5, 2.0, S * (S - 1) // 2)
    common = dict(n_rate_cats=4, alpha=0.6, subst_rates=rates,
                  freqs=rng.dirichlet([5] * S), prop_invar=0.2,
                  compress=compress)
    jp = jax_create(seqs, dtype=jnp.float64, **jkw, **common)
    tp = create_partition(seqs, dtype=torch.float64, device="cpu",
                          **(tkw or jkw), **common)
    assert (tp.n_tips, tp.states, tp.n_patterns, tp.n_patterns_padded) == \
        (jp.n_tips, jp.states, jp.n_patterns, jp.n_patterns_padded)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.has_pinv


@pytest.mark.parametrize("mode", [GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN])
@pytest.mark.parametrize("alpha,rtol", [
    (0.05, 1e-12), (0.3, 1e-12), (ALPHA, 1e-12), (2.5, 1e-12), (10.0, 1e-12),
    (40.0, 1e-12)])
def test_gamma_cats_match_jax(alpha, rtol, mode):
    want = np.asarray(jax_gamma.compute_gamma_cats(
        jnp.asarray(alpha, jnp.float64), 4, mode))
    got = gamma.compute_gamma_cats(torch.tensor(alpha, dtype=torch.float64),
                                   4, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    np.testing.assert_allclose(gamma.compute_gamma_cats_host(alpha, 4, mode),
                               want, rtol=1e-12, atol=0)


def test_with_alpha_matches_jax():
    case = make_case(3, 8, 64, dtype=jnp.float64)
    want = np.asarray(case.jpart.with_alpha(1.7).rate_cats)
    got = case.tpart.with_alpha(1.7).rate_cats.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("states,cats,pinv,cache", [
    (4, 4, 0.0, True), (4, 4, 0.3, False), (20, 4, 0.0, True),
    (5, 2, 0.1, False)])
def test_pmatrices_match_jax_f64(states, cats, pinv, cache):
    """Eigenvectors may differ in sign and order between the two eigh
    calls; P-matrices must not (1e-12 absolute)."""
    odd5 = dict(charmap=jax_charmap.custom(5, ODD5)) if states == 5 else {}
    case = make_case(5, 8, 64, states=states, cats=cats, pinv=pinv,
                     dtype=jnp.float64, cache=cache, **odd5)
    tpart = case.tpart if cache else case.tpart.cache_eigen()
    brl = np.random.default_rng(2).uniform(0.001, 2.0, 13)
    want = np.asarray(case.jpart.prob_matrices(jnp.asarray(brl)))
    got = tpart.prob_matrices(brl).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    # the uncached path (eigh in the partition dtype) agrees as well
    got_uncached = case.tpart.replace(
        eigen_lam=None, eigen_V=None, eigen_Vinv=None).prob_matrices(brl)
    np.testing.assert_allclose(got_uncached.numpy(), want, atol=1e-12,
                               rtol=0)


def test_nonreversible_expm_matches_jax():
    case = make_case(6, 6, 32, dtype=jnp.float64, cache=False)
    jp = case.jpart.replace(reversible=False)
    tp = case.tpart.replace(reversible=False)
    brl = np.linspace(0.01, 1.5, 9)
    np.testing.assert_allclose(tp.prob_matrices(brl).numpy(),
                               np.asarray(jp.prob_matrices(jnp.asarray(brl))),
                               atol=1e-12, rtol=0)


def test_pmatrices_match_reference_goldens():
    part = create_partition(["ACGT", "ACGT", "ACGT"], states=4,
                            n_rate_cats=4, alpha=ALPHA, subst_rates=SUBST,
                            freqs=FREQS4, compress=False,
                            dtype=torch.float64, device="cpu")
    P = part.cache_eigen().prob_matrices(BRLENS).numpy()
    for e, brl in enumerate(BRLENS):
        golden = _parse_pmat(PMAT_GOLDEN_TEXT[round(float(brl), 6)])
        np.testing.assert_allclose(P[e], golden, atol=1e-4)


def _both_parsers(monkeypatch, parser):
    """Both packages on the same Newick parser and pattern compressor:
    ``python`` turns both native libraries off; ``native`` loads the
    port's library and then the JAX package's, its loader re-armed, so
    that neither keeps a fallback latched earlier in the process (the
    two parsers number the edges differently)."""
    import pllmod_tpu.native as jax_native
    from pllmod_tpu_torch import native
    if parser == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
        return
    assert native.available()
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("n_taxa,n_sites,seed", [(12, 256, 7), (40, 96, 3)])
def test_flagship_example_matches_jax_entry(n_taxa, n_sites, seed, parser,
                                            monkeypatch):
    _both_parsers(monkeypatch, parser)
    jp, jt = jax_entry._example(n_taxa, n_sites, seed, dtype=jnp.float64)
    tp, tt = flagship.example(n_taxa, n_sites, seed, dtype=torch.float64,
                              device="cpu")
    assert flagship.random_newick(n_taxa, np.random.default_rng(seed)) == \
        jax_entry._random_newick(n_taxa, np.random.default_rng(seed))
    np.testing.assert_array_equal(tt.edge_nodes, jt.edge_nodes)
    np.testing.assert_array_equal(tt.lengths, jt.lengths)
    assert tt.labels == jt.labels
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    # the sequences themselves: decode JAX's tip codes through its
    # one-hot code table (the example draws no ambiguity codes)
    state_of_code = np.asarray(jp.code_clv).argmax(axis=1)
    letters = np.array(list("ACGT"))
    jax_seqs = ["".join(letters[state_of_code[row]])
                for row in np.asarray(jp.tip_states)[:, :n_sites]]
    assert flagship.example_data(n_taxa, n_sites, seed)[0] == jax_seqs


def test_partition_to_device_and_dtype():
    case = make_case(8, 6, 40, dtype=jnp.float64)
    p32 = case.tpart.to(dtype=torch.float32)
    assert p32.dtype == torch.float32
    assert p32.tip_states.dtype == torch.int32
    assert p32.param_indices.dtype == torch.int64
    assert p32.eigen_lam.dtype == torch.float32
    assert to_torch(case.jpart).n_patterns == case.jpart.n_patterns
