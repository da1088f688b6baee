"""The port's model registries (``utils``), alignment layer (``msa``) and
model-string front end (``cli``) against the JAX package's:

- every name of the DNA, protein, genotype and (generated) MULTIx
  registries resolves to the same rates, frequencies and symmetry
  classes, or raises the same error;
- symmetry-class packing (``pack_rates`` / ``expand_rates``), a model
  pushed into a partition, and the LG4M/LG4X mixtures' matrices and
  ``param_indices``;
- FASTA/PHYLIP round trips, the empirical frequencies, rates and
  invariant sites;
- ``parse_model_string`` and ``build_partition`` on the same alignment:
  the same partition arrays and the same optimization mask.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import cli as jax_cli
from pllmod_tpu import common as jax_common
from pllmod_tpu.msa import io as jax_io
from pllmod_tpu.msa import msa as jax_msa
from pllmod_tpu.ops import charmap as jax_charmap
from pllmod_tpu.ops.partition import create_partition as jax_create
from pllmod_tpu.utils import models as jax_models
from pllmod_tpu.utils import models_aa as jax_aa
from pllmod_tpu.utils import models_dna as jax_dna
from pllmod_tpu.utils import models_gt as jax_gt
from pllmod_tpu.utils import models_mult as jax_mult
from pllmod_tpu_torch import cli
from pllmod_tpu_torch import common
from pllmod_tpu_torch.convert import ARRAY_FIELDS
from pllmod_tpu_torch.msa import io
from pllmod_tpu_torch.msa import msa
from pllmod_tpu_torch.ops import charmap
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.utils import models, models_aa, models_dna, models_gt
from pllmod_tpu_torch.utils import models_mult
from tests import reference_impl as ref
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

MULTI_NAMES = ["MULTI2_GTR", "MULTI3_MK", "MULTI5_JC", "MULTI8",
               "multi10_gtr", "MULTI4_USER010203", "MULTI64_MK"]
REGISTRIES = [(models_dna, jax_dna, models_dna.names()),
              (models_gt, jax_gt, models_gt.names()),
              (models_aa, jax_aa, models_aa.names()),
              (models_mult, jax_mult, MULTI_NAMES)]


def _same_array(got, want, what):
    if want is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


def _same_model(got, want):
    assert (got.name, got.states) == (want.name, want.states)
    for f in ("rates", "freqs", "rate_sym", "freq_sym"):
        _same_array(getattr(got, f), getattr(want, f), f"{want.name} {f}")


@pytest.mark.parametrize("port,jax_reg,names", REGISTRIES,
                         ids=["dna", "gt", "aa", "mult"])
def test_registry_matches_jax(port, jax_reg, names):
    """Every name (and its lower case) resolves alike; a protein name
    whose table is not bundled raises the same UtilError code."""
    assert port.names() == jax_reg.names()
    assert names
    for name in names:
        for n in (name, name.lower()):
            assert port.exists(n) == jax_reg.exists(n)
            try:
                want = jax_reg.info(n)
            except jax_common.UtilError as err:
                with pytest.raises(common.UtilError) as got:
                    port.info(n)
                assert got.value.code == err.code
                continue
            _same_model(port.info(n), want)


def test_model_info_and_names_match_jax():
    for dt in (None, "dna", "aa", "protein", "gt", "genotype"):
        assert models.model_names(dt) == jax_models.model_names(dt)
    for name in ("GTR", "hky", "LG", "WAG", "GTJC", "MULTI6_MK", "K80"):
        assert models.model_exists(name) == jax_models.model_exists(name)
        _same_model(models.model_info(name), jax_models.model_info(name))
    with pytest.raises(common.UtilError):
        models.model_info("NOSUCH")


@pytest.mark.parametrize("name", ["JC", "K80", "HKY", "TN93", "TIM2", "TVM",
                                  "GTR", "GTGTR4"])
def test_pack_and_expand_rates(name):
    port = models.model_info(name)
    want = jax_models.model_info(name)
    full = np.random.default_rng(3).uniform(0.5, 3.0, port.n_rates)
    full = np.asarray(want.expand_rates(want.pack_rates(full)))
    free = port.pack_rates(full)
    np.testing.assert_allclose(free, want.pack_rates(full), rtol=0, atol=0)
    assert len(free) == port.n_free_rates == want.n_free_rates
    got = port.expand_rates(torch.as_tensor(free))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want.expand_rates(free)),
                               rtol=1e-15)
    if len(free):   # differentiable in the free parameters
        x = torch.as_tensor(free).clone().requires_grad_(True)
        port.expand_rates(x).sum().backward()
        counts = np.bincount(port.rates_opt_classes()[0])
        np.testing.assert_array_equal(
            x.grad.numpy(), np.delete(counts, port.rates_opt_classes()[1]))


def _port_partition(seqs, states, n_matrices=1, cats=4):
    return create_partition(seqs, states=states, n_rate_cats=cats,
                            n_matrices=n_matrices, dtype=torch.float64,
                            device="cpu")


def _jax_partition(seqs, states, n_matrices=1, cats=4):
    return jax_create(seqs, states=states, n_rate_cats=cats,
                      n_matrices=n_matrices, dtype=jnp.float64)


def test_set_protein_and_update_partition_match_jax():
    rng = np.random.default_rng(8)
    seqs = ref.random_sequences(rng, 5, 40, alphabet=jax_charmap.AA_ORDER,
                                gap_frac=0.0)
    tp, jp = _port_partition(seqs, 20), _jax_partition(seqs, 20)
    for freqs in (True, False):
        got = models_aa.set_protein(tp, "WAG", model_freqs=freqs)
        want = jax_aa.set_protein(jp, "WAG", model_freqs=freqs)
        for f in ("subst_rates", "freqs"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert got.eigen_lam is None
    got = models.model_info("LG").update_partition(tp)
    want = jax_models.model_info("LG").update_partition(jp)
    np.testing.assert_array_equal(got.subst_rates.numpy(),
                                  np.asarray(want.subst_rates))
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(want.freqs))


@pytest.mark.parametrize("name", ["LG4M", "LG4X"])
def test_mixtures_match_jax(name):
    rng = np.random.default_rng(9)
    seqs = ref.random_sequences(rng, 5, 40, alphabet=jax_charmap.AA_ORDER,
                                gap_frac=0.0)
    mix, jmix = models_aa.info_protmix(name), jax_aa.info_protmix(name)
    assert (mix.mix_type, mix.n_components, mix.states) == \
        (jmix.mix_type, jmix.n_components, jmix.states)
    for c, jc in zip(mix.components, jmix.components, strict=True):
        _same_model(c, jc)
    got = models_aa.set_protmix(_port_partition(seqs, 20, n_matrices=4),
                                name)
    want = jax_aa.set_protmix(_jax_partition(seqs, 20, n_matrices=4), name)
    assert got.param_indices.dtype == torch.int64
    np.testing.assert_array_equal(got.param_indices.numpy(),
                                  np.asarray(want.param_indices))
    np.testing.assert_array_equal(got.subst_rates.numpy(),
                                  np.asarray(want.subst_rates))
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    with pytest.raises(common.UtilError):
        models_aa.set_protmix(_port_partition(seqs, 20), name)


# ---------------------------------------------------------------------------
# the alignment layer
# ---------------------------------------------------------------------------
def _alignments():
    rng = np.random.default_rng(12)
    dna = ref.random_sequences(rng, 7, 90, gap_frac=0.1)
    aa = ref.random_sequences(rng, 6, 70, alphabet=jax_charmap.AA_ORDER,
                              gap_frac=0.05)
    return [("dna", dna, 4), ("aa", aa, 20)]


@pytest.mark.parametrize("kind,seqs,states", _alignments(),
                         ids=["dna", "aa"])
def test_fasta_and_phylip_round_trips(kind, seqs, states, tmp_path):
    labels = [f"{kind}_{i}" for i in range(len(seqs))]
    a = msa.MSA(labels, list(seqs))
    ja = jax_msa.MSA(labels, list(seqs))
    for write, jwrite, read in ((io.write_fasta, jax_io.write_fasta,
                                 io.read_fasta),
                                (io.write_phylip, jax_io.write_phylip,
                                 io.read_phylip)):
        text = write(a)
        assert text == jwrite(ja)
        back = read(text)
        assert (back.labels, back.sequences) == (labels, list(seqs))
    path = tmp_path / "a.fasta"
    io.write_fasta(a, str(path))
    back = io.load_msa(str(path))
    want = jax_io.load_msa(str(path))
    assert (back.labels, back.sequences) == (want.labels, want.sequences)


@pytest.mark.parametrize("kind,seqs,states", _alignments(),
                         ids=["dna", "aa"])
def test_empirical_parameters_match_jax(kind, seqs, states):
    labels = [f"t{i}" for i in range(len(seqs))]
    a, ja = msa.MSA(labels, list(seqs)), jax_msa.MSA(labels, list(seqs))
    cm, jcm = charmap.for_states(states), jax_charmap.for_states(states)
    w = np.random.default_rng(2).integers(1, 4, a.n_sites).astype(float)
    for pw in (None, w):
        np.testing.assert_allclose(
            msa.empirical_frequencies(a, cm, pw),
            jax_msa.empirical_frequencies(ja, jcm, pw), rtol=1e-14)
        np.testing.assert_allclose(
            msa.empirical_subst_rates(a, cm, pw),
            jax_msa.empirical_subst_rates(ja, jcm, pw), rtol=1e-14)
        assert msa.empirical_invariant_sites(a, cm, pw) == pytest.approx(
            jax_msa.empirical_invariant_sites(ja, jcm, pw), rel=1e-14)
    np.testing.assert_array_equal(msa.invariant_column_mask(a, cm),
                                  jax_msa.invariant_column_mask(ja, jcm))


# ---------------------------------------------------------------------------
# model strings and partitions
# ---------------------------------------------------------------------------
SPECS = ["GTR+G4", "GTR+G+I", "HKY+G4+FE", "JC", "K80+I+FC", "LG+G4+I",
         "WAG+FC", "PROTGTR+G", "GTJC+G4", "MULTI5_MK+G2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_model_string_matches_jax(spec):
    model, *rest = cli.parse_model_string(spec)
    jmodel, *jrest = jax_cli.parse_model_string(spec)
    _same_model(model, jmodel)
    assert rest == jrest


def test_bad_model_strings_exit():
    for spec in ("NOSUCH+G", "GTR+Q"):
        with pytest.raises(SystemExit):
            cli.parse_model_string(spec)
        with pytest.raises(SystemExit):
            jax_cli.parse_model_string(spec)


@pytest.mark.parametrize("spec", ["GTR+G4", "HKY+G4+I", "JC+FC", "LG+G4+I",
                                  "PROTGTR+G", "WAG+FE"])
def test_build_partition_matches_jax(spec):
    states = 20 if spec.startswith(("LG", "PROT", "WAG")) else 4
    alphabet = jax_charmap.AA_ORDER if states == 20 else "ACGT"
    rng = np.random.default_rng(len(spec))
    seqs = ref.random_sequences(rng, 6, 120, alphabet=alphabet,
                                gap_frac=0.05)
    labels = [f"t{i}" for i in range(6)]
    part, model, mask = cli.build_partition(
        msa.MSA(labels, seqs), spec, dtype=torch.float64, device="cpu")
    jpart, jmodel, jmask = jax_cli.build_partition(
        jax_msa.MSA(labels, seqs), spec, dtype=jnp.float64)
    assert mask == jmask and model.name == jmodel.name
    assert (part.n_tips, part.states, part.n_patterns) == \
        (jpart.n_tips, jpart.states, jpart.n_patterns)
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(part, f).numpy(),
                                   np.asarray(getattr(jpart, f)),
                                   rtol=1e-12, err_msg=f)


def test_order_tree_tips_matches_jax():
    from pllmod_tpu.tree.topology import Tree as JaxTree
    from pllmod_tpu_torch.tree.topology import Tree
    nwk = "((b:0.1,a:0.2):0.1,c:0.3,(d:0.1,e:0.2):0.05);"
    labels = ["a", "b", "c", "d", "e"]
    seqs = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT"]
    a, ja = msa.MSA(list(labels), list(seqs)), \
        jax_msa.MSA(list(labels), list(seqs))
    cli._order_tree_tips(Tree.from_newick(nwk), a)
    jax_cli._order_tree_tips(JaxTree.from_newick(nwk), ja)
    assert (a.labels, a.sequences) == (ja.labels, ja.sequences)
    with pytest.raises(SystemExit):
        cli._order_tree_tips(Tree.from_newick(nwk),
                             msa.MSA(labels[:4], seqs[:4]))
