"""The port's marginal ancestral states (``algorithm/ancestral.py``,
``TreeInfo.compute_ancestral``) and its ``ancestral`` / ``rf`` commands
against the JAX package's, on 12 taxa × 200 sites simulated along the
tree:

- float64 (the serial engine's directed CLVs): the probabilities at
  every inner node within atol 1e-10, the states equal, per partition
  at its own lengths (SCALED linkage);
- float32 (kernel 2's directed walk, its plain version on the CPU):
  within 1e-5 of the JAX float64 probabilities, each site summing to 1
  within 1e-5;
- the commands' output on a FASTA + Newick written to ``tmp_path``:
  ``rf`` equal line for line; ``ancestral`` equal node for node, each
  node named by the taxa of its three sides (the two parsers number
  inner nodes alike only when both take the native Newick parser or
  both the Python one).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import cli as jcli
from pllmod_tpu.algorithm import ancestral as jancestral
from pllmod_tpu.common import BRLEN_SCALED as JAX_SCALED
from pllmod_tpu.tree.topology import Tree as JaxTree
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import cli, flagship
from pllmod_tpu_torch.algorithm import ancestral
from pllmod_tpu_torch.common import BRLEN_SCALED
from pllmod_tpu_torch.msa.io import write_fasta
from pllmod_tpu_torch.msa.msa import MSA as TorchMSA
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

N_TAXA, N_SITES = 12, 200


@pytest.fixture(scope="module")
def case():
    return make_case(21, N_TAXA, N_SITES, symbols="ACGT", dtype=jnp.float64)


@pytest.fixture(scope="module")
def jax_probs(case):
    nodes, probs = jancestral.ancestral_probabilities(case.jpart, case.jtree)
    return nodes, np.asarray(probs)


def test_probabilities_match_jax(case, jax_probs):
    nodes, probs = ancestral.ancestral_probabilities(case.tpart, case.tree)
    jnodes, jprobs = jax_probs
    assert nodes == jnodes and len(nodes) == N_TAXA - 2
    assert probs.shape == jprobs.shape
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-10)
    sub = [nodes[3], nodes[0]]
    got = ancestral.ancestral_probabilities(case.tpart, case.tree, sub)
    assert got[0] == sub
    np.testing.assert_allclose(got[1], jprobs[[3, 0]], rtol=0, atol=1e-10)


def test_states_match_jax(case, jax_probs):
    nodes, states = ancestral.ancestral_states(case.tpart, case.tree)
    jnodes, jstates = jancestral.ancestral_states(case.jpart, case.jtree)
    assert nodes == jnodes
    assert np.array_equal(states, np.asarray(jstates))
    # no near-ties: the simulated data decide every site
    top2 = np.sort(jax_probs[1], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-6


def test_float32_matches_float64(case, jax_probs):
    """Kernel 2's directed CLVs (its plain walk here) in float32."""
    p32 = case.tpart.to(dtype=torch.float32).cache_eigen()
    nodes, probs = ancestral.ancestral_probabilities(p32, case.tree)
    assert probs.dtype == np.float32
    live = slice(0, N_SITES)
    np.testing.assert_allclose(probs.sum(-1)[:, live], 1.0, atol=1e-5)
    np.testing.assert_allclose(probs[:, live], jax_probs[1][:, live],
                               rtol=0, atol=1e-5)


def test_treeinfo_compute_ancestral_matches_jax(case):
    """Two partitions under SCALED linkage, each at its own lengths."""
    part2 = case.tpart.replace(
        tip_states=torch.flip(case.tpart.tip_states, dims=[1]))
    jpart2 = case.jpart.replace(
        tip_states=jnp.flip(case.jpart.tip_states, axis=1))
    ti = TreeInfo(case.tree.copy(), [case.tpart, part2],
                  brlen_linkage=BRLEN_SCALED)
    jti = JaxTreeInfo(case.jtree.copy(), [case.jpart, jpart2],
                      brlen_linkage=JAX_SCALED)
    ti.brlen_scalers[:] = jti.brlen_scalers[:] = [1.0, 0.4]
    got = ti.compute_ancestral()
    want = jti.compute_ancestral()
    assert len(got) == len(want) == 2
    for (n, p), (jn, jp) in zip(got, want):
        assert n == jn
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=1e-10)
    assert np.abs(got[0][1] - got[1][1]).max() > 1e-2


def _write_inputs(case, tmp_path):
    msa = TorchMSA(list(case.jtree.labels), list(case.seqs))
    write_fasta(msa, str(tmp_path / "a.fasta"))
    nw = case.jtree.to_newick()
    (tmp_path / "t.nwk").write_text(nw + "\n")
    return nw


def _sides(tree, node):
    """The taxa of each of ``node``'s three sides, as a sorted tuple of
    label tuples: the same for a node whatever a parser numbers it."""
    adj = tree.adjacency()
    out = []
    for nbr, _e in adj[node]:
        seen, stack, tips = {node, nbr}, [nbr], []
        while stack:
            x = stack.pop()
            if x < tree.n_tips:
                tips.append(tree.labels[x])
            for y, _ in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        out.append(tuple(sorted(tips)))
    return tuple(sorted(out))


def _records(text, tree):
    lines = [ln for ln in text.strip().splitlines()
             if ln.startswith(">") or set(ln) <= set("ACGT")]
    assert len(lines) == 2 * (tree.n_tips - 2)
    return {_sides(tree, int(h[len(">node_"):])): s
            for h, s in zip(lines[::2], lines[1::2])}


def test_cli_ancestral_and_rf_match_jax(case, tmp_path, capsys):
    nw = _write_inputs(case, tmp_path)
    args = ["ancestral", "--msa", str(tmp_path / "a.fasta"), "--tree",
            str(tmp_path / "t.nwk"), "--model", "GTR+G"]
    cli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    jcli.main(args)
    want = capsys.readouterr().out
    recs = _records(got, Tree.from_newick(nw))
    jrecs = _records(want, JaxTree.from_newick(nw))
    assert recs == jrecs
    assert all(len(s) == N_SITES for s in recs.values())

    other = case.tree.copy()
    flagship.random_spr(other, 2, np.random.default_rng(4))
    (tmp_path / "b.nwk").write_text(
        other.to_newick() + "\n" + case.jtree.to_newick() + "\n")
    args = ["rf", str(tmp_path / "t.nwk"), str(tmp_path / "b.nwk")]
    cli.main(args)
    got = capsys.readouterr().out
    jcli.main(args)
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "3 trees; max RF = 18"
    assert got.splitlines()[1].split()[1] != "0"
