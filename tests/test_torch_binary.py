"""The port's checkpoint files (``binary/``) on the CPU: the round trips
of ``tests/test_binary.py`` (random and sequential access, skeleton,
CLV block, append and map, a missing block, bad magic), checkpoints
that cross between the two packages both ways (equal arrays, the same
TreeInfo logL within 1e-10 in float64), and the logL of a TreeInfo
after save and load equal to the one before, bit for bit, in float32
and in float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pllmod_tpu import binary as jbinary
from pllmod_tpu.common import BRLEN_SCALED as J_SCALED
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import common, flagship
from pllmod_tpu_torch.binary import (ACCESS_RANDOM, ACCESS_SEQUENTIAL,
                                     BinaryFile, attach_skeleton,
                                     load_treeinfo, save_treeinfo)
from pllmod_tpu_torch.common import BinaryError
from pllmod_tpu_torch.convert import ARRAY_FIELDS
from pllmod_tpu_torch.ops.engine import tree_loglikelihood
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests import reference_impl as ref
from tests.torch_cases import make_case, to_torch, to_torch_tree
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def case():
    rng = np.random.default_rng(3)
    tree = to_torch_tree(ref.random_binary_tree(rng, 7))
    seqs = ref.random_sequences(rng, 7, 150)
    part = create_partition(seqs, states=4, n_rate_cats=4, alpha=0.8,
                            subst_rates=rng.uniform(0.5, 2, 6),
                            freqs=rng.dirichlet([5] * 4), prop_invar=0.1,
                            dtype=torch.float64, device="cpu")
    return tree, part


def test_random_access_roundtrip(case, tmp_path):
    tree, part = case
    lnl0 = float(tree_loglikelihood(part, tree))
    path = str(tmp_path / "ckpt.bin")
    with BinaryFile.create(path, max_blocks=16,
                           access_type=ACCESS_RANDOM) as bf:
        bf.dump_partition(1, part)
        bf.dump_tree(2, tree)
        bf.dump_custom(7, b"hello-checkpoint")
    bf = BinaryFile.open(path)
    assert bf.load_custom(7) == b"hello-checkpoint"      # random order
    t2 = bf.load_tree(2)
    p2 = bf.load_partition(1, device="cpu")
    bf.close()
    assert t2.labels == tree.labels
    np.testing.assert_array_equal(t2.edge_nodes, tree.edge_nodes)
    assert p2.dtype == torch.float64 and p2.device.type == "cpu"
    assert p2.has_pinv and p2.eigen_lam is not None
    assert float(tree_loglikelihood(p2, t2)) == lnl0     # bit-identical


def test_sequential_roundtrip(case, tmp_path):
    tree, part = case
    path = str(tmp_path / "seq.bin")
    with BinaryFile.create(path, access_type=ACCESS_SEQUENTIAL) as bf:
        bf.dump_tree(10, tree)
        bf.dump_custom(11, b"x" * 100)
    bf = BinaryFile.open(path)
    bf.seek_first_block()
    t2 = bf.load_tree(10)
    assert bf.load_custom(11) == b"x" * 100
    bf.close()
    assert t2.n_tips == tree.n_tips


def test_skeleton_load(case, tmp_path):
    tree, part = case
    path = str(tmp_path / "sk.bin")
    with BinaryFile.create(path) as bf:
        bf.dump_partition(1, part)
    bf = BinaryFile.open(path)
    sk = bf.load_partition(1, skeleton=True, device="cpu")
    bf.close()
    # skeleton = Partition shell: model params live, site arrays zero-width
    assert tuple(sk.tip_states.shape) == (part.n_tips, 0)
    assert sk.n_patterns == 0
    assert torch.equal(sk.subst_rates, part.subst_rates)
    assert sk.n_tips == part.n_tips and sk.states == part.states
    # re-attaching site data restores a fully working partition
    full = attach_skeleton(sk, part)
    assert torch.equal(full.tip_states, part.tip_states)
    assert full.n_patterns == part.n_patterns
    assert float(tree_loglikelihood(full, tree)) == float(
        tree_loglikelihood(part, tree))
    with pytest.raises(BinaryError):
        attach_skeleton(sk, create_partition(["ACG"] * 3, states=4,
                                             device="cpu"))


def test_clv_block(tmp_path):
    clv = torch.as_tensor(np.random.default_rng(0).random((64, 4, 4)))
    sc = torch.zeros(64, dtype=torch.int32)
    path = str(tmp_path / "clv.bin")
    with BinaryFile.create(path) as bf:
        bf.dump_clv(3, clv, sc)
        bf.dump_clv(4, clv.numpy())
    bf = BinaryFile.open(path)
    c2, s2 = bf.load_clv(3, device="cpu")
    c3, s3 = bf.load_clv(4, device="cpu")
    bf.close()
    assert torch.equal(c2, clv) and torch.equal(s2, sc)
    assert torch.equal(c3, clv) and s3 is None


def test_append_and_map(tmp_path):
    path = str(tmp_path / "app.bin")
    with BinaryFile.create(path, max_blocks=8) as bf:
        bf.dump_custom(1, b"first")
    with BinaryFile.open_append(path) as bf:
        bf.dump_custom(2, b"second")
    bf = BinaryFile.open(path)
    assert [b for b, _ in bf.get_block_map()] == [1, 2]
    assert bf.load_custom(2) == b"second"
    assert bf.load_custom(1) == b"first"
    bf.close()


def test_missing_block_raises(tmp_path):
    path = str(tmp_path / "m.bin")
    with BinaryFile.create(path) as bf:
        bf.dump_custom(1, b"x")
        bf.dump_partition(2, create_partition(["ACG"] * 3, states=4,
                                              device="cpu"),
                          with_tips=False)
    bf = BinaryFile.open(path)
    with pytest.raises(BinaryError):
        bf.load_custom(99)
    with pytest.raises(BinaryError):       # dumped without its tip data
        bf.load_partition(2, device="cpu")
    with pytest.raises(BinaryError):       # a block of another type
        bf.load_tree(1)
    bf.close()


def test_bad_magic(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOTAPLLF" + b"\0" * 64)
    with pytest.raises(BinaryError):
        BinaryFile.open(str(p))
    with pytest.raises(BinaryError):
        BinaryFile.open_append(str(p))


def test_repeats_block(tmp_path):
    site_id = {0: np.array([0, 1, 0], np.int32), 3: np.array([2], np.int32)}
    id_site = {0: np.array([0, 1]), 3: np.array([5])}
    path = str(tmp_path / "rep.bin")
    with BinaryFile.create(path) as bf:
        bf.dump_repeats(5, site_id, id_site)
    with BinaryFile.open(path) as bf:
        sid, ids = bf.load_repeats(5)
    assert sid.keys() == site_id.keys() and ids.keys() == id_site.keys()
    for k in site_id:
        np.testing.assert_array_equal(sid[k], site_id[k])
        np.testing.assert_array_equal(ids[k], id_site[k])


# ---------------------------------------------------------------------------
# TreeInfo checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cross():
    """One float64 case for both packages: the JAX TreeInfo and the
    port's over the same tree and arrays (a remote slot between two
    partitions, SCALED linkage)."""
    c = make_case(21, 8, 120, symbols="ACGT", pinv=0.1, dtype=jnp.float64)
    c2 = make_case(22, 8, 90, cats=2, dtype=jnp.float64)
    masks = [common.PARAM_ALPHA, 0, common.PARAM_BRANCHES_ITERATIVE]
    jti = JaxTreeInfo(c.jtree.copy(), [c.jpart, None, c2.jpart],
                      brlen_linkage=J_SCALED, params_to_optimize=masks)
    jti.brlen_scalers[:] = (1.0, 1.0, 1.9)
    ti = TreeInfo(c.tree.copy(), [c.tpart, None, to_torch(c2.jpart)],
                  brlen_linkage=common.BRLEN_SCALED, params_to_optimize=masks)
    ti.brlen_scalers[:] = (1.0, 1.0, 1.9)
    return jti, ti


def _assert_same_state(ti, jti):
    """Equal trees, linkage, masks, scalers and partition arrays."""
    np.testing.assert_array_equal(ti.tree.edge_nodes, jti.tree.edge_nodes)
    np.testing.assert_array_equal(ti.tree.lengths, jti.tree.lengths)
    assert ti.tree.labels == list(jti.tree.labels)
    assert ti.brlen_linkage == jti.brlen_linkage
    assert list(ti.params_to_optimize) == list(jti.params_to_optimize)
    np.testing.assert_array_equal(ti.brlen_scalers, jti.brlen_scalers)
    for p, jp in zip(ti.partitions, jti.partitions):
        assert (p is None) == (jp is None)
        if p is None:
            continue
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(jp, f)))
        assert (p.n_tips, p.states, p.n_patterns, p.gamma_mode) == (
            jp.n_tips, jp.states, jp.n_patterns, jp.gamma_mode)


def test_jax_checkpoint_loads_in_port(cross, tmp_path):
    jti, _ = cross
    path = str(tmp_path / "jax.ck")
    jbinary.save_treeinfo(path, jti, extra=b"round=3")
    ti, extra = load_treeinfo(path, device="cpu")
    assert extra == b"round=3"
    _assert_same_state(ti, jti)
    want = jti.compute_loglh()
    assert abs(ti.compute_loglh() - want) <= 1e-10 * abs(want)


def test_port_checkpoint_loads_in_jax(cross, tmp_path):
    _, ti = cross
    path = str(tmp_path / "port.ck")
    save_treeinfo(path, ti, extra=b"round=4")
    jti, extra = jbinary.load_treeinfo(path)
    assert extra == b"round=4"
    _assert_same_state(ti, jti)
    want = ti.compute_loglh()
    assert abs(jti.compute_loglh() - want) <= 1e-10 * abs(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("linkage", [common.BRLEN_LINKED,
                                     common.BRLEN_UNLINKED],
                         ids=["linked", "unlinked"])
def test_treeinfo_roundtrip_bit_for_bit(dtype, linkage, tmp_path):
    part, tree = flagship.simulated(9, 150, dtype=dtype, device="cpu")
    ti = TreeInfo(tree, [part.cache_eigen(), None],
                  brlen_linkage=linkage,
                  params_to_optimize=common.PARAM_ALL)
    if linkage == common.BRLEN_UNLINKED:
        ti.brlens[0, 3] = 0.42
    l0 = ti.compute_loglh()
    path = str(tmp_path / "ck.bin")
    save_treeinfo(path, ti)
    ti2, extra = load_treeinfo(path, device="cpu")
    assert extra == b"" and ti2.partitions[1] is None
    assert ti2.partitions[0].dtype == dtype
    assert ti2.compute_loglh() == l0
    if linkage == common.BRLEN_UNLINKED:
        np.testing.assert_array_equal(ti2.brlens, ti.brlens)
