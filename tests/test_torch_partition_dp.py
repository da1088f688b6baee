"""The port's partition-level data parallelism
(``pllmod_tpu_torch/parallel/partition_dp.py``) on CPU devices, in
float64: ``tests/test_partition_dp.py``'s five cases on the same inputs
(the partitions built by the JAX package and carried over), each total
within 1e-10 of the port's serial sum and 1e-9 of the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pllmod_tpu.ops import engine as jax_engine
from pllmod_tpu.ops.partition import create_partition
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu.common import BRLEN_SCALED as JAX_SCALED
from pllmod_tpu_torch.common import BRLEN_SCALED
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.parallel import (make_2d_mesh, make_parts_mesh,
                                       make_mesh, shard_treeinfo,
                                       stack_partitions,
                                       total_loglh_partition_dp,
                                       total_loglh_partition_dp_2d,
                                       treeinfo_loglh_partition_dp)
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests import reference_impl as ref
from tests.torch_cases import rel_err, to_torch, to_torch_tree, with_eigen
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _partitions(rng, n_parts, n=10):
    """tests/test_partition_dp.py's partitions: 64 or 96 sites, alpha
    0.5 + 0.3 k, random rates and frequencies; (JAX, port) pairs."""
    out = []
    for k in range(n_parts):
        seqs = ref.random_sequences(rng, n, 64 + 32 * (k % 2))
        jp = with_eigen(create_partition(
            seqs, states=4, n_rate_cats=4, alpha=0.5 + 0.3 * k,
            subst_rates=rng.uniform(0.5, 2.0, 6),
            freqs=rng.dirichlet([8] * 4), dtype=jnp.float64))
        out.append((jp, to_torch(jp)))
    return out


def _serial(pairs, jtree):
    tree = to_torch_tree(jtree)
    mine = sum(float(engine.tree_loglikelihood(p, tree, schedule="scan"))
               for _, p in pairs)
    theirs = sum(float(jax_engine.tree_loglikelihood(j, jtree,
                                                     schedule="scan"))
                 for j, _ in pairs)
    return mine, theirs


def _stack_args(pairs, jtree):
    tree = to_torch_tree(jtree)
    ops, root_info = tree.traversal_ops()
    brl = torch.stack([torch.as_tensor(tree.lengths, dtype=torch.float64)]
                      * len(pairs))
    return stack_partitions([p for _, p in pairs]), ops, brl, root_info


def test_partition_dp_matches_serial(rng):
    jtree = ref.random_binary_tree(rng, 10)
    pairs = _partitions(rng, 8)
    got = float(total_loglh_partition_dp(*_stack_args(pairs, jtree),
                                         make_parts_mesh(["cpu"] * 8)))
    mine, theirs = _serial(pairs, jtree)
    assert rel_err(got, mine) < 1e-10
    assert rel_err(got, theirs) < 1e-9


def test_partition_dp_treeinfo_scaled(rng):
    """SCALED linkage through the distributed evaluation, from a plain
    and from a site-sharded TreeInfo."""
    jtree = ref.random_binary_tree(rng, 9)
    pairs = _partitions(rng, 4, 9)
    scalers = [1.0, 1.5, 0.7, 2.0]
    ti = TreeInfo(to_torch_tree(jtree), [p for _, p in pairs],
                  brlen_linkage=BRLEN_SCALED)
    ti.brlen_scalers[:] = scalers
    jti = JaxTreeInfo(jtree, [j for j, _ in pairs],
                      brlen_linkage=JAX_SCALED)
    jti.brlen_scalers[:] = scalers
    mesh = make_parts_mesh(["cpu"] * 4)
    got = treeinfo_loglh_partition_dp(ti, mesh)
    assert rel_err(got, ti.compute_loglh()) < 1e-10
    assert rel_err(got, jti.compute_loglh()) < 1e-9
    shard_treeinfo(ti, make_mesh(["cpu"] * 2))
    assert rel_err(treeinfo_loglh_partition_dp(ti, mesh), got) < 1e-10


def test_partition_dp_shape_mismatch_raises(rng):
    seqs = ref.random_sequences(rng, 8, 50)
    p4, p2cat = (to_torch(create_partition(seqs, states=4, n_rate_cats=c,
                                           alpha=1.0, dtype=jnp.float64))
                 for c in (4, 2))
    with pytest.raises(ValueError, match="equal states"):
        stack_partitions([p4, p2cat])
    with pytest.raises(ValueError, match="at least one"):
        stack_partitions([])


def test_partition_dp_2d_mesh_matches_serial(rng):
    """The (parts × sites) mesh: four partitions over 2 × 4 devices, the
    widest pattern axis padded and split in four; one reduce."""
    jtree = ref.random_binary_tree(rng, 10)
    pairs = _partitions(rng, 4)
    args = _stack_args(pairs, jtree)
    assert args[0].wide == 128 and len(args[0]) == 4
    got = float(total_loglh_partition_dp_2d(
        *args, make_2d_mesh((2, 4), ["cpu"] * 8)))
    mine, theirs = _serial(pairs, jtree)
    assert rel_err(got, mine) < 1e-10
    np.testing.assert_allclose(got, theirs, rtol=1e-9)


def test_partition_dp_2d_indivisible_raises(rng):
    jtree = ref.random_binary_tree(rng, 6)
    pairs = _partitions(rng, 3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        total_loglh_partition_dp_2d(*_stack_args(pairs, jtree),
                                    make_2d_mesh((2, 4), ["cpu"] * 8))
