"""The port's site mesh (``pllmod_tpu_torch/parallel/sharding.py``) on
CPU devices, in float64 unless a kernel route needs float32.

- ``make_mesh``: devices (repeats allowed), axis sizes; no devices and
  no card raises.
- ``shard_partition``: contiguous pattern blocks a device (each padded
  to the kernels' 64-pattern granularity), the model replicated,
  ``gather`` the inverse; an indivisible padded pattern count raises
  ``ValueError`` as the JAX package's does; updates reach every shard.
- A two-partition SCALED ``TreeInfo`` sharded 2, 4 and 8 ways:
  ``compute_loglh`` full, incremental and per site within 1e-10 of the
  unsharded port and 1e-9 of the JAX package's unsharded ``TreeInfo``.
- The resident and fused sharded evaluations (float32, the kernels'
  plain versions) against the unsharded kernel routes.
- ``blo_sweep_fast_sharded`` at mesh sizes 2, 4 and 8 against the
  unsharded sweep (``blo._blo_sweep``, kernel 9's route).
- ``multichip.dryrun_multichip(8, ["cpu"] * 8)`` at reduced shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pllmod_tpu.common import BRLEN_SCALED as JAX_SCALED
from pllmod_tpu.parallel import make_mesh as jax_make_mesh
from pllmod_tpu.parallel import shard_partition as jax_shard_partition
from pllmod_tpu.tree.treeinfo import TreeInfo as JaxTreeInfo
from pllmod_tpu_torch import multichip
from pllmod_tpu_torch.common import BRLEN_SCALED, PllModError
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.optimize import blo
from pllmod_tpu_torch.parallel.sharding import SHARD_PAD
from pllmod_tpu_torch.parallel import (blo_sweep_fast_sharded, is_sharded,
                                       loglikelihood_fused_sharded,
                                       loglikelihood_resident_sharded,
                                       make_mesh, replicate,
                                       shard_partition, shard_treeinfo)
from pllmod_tpu_torch.tree.treeinfo import TreeInfo
from tests.torch_cases import make_case, rel_err
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

SCALERS = (1.0, 1.7)
EDGE = 5                      # the length the incremental check changes


@pytest.fixture(scope="module")
def cases():
    """Two float64 cases, 12 × 512 and 12 × 300 (384 padded patterns),
    both laid on the first one's tree."""
    return (make_case(3, 12, 512, dtype=jnp.float64),
            make_case(4, 12, 300, dtype=jnp.float64))


def _scaled(tree, parts):
    ti = TreeInfo(tree.copy(), list(parts), brlen_linkage=BRLEN_SCALED)
    ti.brlen_scalers[:] = SCALERS
    return ti


@pytest.fixture(scope="module")
def jax_values(cases):
    """The JAX package's unsharded SCALED TreeInfo: (full logL, the logL
    after EDGE's length × 1.5 by its incremental route, the per-site
    vectors at the start lengths)."""
    c1, c2 = cases
    jti = JaxTreeInfo(c1.jtree.copy(), [c1.jpart, c2.jpart],
                      brlen_linkage=JAX_SCALED)
    jti.brlen_scalers[:] = SCALERS
    full = jti.compute_loglh()
    _, persite = jti.compute_loglh_persite()
    jti.compute_loglh(incremental=True)
    jti.set_branch_length(EDGE, float(jti.tree.lengths[EDGE]) * 1.5)
    return full, jti.compute_loglh(incremental=True), persite


def test_make_mesh(monkeypatch):
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.shape == {"sites": 4} and mesh.size == 4
    assert mesh.device_list == (torch.device("cpu"),) * 4
    assert mesh == make_mesh([torch.device("cpu")] * 4)
    assert hash(mesh) == hash(make_mesh(["cpu"] * 4))
    assert make_mesh(["cpu"], axis_name="parts").shape == {"parts": 1}
    x = torch.arange(3.0)
    copies = replicate({"x": x}, mesh)
    assert len(copies) == 4 and all(c["x"] is x for c in copies)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PllModError):
        make_mesh()
    with pytest.raises(PllModError):
        make_mesh(["cuda:0"] * 2)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_partition_splits_patterns(cases, n):
    part = cases[0].tpart
    sh = shard_partition(part, make_mesh(["cpu"] * n))
    assert is_sharded(sh) and len(sh.shards) == n
    assert sh.n_patterns_padded == part.n_patterns_padded
    assert sh.n_patterns == part.n_patterns
    w = part.n_patterns_padded // n
    for k, s in enumerate(sh.shards):
        assert s.tip_states.shape == (part.n_tips, w)
        assert s.tip_states.is_contiguous()
        assert torch.equal(s.pattern_weights,
                           part.pattern_weights[k * w:(k + 1) * w])
        assert s.freqs is part.freqs
    assert sum(s.n_patterns for s in sh.shards) == part.n_patterns
    whole = sh.gather()
    for f in ("tip_states", "pattern_weights", "inv_indicator"):
        assert torch.equal(getattr(whole, f), getattr(part, f))
    assert shard_partition(sh, sh.mesh) is sh


def test_shard_blocks_padded_to_the_kernels_granularity(cases):
    """384 padded patterns over 8 devices: blocks of 48, each padded with
    weight-0 gap patterns to 64 (SHARD_PAD); gather drops the padding."""
    part = cases[1].tpart
    sh = shard_partition(part, make_mesh(["cpu"] * 8))
    assert sh.block == 48 and sh.n_patterns_padded == 384
    for k, s in enumerate(sh.shards):
        assert s.n_patterns_padded == SHARD_PAD
        assert torch.equal(s.tip_states[:, :48],
                           part.tip_states[:, 48 * k:48 * (k + 1)])
        assert not s.tip_states[:, 48:].any()
        assert not s.pattern_weights[48:].any()
    whole = sh.gather()
    for f in ("tip_states", "pattern_weights", "inv_indicator"):
        assert torch.equal(getattr(whole, f), getattr(part, f))


def test_shard_partition_indivisible_raises(cases):
    """512 padded patterns over 3 devices: both packages refuse."""
    c = cases[0]
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        shard_partition(c.tpart, make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        jax_shard_partition(c.jpart, jax_make_mesh(jax.devices()[:3]))


def test_sharded_partition_updates_reach_every_shard(cases):
    sh = shard_partition(cases[0].tpart, make_mesh(["cpu"] * 4))
    a = sh.with_alpha(1.3)
    assert all(torch.equal(s.rate_cats, a.shards[0].rate_cats)
               and float(s.alpha) == 1.3 for s in a.shards)
    r = a.with_model_params(subst_rates=torch.full_like(sh.subst_rates, 2))
    assert all(s.eigen_lam is None and float(s.subst_rates[0, 0]) == 2
               for s in r.shards)
    e = r.cache_eigen()
    assert all(s.eigen_V is e.shards[0].eigen_V for s in e.shards)
    x = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    p = sh.replace(prop_invar=x.expand(1))
    assert all(s.prop_invar.requires_grad for s in p.shards)
    with pytest.raises(ValueError, match="patterns are fixed"):
        sh.replace(pattern_weights=cases[0].tpart.pattern_weights)
    with pytest.raises(AttributeError, match="lies on its shards"):
        sh.tip_states
    with pytest.raises(ValueError, match="re-sharding"):
        sh.to("cpu")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_compute_loglh(cases, jax_values, n):
    """Full, incremental (after one changed length) and per site."""
    c1, c2 = cases
    parts = (c1.tpart, c2.tpart)
    ref = _scaled(c1.tree, parts)
    ti = shard_treeinfo(_scaled(c1.tree, parts), make_mesh(["cpu"] * n))
    assert ti.mesh.size == n and ti.mesh_axis == "sites"
    want_full, want_inc, want_site = jax_values
    full = ti.compute_loglh()
    assert rel_err(full, ref.compute_loglh()) < 1e-10
    assert rel_err(full, want_full) < 1e-9
    np.testing.assert_allclose(ti.partition_loglh, ref.partition_loglh,
                               rtol=1e-10)
    total, site = ti.compute_loglh_persite()
    _, site_ref = ref.compute_loglh_persite()
    assert rel_err(total, want_full) < 1e-9
    for got, mine, theirs in zip(site, site_ref, want_site):
        np.testing.assert_allclose(got, mine, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got, np.asarray(theirs), rtol=1e-9,
                                   atol=1e-12)
    for t in (ti, ref):
        t.compute_loglh(incremental=True)
        t.set_branch_length(EDGE, float(t.tree.lengths[EDGE]) * 1.5)
    inc = ti.compute_loglh(incremental=True)
    assert rel_err(inc, ref.compute_loglh(incremental=True)) < 1e-10
    assert rel_err(inc, want_inc) < 1e-9
    assert rel_err(inc, ti.compute_loglh()) < 1e-10
    # the shards' evaluators and buffers are what clear_caches drops
    assert ti._fast_cache and len(ti._incr_cache[0]["clvs"]) == n
    ti.clear_caches()
    assert not (ti._fast_cache or ti._incr_cache)


@pytest.mark.parametrize("route", ["resident", "fused"])
def test_sharded_kernel_routes(cases, route):
    """Kernel 1 / kernel 2 on each of four shards (float32, their plain
    versions here) against the unsharded route, 1e-6, and the float64
    logL of the same data, 1e-6."""
    c = cases[0]
    part = c.tpart.to(dtype=torch.float32).with_model_params().cache_eigen()
    tree = c.tree
    fn = (loglikelihood_resident_sharded if route == "resident"
          else loglikelihood_fused_sharded)
    got = float(fn(part, tree, tree.lengths, make_mesh(["cpu"] * 4)))
    one = float(engine.compile_fast_eval(part, tree, schedule=route)(
        part, tree.lengths))
    assert rel_err(got, one) < 1e-6
    l64 = float(engine.tree_loglikelihood(c.tpart, tree, schedule="scan"))
    assert rel_err(got, l64) < 1e-6


@pytest.mark.parametrize("n", [2, 4, 8])
def test_blo_sweep_fast_sharded(cases, n):
    """One sharded Newton sweep against the unsharded one over every live
    edge (kernel 9's route, the same clipped start): the start logL within
    1e-10, the lengths within 1e-8 relative."""
    c = cases[0]
    part, tree = c.tpart.cache_eigen(), c.tree
    new, lnl0 = blo_sweep_fast_sharded(part, tree, tree.lengths,
                                       make_mesh(["cpu"] * n))
    trav = blo.DirectedTraversal(tree)
    edges = torch.as_tensor(np.nonzero(trav.edge_mask)[0])
    brl = torch.as_tensor(np.clip(tree.lengths, 1e-4, 100.0),
                          dtype=torch.float64)
    want, want0 = blo._blo_sweep(part, blo._compile_tables(part, trav),
                                 edges, brl, 1e-4, 100.0, 1e-6,
                                 fused_newton=False)
    assert rel_err(lnl0, want0) < 1e-10
    np.testing.assert_allclose(new.numpy(), want.numpy(), rtol=1e-8)
    assert float(engine.tree_loglikelihood(part, tree, new)) > float(lnl0)


def test_dryrun_multichip(monkeypatch):
    """The dry run on an 8-device CPU mesh, at shapes cut to this suite's
    size (its own checks raise on any failure)."""
    for name, shape in (("FLAGSHIP_LIKE", (12, 512)),
                        ("KERNEL_SHAPE", (12, 512)),
                        ("DRIVER_SHAPE", (6, 64))):
        monkeypatch.setattr(multichip, name, shape)
    out = multichip.dryrun_multichip(8, ["cpu"] * 8)
    assert out["devices"] == ["cpu"] * 8
    assert set(out) >= {"A_loss", "B", "C", "E", "D"}
    assert out["C"]["blo_after"] > out["C"]["blo_before"]
