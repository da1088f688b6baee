"""Mesh construction and site-pattern sharding — the counterpart of
``pllmod_tpu.parallel.sharding``.

The workload's one parallel axis (SURVEY.md §2.10) is the alignment's
site-pattern axis: CLVs are independent across patterns given the
replicated P-matrices, and the logL and its derivatives reduce over the
patterns once. As in the JAX package:

- a 1-D :class:`Mesh` with axis ``"sites"`` over the devices;
- every pattern-indexed array of a partition (``tip_states[:, P]``,
  ``pattern_weights[P]``, ``inv_indicator[P, :]``) is split into
  contiguous blocks, one a device; model parameters, trees and op tables
  are replicated;
- each sum over patterns becomes one reduce of the per-shard sums
  (the reference's ``parallel_reduce_cb``, treeinfo.c:1061-1067).

**A single-controller mesh.** The JAX mesh is one process that drives
every device, its drivers unchanged but for the ``psum`` at each seam.
The port does the same: a :class:`Mesh` is an ordered list of
``torch.device``s (a device may repeat: ``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` on a machine with one card), one host thread issues
every shard's launches in turn, and the reduce
(:func:`pllmod_tpu_torch.ops.engine.reduce_shards`) moves each shard's
partial sums to the mesh's first device and adds them there in shard
order, so the result is deterministic; gradients flow back through the
cross-device copies. A sharded partition is a
:class:`ShardedPartition`: its shards' ``Partition``s, each holding its
pattern block on its own device, whose ``replace`` reaches every shard.
Not ported, each because it exists for JAX's programming model or the
TPU's tiling: ``partition_specs``, ``_spec_sig``, ``_cached_body`` /
``_BODY_CACHE`` (jit and ``shard_map`` plumbing), the 128-lane rule of
``_check_local_shard`` (the padded pattern count must still divide over
the mesh) and the ``interpret`` / ``split`` arguments. In its place each
shard's block is padded with weight-0 patterns to a multiple of
:data:`SHARD_PAD`, the pattern granularity of the port's kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pllmod_tpu_torch.common import (ERROR_UNSUPPORTED, PllModError,
                                     resolve_device)
from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.ops.partition import Partition

SITES_AXIS = "sites"
# a shard's patterns are padded to a multiple of this: kernel 8's simple
# kernel takes multiples of 64 patterns (ops/deriv.py)
SHARD_PAD = 64

# the partition fields that hold patterns (split over the mesh) and the
# model fields (replicated, read from shard 0)
DATA_FIELDS = ("tip_states", "pattern_weights", "inv_indicator")
MODEL_FIELDS = ("code_clv", "subst_rates", "freqs", "rate_cats",
                "rate_weights", "prop_invar", "alpha", "param_indices",
                "eigen_lam", "eigen_V", "eigen_Vinv")


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _all_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise PllModError(ERROR_UNSUPPORTED,
                          "a mesh over the CUDA cards needs at least one "
                          "card; pass devices (e.g. ['cpu'] * 4) to build "
                          "one on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A device mesh: an array of torch devices (``devices``, an object
    array of the mesh's shape; a device may repeat) with one name per
    axis. ``shape[name]`` is an axis's size, as on ``jax.sharding.Mesh``;
    ``device_list`` is the devices in row-major order, and the first of
    them is where reduces land."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of {arr.ndim} dimensions needs "
                             f"{arr.ndim} axis names, got "
                             f"{self.axis_names}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> tuple:
        return tuple(self.devices.ravel())

    def _key(self):
        return (tuple(str(d) for d in self.device_list), self.devices.shape,
                self.axis_names)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.device_list]}, shape="
                f"{self.shape})")


def _mesh_array(devices, shape=None):
    devs = _all_cards() if devices is None else [_device(d)
                                                 for d in devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr if shape is None else arr.reshape(shape)


def make_mesh(devices=None, axis_name: str = SITES_AXIS) -> Mesh:
    """1-D mesh over the site axis: ``devices`` (names or
    ``torch.device``s, repeats allowed), or every CUDA card that
    ``torch.cuda.device_count()`` reports; raises when there is none."""
    return Mesh(_mesh_array(devices), (axis_name,))


def replicate(tree, mesh: Mesh):
    """One copy of ``tree`` (a tensor, a ``Partition``, or tuples, lists
    and dicts of tensors) on each device of the mesh, in mesh order; a
    device that repeats shares its copy."""
    by_dev: dict = {}
    out = []
    for dev in mesh.device_list:
        if dev not in by_dev:
            by_dev[dev] = (tree.to(dev) if isinstance(tree, Partition)
                           else engine_mod.tables_on(tree, dev))
        out.append(by_dev[dev])
    return tuple(out)


def per_shard(tables, shards) -> list:
    """The device tables of one host compile (tensors in tuples, lists,
    dicts) on each shard's device, in shard order: copied once a device,
    never rebuilt."""
    by_dev: dict = {}
    out = []
    for s in shards:
        if s.device not in by_dev:
            by_dev[s.device] = engine_mod.tables_on(tables, s.device)
        out.append(by_dev[s.device])
    return out


class ShardedPartition:
    """A partition whose pattern axis is split over a mesh's site axis:
    ``shards[k]`` is a ``Partition`` of the k-th contiguous block of
    patterns on the k-th device. Model fields are replicated and read
    from shard 0 (``part.freqs``, ``part.alpha``, ...); the pattern
    fields live on the shards only (:meth:`gather` joins them): shard k
    holds the original patterns ``[k·block, (k+1)·block)``, padded with
    weight-0 patterns to a multiple of :data:`SHARD_PAD`. Every
    update (``replace``, ``with_alpha``, ``with_model_params``,
    ``cache_eigen``) reaches every shard, copying the new values onto
    each shard's device, so a tensor that requires grad keeps its graph.
    ``n_patterns_padded`` is the whole partition's padded count;
    ``device`` the mesh's first device, where reduces land."""

    def __init__(self, shards, mesh: Mesh, axis_name: str, n_patterns: int,
                 block: int):
        self.shards = tuple(shards)
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_patterns = n_patterns
        self.block = block

    def __getattr__(self, name):
        if name in MODEL_FIELDS:
            return getattr(self.shards[0], name)
        if name in DATA_FIELDS:
            raise AttributeError(
                f"a sharded partition's {name} lies on its shards "
                "(part.shards[k], or part.gather())")
        raise AttributeError(name)

    # -- shape -----------------------------------------------------------
    @property
    def n_tips(self) -> int:
        return self.shards[0].n_tips

    @property
    def states(self) -> int:
        return self.shards[0].states

    @property
    def gamma_mode(self) -> int:
        return self.shards[0].gamma_mode

    @property
    def reversible(self) -> bool:
        return self.shards[0].reversible

    @property
    def has_pinv(self) -> bool:
        return self.shards[0].has_pinv

    @property
    def n_patterns_padded(self) -> int:
        return self.block * len(self.shards)

    @property
    def n_cats(self) -> int:
        return self.shards[0].n_cats

    @property
    def n_matrices(self) -> int:
        return self.shards[0].n_matrices

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    # -- updates ---------------------------------------------------------
    def replace(self, **changes) -> "ShardedPartition":
        bad = sorted(set(changes) & set(DATA_FIELDS + ("n_patterns",)))
        if bad:
            raise ValueError(f"a sharded partition's patterns are fixed "
                             f"({bad}); shard a new partition instead")
        shards = [s.replace(**{
            k: (v.to(s.device) if isinstance(v, torch.Tensor) else v)
            for k, v in changes.items()}) for s in self.shards]
        return ShardedPartition(shards, self.mesh, self.axis_name,
                                self.n_patterns, self.block)

    def to(self, device=None, dtype=None) -> "ShardedPartition":
        """The shards' float fields in ``dtype``; a sharded partition
        moves only by sharding it anew (``device`` must be None)."""
        if device is not None:
            raise ValueError("a sharded partition moves by re-sharding: "
                             "shard_partition(part.gather().to(...), mesh)")
        return ShardedPartition([s.to(dtype=dtype) for s in self.shards],
                                self.mesh, self.axis_name, self.n_patterns,
                                self.block)

    def eigen(self):
        return self.shards[0].eigen()

    def cache_eigen(self) -> "ShardedPartition":
        """The eigendecomposition computed once (shard 0's model) and
        copied onto every shard."""
        p0 = self.shards[0].cache_eigen()
        return self.replace(eigen_lam=p0.eigen_lam, eigen_V=p0.eigen_V,
                            eigen_Vinv=p0.eigen_Vinv)

    def with_model_params(self, subst_rates=None,
                          freqs=None) -> "ShardedPartition":
        kw = dict(eigen_lam=None, eigen_V=None, eigen_Vinv=None)
        if subst_rates is not None:
            kw["subst_rates"] = subst_rates
        if freqs is not None:
            kw["freqs"] = freqs
        return self.replace(**kw)

    def with_alpha(self, alpha) -> "ShardedPartition":
        """Alpha and its category rates, computed once and copied onto
        every shard (differentiable in ``alpha``)."""
        p0 = self.shards[0].with_alpha(alpha)
        return self.replace(alpha=p0.alpha, rate_cats=p0.rate_cats)

    # -- model reads (shard 0, on the mesh's first device) ----------------
    def prob_matrices(self, brlens):
        return self.shards[0].prob_matrices(brlens)

    def freqs_per_cat(self):
        return self.shards[0].freqs_per_cat()

    def pinv_mix(self):
        return self.shards[0].pinv_mix()

    def pinv_per_cat(self):
        return self.shards[0].pinv_per_cat()

    def gather(self):
        """The whole partition on the mesh's first device (patterns in
        their original order, the shards' own padding dropped)."""
        dev, w = self.device, self.block
        return self.shards[0].replace(
            tip_states=torch.cat([s.tip_states[:, :w].to(dev)
                                  for s in self.shards], dim=1),
            pattern_weights=torch.cat([s.pattern_weights[:w].to(dev)
                                       for s in self.shards]),
            inv_indicator=torch.cat([s.inv_indicator[:w].to(dev)
                                     for s in self.shards]),
            n_patterns=self.n_patterns)


def is_sharded(partition) -> bool:
    return isinstance(partition, ShardedPartition)


def shards_of(partition) -> tuple:
    """A sharded partition's shards; a plain partition as its one
    shard."""
    return partition.shards if is_sharded(partition) else (partition,)


def join_patterns(partition, per_shard_values, axis: int = 0):
    """Per-pattern host arrays of each shard (numpy, the pattern axis at
    ``axis``) joined in the original pattern order, each shard's own
    padding dropped; a plain partition's one array as it is."""
    if not is_sharded(partition):
        return per_shard_values[0]
    w = partition.block
    return np.concatenate([np.take(v, np.arange(w), axis=axis)
                           for v in per_shard_values], axis=axis)


def shard_partition(partition, mesh: Mesh, axis_name: str = SITES_AXIS):
    """Split a partition's pattern axis over the mesh (one contiguous
    block a device) and replicate its model. Returns a
    :class:`ShardedPartition`.

    The padded pattern count must divide over the mesh (create the
    partition with a ``pattern_pad`` that is a multiple of the mesh
    size; the default 128 serves any power-of-two mesh up to 128). Each
    block is padded with weight-0 patterns of the all-gap code 0 to a
    multiple of :data:`SHARD_PAD`."""
    if is_sharded(partition):
        if partition.mesh == mesh and partition.axis_name == axis_name:
            return partition
        partition = partition.gather()
    if len(mesh.axis_names) != 1 or axis_name not in mesh.shape:
        raise ValueError(f"shard_partition takes a 1-D mesh with axis "
                         f"{axis_name!r}, got {mesh}")
    n = partition.n_patterns_padded
    size = mesh.shape[axis_name]
    if n % size:
        raise ValueError(
            f"padded pattern count {n} not divisible by mesh size {size}; "
            f"use pattern_pad that is a multiple of the device count")
    w = n // size
    extra = -(-w // SHARD_PAD) * SHARD_PAD - w
    shards = []
    for k, dev in enumerate(mesh.device_list):
        a, b = k * w, (k + 1) * w
        shards.append(partition.replace(
            tip_states=F.pad(partition.tip_states[:, a:b], (0, extra)),
            pattern_weights=F.pad(partition.pattern_weights[a:b],
                                  (0, extra)),
            inv_indicator=F.pad(partition.inv_indicator[a:b],
                                (0, 0, 0, extra)),
            n_patterns=max(0, min(b, partition.n_patterns) - a)).to(dev))
    return ShardedPartition(shards, mesh, axis_name, partition.n_patterns,
                            w)


def shard_treeinfo(treeinfo, mesh: Mesh, axis_name: str = SITES_AXIS):
    """Distribute a TreeInfo over a site mesh: every local partition's
    pattern axis is sharded over the devices and the mesh is recorded on
    the treeinfo (``treeinfo.mesh`` / ``mesh_axis``). From then on every
    driver (``compute_loglh``, ``opt_model``'s Brent and L-BFGS lanes,
    the BLO, ``spr_round``, ``ml_search``) runs each shard on its own
    device with the reduce at each seam: the reference's one distributed
    contract (``parallel_reduce_cb``, treeinfo.c:1061-1067; the
    per-Newton-iteration reduce, pll_optimize.c:1270-1286). The
    treeinfo's caches are cleared. Returns the treeinfo (modified in
    place)."""
    for i in range(treeinfo.n_partitions):
        if treeinfo.partitions[i] is not None:
            treeinfo.partitions[i] = shard_partition(
                treeinfo.partitions[i], mesh, axis_name)
    treeinfo.mesh = mesh
    treeinfo.mesh_axis = axis_name
    treeinfo.clear_caches()
    return treeinfo


def loglikelihood_resident_sharded(partition, tree, brlens, mesh: Mesh,
                                   axis_name: str = SITES_AXIS):
    """Site-sharded evaluation through the resident walk (kernel 1):
    every shard runs the whole walk over its pattern block on its own
    device, the tables compiled once (at the topology-independent slot
    bound, as the JAX package does) and copied; the logLs are reduced
    (:func:`~pllmod_tpu_torch.ops.engine.reduce_shards`). A float32
    partition (the kernel's); returns a 0-dim tensor on the mesh's first
    device."""
    from pllmod_tpu_torch.ops import resident as resident_mod
    part = shard_partition(partition, mesh, axis_name)
    idx8, e1, e2, n_slots = resident_mod.compile_resident(
        part.shards[0], tree,
        n_slots_min=resident_mod.resident_slot_bound(part.n_tips))
    lnls = [resident_mod.loglikelihood_resident(s, i8, brlens, (a, b),
                                                n_slots)
            for s, (i8, a, b) in zip(part.shards,
                                     per_shard((idx8, e1, e2), part.shards))]
    return engine_mod.reduce_shards(lnls, part.device)


def loglikelihood_fused_sharded(partition, tree, brlens, mesh: Mesh,
                                axis_name: str = SITES_AXIS):
    """Site-sharded evaluation through the fused walk (kernel 2) with its
    root row: every shard walks the whole tree over its pattern block
    and takes its root epilogue; the logLs are reduced. A float32
    partition; returns a 0-dim tensor on the mesh's first device."""
    from pllmod_tpu_torch.ops import fused as fused_mod
    part = shard_partition(partition, mesh, axis_name)
    idx8, e1, e2, ri, n_slots = fused_mod.compile_fused(
        part.shards[0], tree, fuse_root=True)
    lnls = [fused_mod.loglikelihood_fused(s, i8, brlens, a, b, ri, n_slots)
            for s, (i8, a, b) in zip(part.shards,
                                     per_shard((idx8, e1, e2), part.shards))]
    return engine_mod.reduce_shards(lnls, part.device)


def blo_sweep_fast_sharded(partition, tree, brlens, mesh: Mesh,
                           axis_name: str = SITES_AXIS,
                           min_brlen: float = 1e-4, max_brlen: float = 100.0,
                           newton_tol: float = 1e-6,
                           max_newton_iters: int = 10):
    """One site-sharded Newton sweep over every live edge: each shard
    builds its directed CLVs (kernel 2) and its sumtables (kernel 8) over
    its pattern block; every Newton iteration's (d/dt, d²/dt²) come from
    each shard's kernel 9 and are reduced, so every shard takes the same
    step (the reference's per-iteration reduce,
    pll_optimize.c:1270-1286). The per-edge Newton kernel (kernel 10)
    cannot reduce across shards and does not run. A float64 partition
    runs the serial engine's pipeline the same way.

    Returns (new branch lengths [n_edge_slots] on the mesh's first
    device, logL at the incoming lengths)."""
    from pllmod_tpu_torch.optimize import blo as blo_mod
    from pllmod_tpu_torch.optimize.newton import minimize_newton_multi
    part = shard_partition(partition, mesh, axis_name)
    if part.eigen_lam is None:
        part = part.cache_eigen()
    trav = blo_mod.DirectedTraversal(tree)
    tabs = blo_mod._compile_tables(part, trav)
    dev, dtype = part.device, part.dtype
    edges = torch.as_tensor(np.nonzero(trav.edge_mask)[0], device=dev)
    brl = torch.as_tensor(np.clip(np.asarray(brlens, np.float64), min_brlen,
                                  max_brlen), dtype=dtype, device=dev)
    derivs, _ = blo_mod._edge_evaluator(part, tabs, brl, edges)
    t0 = brl[edges]

    def deriv_fn(t):
        _, df, ddf = derivs(t)
        return df.to(t.dtype), ddf.to(t.dtype)

    t_opt = minimize_newton_multi(deriv_fn, t0, min_brlen, max_brlen,
                                  tol=newton_tol, max_iters=max_newton_iters)
    lnl0 = derivs(t0)[0][0].to(dtype)
    new = brl.clone()
    new[edges] = t_opt.to(dtype)
    return new, lnl0
