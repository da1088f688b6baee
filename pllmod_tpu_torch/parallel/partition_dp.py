"""Partition-level data parallelism — the reference's "remote
partitions"; the counterpart of ``pllmod_tpu.parallel.partition_dp``.

In the reference, each MPI rank owns a subset of partitions
(``treeinfo->partitions[p] == NULL`` on non-owner ranks,
treeinfo.c:152-213) and the per-partition log-likelihoods meet in a
``parallel_reduce_cb(..., REDUCE_SUM)``. Here, as in the JAX package, the
partitions are stacked (:func:`stack_partitions`), the stack is split
over a mesh axis ``parts`` in contiguous blocks, each device evaluates
only its own block, and the per-device sums meet in one reduce
(:func:`pllmod_tpu_torch.ops.engine.reduce_shards`, shard order, on the
mesh's first device). A 2-D mesh ``(parts, sites)`` splits the stacked
pattern axis over ``sites`` as well, with one reduce over both axes.

Each (partition, pattern block) is evaluated by the evaluator of
``schedule="auto"`` (``engine.compile_fast_eval``: kernel 1 or kernel 2
for float32, the serial engine for float64), compiled once from the op
table and copied onto each device.

Constraints (stated, reference-equivalent): partitions in one stack
share states, rate-category count and tip count (one alignment split
into parts); pattern axes are padded to the widest partition with
weight-0 patterns (contributing exactly zero) and code tables to the
most codes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from pllmod_tpu_torch.ops import engine as engine_mod
from pllmod_tpu_torch.parallel.sharding import (SITES_AXIS, Mesh,
                                                _mesh_array, is_sharded)

PARTS_AXIS = "parts"


@dataclasses.dataclass(frozen=True)
class PartitionStack:
    """Same-shaped partitions (``parts``), each padded to ``wide``
    patterns and to the stack's code-table rows: the port's form of the
    JAX package's stacked pytree (leaves ``[n_parts, ...]``)."""
    parts: tuple
    wide: int

    def __len__(self) -> int:
        return len(self.parts)


def stack_partitions(parts) -> PartitionStack:
    """Stack same-shaped partitions; pattern axes are padded to the
    widest partition (weight-0 patterns of the all-gap code 0) and code
    tables to the most codes (rows no tip refers to). Raises
    ``ValueError`` for an empty list or partitions of other states,
    categories or tips."""
    if not parts:
        raise ValueError("need at least one partition")
    p0 = parts[0]
    for p in parts[1:]:
        if (p.states != p0.states or p.n_cats != p0.n_cats
                or p.n_tips != p0.n_tips):
            raise ValueError(
                "partition-DP stacks require equal states/cats/tips")
    wide = max(p.n_patterns_padded for p in parts)
    n_codes = max(p.code_clv.shape[0] for p in parts)
    padded = []
    for p in parts:
        extra = wide - p.n_patterns_padded
        padded.append(p.replace(
            tip_states=F.pad(p.tip_states, (0, extra)),
            pattern_weights=F.pad(p.pattern_weights, (0, extra)),
            inv_indicator=F.pad(p.inv_indicator, (0, 0, 0, extra)),
            code_clv=F.pad(p.code_clv,
                           (0, 0, 0, n_codes - p.code_clv.shape[0])),
            # the JAX package unifies the static unpadded count so that
            # the pytrees stack; padding patterns carry weight 0
            n_patterns=wide))
    return PartitionStack(tuple(padded), wide)


def make_parts_mesh(devices=None, axis_name: str = PARTS_AXIS) -> Mesh:
    """1-D mesh over the partition axis (every CUDA card by default)."""
    return Mesh(_mesh_array(devices), (axis_name,))


def make_2d_mesh(shape, devices=None,
                 axis_names=(PARTS_AXIS, SITES_AXIS)) -> Mesh:
    """2-D device mesh (parts × sites) of ``shape`` over ``devices``
    (every CUDA card by default), in row-major order."""
    return Mesh(_mesh_array(devices, tuple(shape)), axis_names)


class _OpsTree:
    """A traversal as ``compile_fast_eval`` reads a tree: the op table
    and the root info."""

    def __init__(self, ops, root_info):
        self._out = (np.asarray(ops), tuple(int(x) for x in root_info))

    def traversal_ops(self, root_edge=None):
        return self._out


def _loglh_partition_dp(stacked, ops, brlens_stacked, root_info,
                        mesh: Mesh, parts_axis: str,
                        sites_axis: str | None):
    """The 1-D (parts) and 2-D (parts × sites) partition-DP evaluation:
    device (p, s) evaluates partition block p over pattern block s; one
    reduce over every device in mesh order."""
    n_parts = brlens_stacked.shape[0]
    n_pdev = mesh.shape[parts_axis]
    if n_parts % n_pdev:
        raise ValueError(f"{n_parts} partitions not divisible over "
                         f"{n_pdev} devices on '{parts_axis}'; pad with "
                         f"weight-0 partitions")
    axes = (parts_axis,) if sites_axis is None else (parts_axis,
                                                     sites_axis)
    if mesh.axis_names != axes:
        raise ValueError(f"expected a mesh with axes {axes}, got "
                         f"{mesh.axis_names}")
    n_sdev = 1
    if sites_axis is not None:
        n_sdev = mesh.shape[sites_axis]
        if stacked.wide % n_sdev:
            raise ValueError(f"{stacked.wide} padded patterns not divisible "
                             f"over {n_sdev} devices on '{sites_axis}'")
    devs = mesh.devices.reshape(n_pdev, n_sdev)
    n_local, w = n_parts // n_pdev, stacked.wide // n_sdev

    def block(i, s):
        p = stacked.parts[i]
        a, b = s * w, (s + 1) * w
        return p.replace(tip_states=p.tip_states[:, a:b].contiguous(),
                         pattern_weights=p.pattern_weights[a:b].contiguous(),
                         inv_indicator=p.inv_indicator[a:b].contiguous(),
                         n_patterns=w).to(devs[i // n_local, s])

    tree = _OpsTree(ops, root_info)
    first = None
    by_dev: dict = {}
    sums = []
    for pd in range(n_pdev):
        for s in range(n_sdev):
            dev = devs[pd, s]
            lnls = []
            for i in range(pd * n_local, (pd + 1) * n_local):
                part = block(i, s)
                if first is None:
                    first = engine_mod.compile_fast_eval(part, tree)
                    by_dev[dev] = first
                if dev not in by_dev:
                    by_dev[dev] = engine_mod.evaluator_on(first, dev)
                lnls.append(by_dev[dev](part, brlens_stacked[i]))
            sums.append(engine_mod.reduce_shards(lnls, dev))
    return engine_mod.reduce_shards(sums, mesh.device_list[0])


def total_loglh_partition_dp(stacked, ops, brlens_stacked, root_info,
                             mesh: Mesh, axis_name: str = PARTS_AXIS):
    """Total logL = Σ over partitions, each evaluated only on its owner
    device (contiguous blocks of partitions over the ``parts`` axis),
    the per-device sums reduced once.

    Args:
      stacked: :func:`stack_partitions`' stack
      ops: int [n_inner, 5] op table (``Tree.traversal_ops``)
      brlens_stacked: [n_parts, n_edges] per-partition branch lengths
        (the shared lengths for LINKED, scaled for SCALED)
      root_info: (u, v, root_edge)
    Returns a 0-dim tensor on the mesh's first device."""
    return _loglh_partition_dp(stacked, ops, brlens_stacked, root_info,
                               mesh, axis_name, None)


def total_loglh_partition_dp_2d(stacked, ops, brlens_stacked, root_info,
                                mesh: Mesh, parts_axis: str = PARTS_AXIS,
                                sites_axis: str = SITES_AXIS):
    """Partition-level DP composed with site sharding on a 2-D mesh:
    each device owns one (partition block × pattern block) tile — the
    reference's remote partitions (treeinfo.c:152-213) and per-rank site
    splits in one pass, with one reduce over both axes (the per-site
    power-of-two rescale couples no sites, so site sharding is
    exact)."""
    return _loglh_partition_dp(stacked, ops, brlens_stacked, root_info,
                               mesh, parts_axis, sites_axis)


def treeinfo_loglh_partition_dp(treeinfo, mesh: Mesh,
                                axis_name: str = PARTS_AXIS) -> float:
    """A TreeInfo's total logL with its partitions distributed over the
    mesh (the rank-distribution analog of treeinfo.c's remote
    partitions; the linkage respected through per-partition lengths).
    Sharded partitions are gathered first."""
    idxs = [i for i, p in enumerate(treeinfo.partitions) if p is not None]
    parts = [p.gather() if is_sharded(p) else p
             for p in (treeinfo.partitions[i] for i in idxs)]
    stacked = stack_partitions(parts)
    ops, root_info = treeinfo.tree.traversal_ops()
    brl = torch.stack([
        torch.as_tensor(np.asarray(treeinfo.partition_brlens(i), np.float64),
                        dtype=parts[0].dtype, device=parts[0].device)
        for i in idxs])
    return float(total_loglh_partition_dp(stacked, ops, brl, root_info,
                                          mesh, axis_name))
