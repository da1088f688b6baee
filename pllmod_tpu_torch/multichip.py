"""A dry run of the port's multi-device paths — the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``, with the same parts at
the same small shapes:

- A: one gradient step on a sharded partition (the edge decomposition's
  (value, grad), reduced over the shards), finite;
- B: flagship-like shapes, a SCALED two-partition ``TreeInfo``, sharded
  against replicated;
- C: the fused (kernel 2) and resident (kernel 1) sharded evaluations
  and one sharded BLO sweep (kernels 2, 8, 9), which must not lower the
  logL;
- E: ``opt_alpha``, ``opt_subst_rates``, one ``spr_round`` and a
  two-round ``ml_search``, each sharded against unsharded;
- D: the 2-D (parts × sites) mesh against the serial sum.

On CPU devices (``devices=["cpu"] * n``) the comparisons run in float64
(1e-6 relative) and the kernels' plain versions serve part C; on CUDA
devices everything runs in float32, the kernels launched, within 5e-6.

    python -m pllmod_tpu_torch.multichip [n]     # n cards, default all
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from pllmod_tpu_torch import flagship
from pllmod_tpu_torch.algorithm.opt_model import opt_alpha, opt_subst_rates
from pllmod_tpu_torch.algorithm.search import ml_search
from pllmod_tpu_torch.algorithm.spr import spr_round
from pllmod_tpu_torch.common import (BRLEN_SCALED, PARAM_ALPHA,
                                     PARAM_BRANCHES_ITERATIVE)
from pllmod_tpu_torch.ops import engine
from pllmod_tpu_torch.optimize import edge_grad
from pllmod_tpu_torch.parallel import (blo_sweep_fast_sharded,
                                       loglikelihood_fused_sharded,
                                       loglikelihood_resident_sharded,
                                       make_2d_mesh, make_mesh,
                                       shard_partition, shard_treeinfo,
                                       stack_partitions,
                                       total_loglh_partition_dp_2d)
from pllmod_tpu_torch.tree.splits import rf_distance
from pllmod_tpu_torch.tree.treeinfo import TreeInfo

# (taxa, sites) of each part, the JAX dry run's
GRAD_SHAPE = (8, 64)
FLAGSHIP_LIKE = (64, 8192)
KERNEL_SHAPE = (48, 4096)
DRIVER_SHAPE = (10, 96)
DP_SHAPE = (8, 64)


def _close(got: float, want: float, rtol: float, what: str) -> None:
    if not abs(got - want) <= rtol * max(1.0, abs(want)):
        raise AssertionError(f"{what}: {got!r} != {want!r} (rtol {rtol})")


def _softplus_inv(x):
    return torch.log(torch.expm1(torch.clamp(x, min=1e-6)))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run parts A, B, C, E and D (D on an even ``n_devices``) on a mesh
    of ``n_devices`` devices: ``devices`` (names or ``torch.device``s,
    repeats allowed, e.g. ``["cpu"] * 8`` or ``["cuda:0"] * 4``), by
    default the first ``n_devices`` cards (raises when there are
    fewer). Raises on any check that fails; returns a dict of what each
    part measured."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    mesh = make_mesh(devices)
    dev0 = mesh.device_list[0]
    on_cpu = dev0.type == "cpu"
    bdtype = torch.float64 if on_cpu else torch.float32
    rtol = 1e-6 if on_cpu else 5e-6
    out = {"devices": [str(d) for d in mesh.device_list]}

    # ---- part A: one gradient step on a sharded partition
    part, tree = flagship.example(*GRAD_SHAPE, seed=1, dtype=bdtype,
                                  device=dev0)
    sh = shard_partition(part, mesh)
    et = edge_grad.edge_tables(sh, tree)
    f64 = dict(dtype=torch.float64, device=dev0)
    params = {
        "rates_raw": _softplus_inv(part.subst_rates.to(**f64)),
        "freq_logits": torch.log(part.freqs.to(**f64)),
        "alpha_raw": _softplus_inv(torch.tensor(0.75, **f64)),
        "brlens_raw": _softplus_inv(torch.as_tensor(tree.lengths, **f64)),
    }
    for v in params.values():
        v.requires_grad_(True)

    def loss(p):
        q = sh.with_model_params(
            subst_rates=F.softplus(p["rates_raw"]).to(bdtype),
            freqs=torch.softmax(p["freq_logits"], -1).to(bdtype),
        ).with_alpha(F.softplus(p["alpha_raw"]))
        return edge_grad.edge_decomp_neg_loglh(
            q, F.softplus(p["brlens_raw"]).to(bdtype), et)

    val = loss(params)
    grads = torch.autograd.grad(val, list(params.values()))
    with torch.no_grad():
        new = {k: v - 1e-2 * g for (k, v), g in zip(params.items(), grads)}
    val = float(val.detach())
    if not np.isfinite(val):
        raise AssertionError(f"non-finite loss {val}")
    for k, v in new.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite step of {k}")
    out["A_loss"] = val

    # ---- part B: flagship-like shapes, a SCALED two-partition TreeInfo
    big1, btree = flagship.example(*FLAGSHIP_LIKE, seed=11, dtype=bdtype,
                                   device=dev0)
    big2 = big1.with_alpha(1.4)
    scalers = (1.0, 1.7)

    def scaled_ti():
        ti = TreeInfo(btree.copy(), [big1, big2], brlen_linkage=BRLEN_SCALED)
        ti.brlen_scalers[:] = scalers
        return ti

    l_rep = scaled_ti().compute_loglh()
    ti_sh = shard_treeinfo(scaled_ti(), mesh)
    l_sh = ti_sh.compute_loglh()
    _close(l_sh, l_rep, rtol, "sharded SCALED TreeInfo against replicated")
    out["B"] = dict(replicated=l_rep, sharded=l_sh)
    del big1, big2, ti_sh

    # ---- part C: the sharded kernel routes (float32)
    f32p, ftree = flagship.example(*KERNEL_SHAPE, seed=13,
                                   dtype=torch.float32, device=dev0)
    f32p = f32p.cache_eigen()
    l_one = float(engine.tree_loglikelihood(f32p, ftree, schedule="scan"))
    l_fused = float(loglikelihood_fused_sharded(f32p, ftree, ftree.lengths,
                                                mesh))
    _close(l_fused, l_one, 5e-6, "fused sharded")
    l_res = float(loglikelihood_resident_sharded(f32p, ftree, ftree.lengths,
                                                 mesh))
    _close(l_res, l_one, 5e-6, "resident sharded")
    new_brl, l_before = blo_sweep_fast_sharded(f32p, ftree, ftree.lengths,
                                               mesh)
    _close(float(l_before), l_one, 5e-6, "sharded BLO sweep's start logL")
    l_after = float(loglikelihood_resident_sharded(
        f32p, ftree, new_brl.cpu().double().numpy(), mesh))
    if not l_after >= float(l_before) - 1e-6 * abs(float(l_before)):
        raise AssertionError(f"sharded BLO sweep lowered the logL: "
                             f"{l_after} < {float(l_before)}")
    out["C"] = dict(scan=l_one, fused=l_fused, resident=l_res,
                    blo_before=float(l_before), blo_after=l_after)
    del f32p

    # ---- part E: the drivers, sharded against unsharded, on two
    # alignments simulated along one tree (well-conditioned optima; the
    # JAX dry run draws random characters), started two random SPR moves
    # away from it
    eparts = []
    for k in range(2):
        ek, etree = flagship.simulated(*DRIVER_SHAPE, seed=31,
                                       sim_seed=11 + k, dtype=bdtype,
                                       device=dev0)
        eparts.append(ek.with_alpha(0.5 + 0.4 * k))
    flagship.random_spr(etree, 2, np.random.default_rng(31))

    def pair(parts, masks=None):
        return (TreeInfo(etree.copy(), list(parts), params_to_optimize=masks),
                shard_treeinfo(TreeInfo(etree.copy(), list(parts),
                                        params_to_optimize=masks), mesh))

    E = {}
    for name, fn in (("opt_alpha", opt_alpha),
                     ("opt_subst_rates", opt_subst_rates)):
        ref, shd = pair(eparts)
        want, got = fn(ref), fn(shd)
        _close(got, want, rtol, f"sharded {name}")
        E[name] = (want, got)
    ref, shd = pair(eparts)
    l0 = ref.compute_loglh()
    want, n_ref, _ = spr_round(ref, radius_min=1, radius_max=3)
    got, n_sh, _ = spr_round(shd, radius_min=1, radius_max=3)
    if n_sh != n_ref:
        raise AssertionError(f"sharded spr_round applied {n_sh} moves, "
                             f"unsharded {n_ref}")
    if not got >= l0 - rtol * abs(l0):
        raise AssertionError(f"sharded spr_round lowered the logL: {got} "
                             f"< {l0}")
    _close(got, want, rtol, "sharded spr_round")
    E["spr_round"] = (want, got, n_ref)
    smask = PARAM_ALPHA | PARAM_BRANCHES_ITERATIVE
    ref, shd = pair(eparts[:1], [smask])
    res_ref = ml_search(ref, radius_max=3, max_rounds=2, thorough=False)
    res_sh = ml_search(shd, radius_max=3, max_rounds=2, thorough=False)
    _close(res_sh.loglh, res_ref.loglh, rtol, "sharded ml_search")
    if rf_distance(ref.tree, shd.tree) != 0:
        raise AssertionError("sharded ml_search found another topology")
    E["ml_search"] = (res_ref.loglh, res_sh.loglh)
    out["E"] = E

    # ---- part D: the 2-D mesh (parts × sites)
    if n_devices % 2 == 0:
        dparts = []
        for k in range(4):
            pk, _ = flagship.example(*DP_SHAPE, seed=20 + k, dtype=bdtype,
                                     device=dev0)
            dparts.append(pk.with_alpha(0.6 + 0.3 * k))
        dtree = flagship.example(DP_SHAPE[0], 8, seed=20, device="cpu")[1]
        want = sum(float(engine.tree_loglikelihood(p, dtree, schedule="scan"))
                   for p in dparts)
        dops, dri = dtree.traversal_ops()
        dbrl = torch.stack([torch.as_tensor(dtree.lengths, dtype=bdtype,
                                            device=dev0)] * 4)
        mesh2d = make_2d_mesh((2, n_devices // 2), devices=devices)
        got = float(total_loglh_partition_dp_2d(
            stack_partitions(dparts), dops, dbrl, dri, mesh2d))
        _close(got, want, rtol, "2-D mesh against the serial sum")
        out["D"] = dict(serial=want, mesh_2d=got)
    return out


if __name__ == "__main__":
    n = (int(sys.argv[1]) if len(sys.argv) > 1 else
         torch.cuda.device_count())
    print(dryrun_multichip(n))
    print("dryrun_multichip OK")
