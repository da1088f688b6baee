#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``pllmod_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile]

It builds the CUDA kernels from ``pllmod_tpu_torch/csrc`` into ``build/``
(one ``nvcc`` a source, all six at once), holds each kernel against its
plain torch version on the card (the fused walk at four shapes: the
flagship's fuse_root and directed tables, protein, 64 states), and
drives ten paths, each run with every kernel's launch count set to 0
just before it and read just after, the launches logged by cell and
path (``counted``):

1. the full-tree logL (``engine.tree_loglikelihood``, ``schedule=
   "auto"``) on every cell, checked against the float64 serial engine;
2. branch-length optimization (``blo.optimize_branch_lengths``) at the
   flagship DNA cell, checked against the float64 serial engine at the
   returned lengths; then the same call with ``fused_newton=False``, on
   the protein cell, and the memory-bounded sweep against it;
3. the level and grouped schedules at the flagship DNA and protein
   cells: ``schedule="pallas"`` (kernels 3 and 4 each level), the
   ``level_update`` driver (kernel 3 twice a level), the
   ``level_update_combined`` driver (kernel 5), the grouped walk
   (kernel 7) and ``schedule="levels"`` (plain torch), each checked
   against the float64 serial engine;
4. the packed walk (``packed.loglikelihood_packed``, kernel 6) at the
   flagship DNA and protein cells, checked against the float64 serial
   engine;
5. a partitioned analysis: a ``TreeInfo`` on the flagship tree with two
   partitions (the flagship DNA alignment and a protein alignment of
   4096 sites +G4), its ``compute_loglh`` (full, incremental after one
   changed length, per site) and ``optimize_branch_lengths_treeinfo`` in
   LINKED and SCALED (1.0, 0.5) modes, checked against the float64
   serial engine; kernel 10 for two partitions against its plain
   version;
6. model-parameter optimization (``algorithm/opt_model.py``), path
   ``opt_model``: the CLI's ``eval ... --model GTR+G4 --opt`` (parsed
   by ``cli.parse_args``, run by ``cmd_eval``) on the flagship
   alignment and tree written to
   ``build/opt_model`` (rates, frequencies, alpha, branches), the
   alignment simulated along that tree (``flagship.simulated_data``,
   the cell of phase 7); LG+G4+I
   from the AA registry at the protein cell (``opt_alpha_pinv``, then
   ``opt_brlen``); free rates (+R4) at the flagship cell
   (``opt_rates_weights``); the 189-dimension PROTGTR canary of
   ``tools/tpu_parity.py`` (10 × 256, ``opt_subst_rates`` at tol 1e-3,
   then a float64 restart from its endpoint that may gain ≤ 0.05). Each
   run ends at or above its start and within 1e-6 of the float64 serial
   engine at its parameters; before them the edge-decomposition (value,
   grad) of the rates, freqs, alpha+pinv and cats families (kernel 2's
   directed CLVs) is held against the float64 decomposition on the card
   (relative f < 1e-6, g < 1e-3), and the EM E-step's kernel-2 CLVs
   against the serial engine;
7. SPR rounds and ancestral states (``algorithm/spr.py``,
   ``algorithm/ancestral.py``) on the flagship alignment simulated along
   its own tree (``flagship.simulated``: its rates, frequencies, α 0.75),
   started from that tree after 10 seeded random SPR moves: the first
   batch of each scorer (kernel 2 over K remainder trees, the float32
   contractions) against the same scorer on float64 copies on the card
   (logL within 1e-6 relative on every live edge, thorough lengths
   within 1e-3 relative or 1e-5 absolute; the thorough check repeated
   on a second simulated alignment), kernel 2 over a 16-candidate table
   (16 remainder trees, 6080 slots) against its plain walk bit for bit,
   then one fast round (radius
   1-10, path ``spr_fast``) and one thorough round (radius 1-5,
   ``spr_thorough``), each from the perturbed tree: logL at or above its
   start and within 1e-6 of the float64 serial engine at its final
   tree, the tree binary and connected; then the marginal ancestral
   states of all 126 inner nodes (path ``ancestral``): each site's
   probabilities sum to 1 and agree with float64 on the card within
   1e-5;
8. the full ML search (``algorithm/search.py``, ``tree/starting.py``,
   ``binary/``) on the search cell (``flagship.search_cell``: 246 taxa
   × 4465 sites simulated along a random tree, GTR+Γ4 from α 0.5,
   float32, compressed): a native parsimony start, ``ml_search`` at
   radius 1/5/15, 18 rounds at most, fast then thorough, checkpointed
   after every round (path ``ml_search``); no round below the best
   before it less 1e-3, the end above the start and within 1e-6 of the
   float64 serial engine, the final tree binary and connected; the
   simulating tree through the same ``opt_model`` as a yardstick; the
   checkpoint after round 2 loaded onto the card (the file's arrays bit
   for bit) and resumed into a fresh TreeInfo (``ml_search_resume``: its
   first two rounds the full run's, its third at the full run's mode
   and radius and at or above its logL less 0.1); and the CLI's
   ``search`` on a 32-taxon slice at its default device
   (``cli_search``);
9. the site mesh (``pllmod_tpu_torch/parallel``, ``multichip.py``), path
   ``mesh``: 4 shards on cuda:0, and on a machine with several cards one
   shard a card as well (a line names the meshes, the card count and
   the card); at the flagship's full width ``compute_loglh`` full and
   incremental, the fused and resident sharded evaluations, the
   treeinfo BLO, ``opt_model`` GTR+G4 on phase 6's alignment and one
   fast SPR round (radius 1-5) on phase 7's cell, each within 1e-6 of
   the float64 serial engine, the BLO and the round at or above their
   start, kernels 1, 2, 8 and 9 launched on every shard and kernel 10
   never; the partition DP of the flagship alignment as four 4096-site
   partitions on the 1-D and the 2 × 2 mesh; ``ml_search`` (two rounds,
   checkpointed) and its resume on phase 8's 32-taxon slice;
   ``multichip.dryrun_multichip`` (path ``mesh_dryrun``); and one shard
   against the mesh for the evaluation, the BLO call and the SPR round
   (``--profile``: their busy shares). It prints one ``{"mesh": ...}``;
10. the capacity mode (``run_capacity``): the capacity cell
   (``flagship.capacity_cell``: 10,000 taxa × 100,000 sites simulated
   along a random tree under GTR+Γ4, float32, nothing cut; the
   simulation runs on the host in a process of its own, started with
   the script, beside phases 1-9, as does its ``create_partition``
   with ``device="cpu"``: host seconds by encode, compress and tables;
   its arrays are then copied onto the card), the ``auto``
   evaluation (its route and slots, CAPACITY_EVALS evaluations at
   varied lengths by CUDA events beside the host issue time, updates a
   second, path ``auto``), ``loglikelihood_bounded_fused`` (path
   ``bounded_fused``), both within 1e-6 of the float64 bounded
   evaluation on the card, ``blo.optimize_branch_lengths`` routed to
   the bounded sweep for one whole-tree sweep (``max_sweeps=1``, path
   ``blo_bounded``: ms, slots, peak GiB, launches; at or above its start
   and within 1e-6 of float64 at its lengths), and kernels 1, 2, 8 and
   10 at the cell's shapes against their plain versions with their
   bounds; the chunked BLO (``optimize_branch_lengths_chunked``, path
   ``blo_chunked``) at the flagship width on phase 7's simulated
   alignment beside the full and bounded drivers (within the JAX test's
   0.05 of the full driver in float64) and one window's stacked
   kernel-2 table bit for bit; the eight ``pllmod_tpu_torch/examples``
   drivers, each ``main(["--device", "cuda"])`` (status and seconds;
   output in ``build/capacity/examples``). ``--profile``: one capacity
   evaluation and the sweep under ``profile.trace``, the top device
   kernels of its Chrome trace. It prints one ``{"capacity": ...}``.

It also times both walk kernels, forced, over a sweep of state and
category counts (the measurements behind ``engine.fast_eval_schedule``'s
rule), and kernel 8's simple kernel and tiled configurations at the
BLO's launch shapes over a sweep of cells (the measurements behind
``_build.sumtable_config``'s rule), kernels 6 and 7 at every pattern
tile and row-lane count that fills half the card, and kernels 4 and 5 at
every pattern tile where they fit, each level timed and each tile's
whole schedule run five times, at the flagship and protein cells, each
bit for bit (the measurements behind ``_build.group_walk_tile``'s and
``_build.level_tile``'s rules). It prints the flagship metric with
every timed schedule's ms/eval (``pallas``, and ``combined``: kernel 5
a level), one ``{"blo": [...]}``, one
``{"routing": [...], "supermatrix": {...}}`` (``supermatrix``: both
walks forced in turns at the 1KITE supermatrix's shape), one ``{"sumtable_routing": [...]}`` and one
``{"edge_decomposition": ...}``, one ``{"opt_model": [...]}`` (each run's
logL against float64, host ms by family, (value, grad) calls, Brent
iterations, launches by kernel; ``--profile``: its device busy share),
one ``{"spr": [...]}`` (each round's host ms, candidates, batches and
largest K, applied moves, top-list size, host-build seconds, logL at
start and end and against float64, RF to the simulating tree at start
and end, launches by kernel, peak device GiB less the start;
``--profile``: its busy share and largest device items), one
``{"ancestral": ...}``, one ``{"search": ...}`` (each round's mode,
radius, applied moves, logL, host ms, candidates and batches, and the
checkpoint's bytes and the ms of one ``save_treeinfo`` of the same
state; host ms by stage; RF to the simulating tree; launches; peak
device GiB less the start; the yardstick, the resume and the CLI's run;
``--profile``: the busy share and largest device items of the opening
``opt_model`` and two rounds)
and one ``{"kernels": [...]}`` line (each kernel's launches in all, by
cell and by path), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without CUDA it exits 1 and prints no result.

``--profile`` also traces the main path's timed loop of each cell, the
flagship's and the protein cell's ``pallas``, ``combined``, grouped and
packed loops, one BLO call each at the
flagship and protein cells and on the partitioned cell (LINKED),
each phase-6 run, each SPR round and the search's opening rounds with
``torch.profiler`` and prints where the device time of one evaluation
or call goes (device kernels only) and the device's busy share of the
window; and it builds ``csrc/pruning.cu``, ``csrc/deriv.cu``,
``csrc/packed.cu``, ``csrc/grouped.cu`` and ``csrc/levels.cu`` once
more with their phase marks (``-DPLLMOD_PHASES``, ``csrc/common.cuh``)
and prints the mean cycles of each phase of a row of kernel 1, of a
step of kernels 6 and 7 and of a row's tile of kernels 4 and 5
(flagship, protein), of a work item of kernel 8 and of a Newton
iteration of kernel 10 (their all-edge shapes), and of a row of kernel 1
at the 246 x 4465 and capacity shapes (``kernel1_shapes``; its thread
kind: the consumers' wait on the ring entry, children and maxima,
rescale, stores, and the producer warp's wait and copy issue), with the
marked build's ms a launch beside the library's. Kernel 1's launches
are logged by kind too (``profile.RESIDENT_LAUNCHES``: tile, global,
thread, split). ``--parent DIR`` builds the kernels of another checkout at DIR (an earlier commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists) beside this tree's
and times its kernels 1-8 and 10 (each entry point from the
library that defines it there, with its own signature) beside this
tree's on the same inputs, outputs held equal (kernel 10 within
DERIV_RTOL), in turns (parent, this tree, this tree, parent), by device
time; kernel 1 at the flagship, 246 x 4465 and capacity (10,000 x
100,000) shapes, each at its own checkout's tile
(``kernel1_against_parent``), kernels 3-7 at the flagship and protein
cells, kernels 8 and 10 at every shape the BLO launches: all edges and each edge-color class
of the flagship and protein cells, and kernel 10 on the two-partition
sweep. It then times the ``pallas`` and ``combined`` evaluations of both
checkouts at the flagship and protein cells in turns, each turn a
process of its own (``eval_turns``: ms/eval, host issue ms/eval and the
host µs of one kernel-4 and kernel-5 wrapper call, logLs held equal).
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from pllmod_tpu_torch import binary, cli, convert, flagship
from pllmod_tpu_torch.algorithm import ancestral, opt_model, search, spr
from pllmod_tpu_torch.common import (MAX_BRANCH_LEN, MIN_BRANCH_LEN,
                                     TOL_BRANCH_LEN)
from pllmod_tpu_torch.common import BRLEN_LINKED, BRLEN_SCALED
from pllmod_tpu_torch.common import (PARAM_ALPHA, PARAM_BRANCHES_ITERATIVE,
                                     PARAM_FREE_RATES, PARAM_FREQUENCIES,
                                     PARAM_RATE_WEIGHTS, PARAM_SUBST_RATES)
from pllmod_tpu_torch.msa import io as msa_io
from pllmod_tpu_torch.msa.msa import MSA
from pllmod_tpu_torch.ops import (_build, charmap, clv, deriv, engine, fused,
                                  grouped, levels, packed, resident)
from pllmod_tpu_torch.ops.partition import create_partition
from pllmod_tpu_torch.optimize import blo, blo_bounded, edge_grad
from pllmod_tpu_torch.optimize.em import em_rates_weights
from pllmod_tpu_torch.parallel import is_sharded
# kernel 1's count by kind is read at call time: eval_turn runs this file
# on another checkout's package, which may not have it
from pllmod_tpu_torch import profile as port_profile
from pllmod_tpu_torch.profile import LAUNCHES
from pllmod_tpu_torch.tree import splits
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.tree.treeinfo import TreeInfo

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
LOGL_RTOL = 1e-6          # float32 kernels vs the float64 serial engine
PROD_RTOL = 1e-6          # kernel vs plain version, relative to max |plain|
# derivative kernels vs plain versions (pattern sums in another order):
# logL relative to max(|l|, 1e-3), derivatives relative to max(|d|, 1),
# Newton lengths relative to max(|t|, 1e-4), lnl0 to max(|l|, 1e-2)
DERIV_RTOL = dict(lnl=2e-6, d=2e-5, t=5e-4, lnl0=2e-6)
BOUNDED_ABS, BOUNDED_REL = 0.05, 1e-7   # bounded vs full BLO: |Δl| bar
SITE_OPS = 20             # flops of the site math of one pattern (K9/K10)
FLAGSHIP = dict(n_taxa=128, n_sites=16384, seed=3)        # bench.py's shape
# the flagship alignment simulated along its own tree (phases 6 and 7)
SIM_SEED = 11
PROTEIN = dict(n_taxa=512, n_sites=4096, seed=5, states=20)
# the partitioned cell's second partition, on the flagship tree
PARTITION2 = dict(n_sites=4096, seed=5, states=20)
SCALED_SCALERS = (1.0, 0.5)
TIMED_LOGLH = 20          # compute_loglh calls timed on the partitioned cell
# the widest alphabet of the registries (MULTI64) +G4: no ring of the
# resident kernel's tables fits beside its live slots at any tile, so
# auto routes it to the fused kernel
WIDE = dict(n_taxa=128, n_sites=4096, seed=7, states=64)
# (label, cell, the kernel auto must pick)
CELLS = [("flagship DNA", FLAGSHIP, "resident"),
         ("protein", PROTEIN, "resident"),
         ("64-state", WIDE, "fused")]
TIMED_EVALS = 100
SPIN_HZ = 1.98e9          # H100 SXM boost clock: cycles a second of a spin
# the routing sweep: (states, categories) at two sizes, (taxa, patterns)
SWEEP_SHAPES = [(4, 1), (4, 4), (5, 4), (10, 4), (16, 4), (20, 4), (32, 4),
                (64, 4)]
SWEEP_SIZES = [(128, 16384), (64, 4096)]
# the routing sweep at the slot counts that change the resident walk's
# tile: (taxa, patterns, states, categories, over the slot ladder or at
# the tree's own slots only); a 512-taxon tree needs at most 12 slots
# (resident.resident_slot_bound), a random 2048-taxon tree 7; and a
# 16-taxon 64-state tree, whose few slots fit the resident walk's global
# kind only; and the 1KITE amino-acid supermatrix's shape (phylobench's
# aa144: 144 taxa x 413,459 sites, 20 states +G4), tens of waves of kernel 1
SLOT_SWEEP = [(512, 4096, 16, 4, True), (512, 4096, 20, 4, True),
              (512, 4096, 32, 4, True), (512, 4096, 64, 1, True),
              (2048, 4096, 20, 4, False), (2048, 4096, 32, 4, False),
              (16, 4096, 64, 4, False), (144, 413_459, 20, 4, False)]
# the supermatrix's shape on the aa144 configuration's tree recipe (a
# random binary tree, lengths U(0.02, 0.4)): both walks forced, in turns
SUPERMATRIX = dict(n_taxa=144, n_sites=413_459, seed=19, states=20)
SUPERMATRIX_TURNS = 2


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls where the host
    issues ``fn``'s launches more slowly than the device runs them (a
    loop of short per-level kernels): the stream first runs a spin kernel
    three times as long as the host takes to issue the calls, so that
    every launch is queued before the device reaches the start event and
    no host gap is timed."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * iters * host_s * SPIN_HZ) + 1)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def least_device_ms(fn, iters: int) -> float:
    """The smaller of two :func:`device_ms` measurements: a host stall
    longer than the spin before one (a page fault, a collection) times
    an idle device, which one measurement of a sweep of hundreds met."""
    return min(device_ms(fn, iters), device_ms(fn, iters))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_flops(idx8, C: int, S: int, Ppad: int, n_codes: int,
               root_row: bool = True) -> int:
    """Operations a walk over this run's table needs: per pattern, C·S·S
    multiply-adds (2 flops each) for every child that is not a tip, C·S
    multiplies for the root row's diag(freqs) child (``root_row``: the
    table's last row is the root pseudo-node), and the product, max and
    scale (C·S each) of every row. A tip child's P·x is a lookup of
    P·codetab, which costs its n_codes columns once per row, not per
    pattern."""
    rows = idx8.cpu().numpy()
    tip = rows[:, 2:4] != 0
    mat = 2 * C * S * S
    first = C * S if root_row else mat      # the last row's first child
    body = tip[:-1] if root_row else tip
    per_pattern = mat * int((~body).sum()) + 3 * C * S * len(rows)
    tables = mat * int(body.sum()) * n_codes
    if root_row:
        per_pattern += first * int(~tip[-1, 0]) + mat * int(~tip[-1, 1])
        tables += (first * int(tip[-1, 0]) + mat * int(tip[-1, 1])) * n_codes
    return Ppad * per_pattern + tables


def written_bytes(idx8, C: int, S: int, Ppad: int) -> int:
    """Bytes of the CLV and scaler rows a walk's table writes."""
    return len(torch.unique(idx8[:, 6])) * (C * S + 1) * Ppad * 4


def bound(in_out_bytes: int, flops: int):
    t_bytes = in_out_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rel_close(got: float, want: float, rtol: float, what: str) -> None:
    rel = abs(got - want) / abs(want)
    print(f"{what}: {got!r} vs {want!r} (relative {rel:.3e})")
    if not rel <= rtol:
        raise AssertionError(f"{what}: relative error {rel} > {rtol}")


def compare(name, got, want):
    """(max_abs_err, max_rel_err) of a kernel's float32 output against
    its plain version, relative to the largest plain value."""
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    print(f"{name}: max abs err {err!r}, relative {rel:.3e}")
    if not rel <= PROD_RTOL:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by {rel} > {PROD_RTOL}")
    return err, rel


# ---------------------------------------------------------------------------
# launch counts: every kernel's, by cell and path
# ---------------------------------------------------------------------------
LAUNCH_LOG: dict = {}     # kernel -> cell -> path -> launches
KIND_LOG: dict = {}       # kernel 1's kind -> cell -> path -> launches


# this script's name of each key of the launch registry
# (profile.LAUNCHES, counted by _build.launch)
COUNT_NAMES = {
    "pllmod_resident_walk": "resident_walk",
    "pllmod_fused_walk": "fused_walk",
    "pllmod_edge_sumtables": "edge_sumtables",
    "pllmod_edge_derivs": "edge_derivatives",
    "pllmod_newton_edges": "newton_edges",
    "pllmod_newton_edges_multi": "newton_edges_multi",
    "pllmod_child_pass": "child_pass",
    "pllmod_child2_pass": "child2_pass",
    "pllmod_level_combined": "level_combined",
    "pllmod_grouped_walk": "grouped_walk",
    "pllmod_packed_walk": "packed_walk",
    "pllmod_fused_tables": "tables_pass",
}


def read_counts() -> dict:
    """Every kernel's launch count from the registry, under this
    script's names (each walk's pre-pass runs inside the walk's own
    launch; ``tables_pass`` is the fused pre-pass launched alone)."""
    return {short: LAUNCHES[key] for key, short in COUNT_NAMES.items()}


def zero_counts() -> None:
    LAUNCHES.clear()
    port_profile.RESIDENT_LAUNCHES.clear()


def counted(cell: str, path: str, fn, must=()):
    """``fn()`` with every launch count set to 0 just before and read
    just after, the launches logged under (cell, path); raises if a
    kernel of ``must`` was launched no time. Returns (fn's result, the
    counts)."""
    zero_counts()
    out = fn()
    got = read_counts()
    for k, n in got.items():
        if n:
            paths = LAUNCH_LOG.setdefault(k, {}).setdefault(cell, {})
            paths[path] = paths.get(path, 0) + n
    for kind, n in port_profile.RESIDENT_LAUNCHES.items():
        paths = KIND_LOG.setdefault(kind, {}).setdefault(cell, {})
        paths[path] = paths.get(path, 0) + n
    missed = [k for k in must if got[k] == 0]
    if missed:
        raise AssertionError(f"{path} ({cell}) did not launch {missed}")
    return out, got


def with_launches(row: dict) -> dict:
    """A kernel row with its launches from LAUNCH_LOG: in all, by cell and
    by path."""
    log = LAUNCH_LOG.get(row["name"], {})
    by_path: dict = {}
    for paths in log.values():
        for path, n in paths.items():
            by_path[path] = by_path.get(path, 0) + n
    row["launches_by_cell"] = {cell: sum(p.values())
                               for cell, p in log.items()}
    row["launches_by_path"] = by_path
    row["launches_by_cell_and_path"] = log
    row["launches"] = sum(by_path.values())
    return row


def check_resident(part, tree, part64):
    """Phase 3: the resident kernel against its plain version."""
    idx8, e1, e2, ns = resident.compile_resident(part, tree)
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=part.device)
    P5 = fused.pair_pmats(part, brl, e1, e2, root_row=True)
    tab = fused.code_table(part)
    args = (idx8, P5, part.tip_states, tab, ns)
    t0 = time.perf_counter()
    prod_p, sc_p = resident.resident_walk_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    prod_k, sc_k = resident.resident_walk(*args)
    torch.cuda.synchronize()
    err, rel = compare("resident prod", prod_k, prod_p)
    if not (torch.equal(prod_k, prod_p) and torch.equal(sc_k, sc_p)):
        raise AssertionError("resident root product or scaler row differs "
                             "from the plain version")
    ms = time_ms(lambda: resident.resident_walk(*args), 20)
    l_k = float(resident.loglikelihood_resident(part, idx8, brl, (e1, e2),
                                                ns))
    l64 = float(engine.tree_loglikelihood(part64, tree, schedule="scan"))
    rel_close(l_k, l64, LOGL_RTOL, "resident logL vs float64 scan")
    b_ms, b_by = bound(nbytes(idx8, P5, part.tip_states, tab, prod_k, sc_k),
                       walk_flops(idx8, part.n_cats, part.states,
                                  part.n_patterns_padded, tab.shape[0]))
    C, S, n_codes = part.n_cats, part.states, tab.shape[0]
    T = _build.resident_tile(C, S, n_codes, ns, part.n_patterns_padded)
    cf = _build.resident_config(C, S, n_codes, ns, T)
    print(f"resident: {ms:.4f} ms/launch, plain {plain_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {ns} slots, tile {T} {cf}, bit "
          f"for bit")
    return dict(name="resident_walk", route="cuda",
                source="pllmod_tpu_torch/csrc/pruning.cu",
                replaces="pllmod_tpu/ops/pallas_resident.py:325",
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, tile=T,
                slots=ns, **{k: cf[k] for k in ("RP", "threads", "smem")})


def check_fused(part, tree, part64, label, directed=False):
    """Phase 4: the fused kernel (its pre-pass and walk) against its plain
    version (every slot and scaler row the table writes) and, on a
    fuse_root table, its logL against the float64 serial engine;
    ``directed``: the BLO's directed table written into the plain walk's
    buffers (``out=``). Returns its kernel row for this shape."""
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=part.device)
    tab = fused.code_table(part)
    if directed:
        tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
        idx8, ns = tabs.idx8, tabs.n_slots
        P5 = fused.pair_pmats(part, brl, tabs.e1, tabs.e2, root_row=False)
    else:
        idx8, e1, e2, ri, ns = fused.compile_fused(part, tree,
                                                   fuse_root=True)
        P5 = fused.pair_pmats(part, brl, e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, tab, ns)
    t0 = time.perf_counter()
    clv_p, sc_p = fused.fused_walk_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out = (torch.full_like(clv_p, float("nan")), torch.zeros_like(sc_p))
    clv_k, sc_k = fused.fused_walk(*args, out=out)
    torch.cuda.synchronize()
    w = torch.unique(idx8[:, 6].long())
    err, rel = compare(f"fused CLVs ({label})", clv_k[w], clv_p[w])
    if not (torch.equal(clv_k[w], clv_p[w]) and torch.equal(sc_k[w],
                                                           sc_p[w])):
        raise AssertionError(f"fused CLVs or scaler rows ({label}) differ "
                             "from the plain version")
    # device time (the host can issue a short walk slower than it runs),
    # and CUDA events around the issued calls (the earlier measure)
    ms = device_ms(lambda: fused.fused_walk(*args, out=out), 10)
    events_ms = time_ms(lambda: fused.fused_walk(*args, out=out), 10)
    if not directed:
        l_k = float(fused.loglikelihood_fused(part, idx8, brl, e1, e2, ri,
                                              ns))
        l64 = float(engine.tree_loglikelihood(part64, tree,
                                              schedule="scan"))
        rel_close(l_k, l64, LOGL_RTOL,
                  f"fused logL ({label}) vs float64 scan")
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    b_ms, b_by = bound(nbytes(idx8, P5, part.tip_states, tab)
                       + written_bytes(idx8, C, S, Ppad),
                       walk_flops(idx8, C, S, Ppad, tab.shape[0],
                                  root_row=not directed))
    T = _build.fused_tile(C, S, tab.shape[0], Ppad)
    cf = _build.fused_config(C, S, tab.shape[0], T)
    fwd = int(fused.forwarded_children(idx8, ns, cf["depth"],
                                       cf["lookback"]).sum())
    print(f"fused ({label}): {ms:.4f} ms/launch ({events_ms:.4f} by events "
          f"around the calls), plain {plain_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {ns} slots, {len(idx8)} rows, "
          f"tile {T} {cf}, {fwd} forwarded children, bit for bit")
    return dict(name="fused_walk", route="cuda",
                source="pllmod_tpu_torch/csrc/fused.cu",
                replaces="pllmod_tpu/ops/pallas_clv.py:582",
                max_abs_err=err, max_rel_err=rel, ms=ms, events_ms=events_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, tile=T,
                rows=len(idx8), forwarded=fwd, **{k: cf[k] for k in (
                    "kind", "RI", "RP", "NB", "threads", "smem")})


def _rel(got, want, floor):
    return float(((got - want).abs() / want.abs().clamp(min=floor)).max())


def check_deriv(part, tree, label):
    """Kernels 8, 9 and 10 against their plain versions on the directed
    table of ``part`` / ``tree`` at its lengths, every edge (the shape of
    the BLO's polish sweeps). Returns their kernel-line rows."""
    trav = blo.DirectedTraversal(tree)
    tabs = blo._compile_tables(part, trav)
    brl = torch.as_tensor(np.clip(tree.lengths, MIN_BRANCH_LEN,
                                  MAX_BRANCH_LEN), dtype=torch.float32,
                          device=part.device)
    clvs, scalers = blo._directed_clvs(part, tabs, brl)
    live = torch.as_tensor(np.nonzero(trav.edge_mask)[0], device=part.device)
    eref = tabs.eref6[live]
    E, C, S = len(live), part.n_cats, part.states
    CS, Ppad = C * S, part.n_patterns_padded
    rows = []

    # kernel 8: bit for bit
    args = (part, clvs, scalers, eref, tabs.basis)
    st_p, sc_p = deriv.edge_sumtables_plain(*args)
    plain_ms = time_ms(lambda: deriv.edge_sumtables_plain(*args), 1, 0)
    st, sc = deriv.edge_sumtables(*args)
    torch.cuda.synchronize()
    if not (torch.equal(st, st_p) and torch.equal(sc, sc_p)):
        raise AssertionError(f"edge_sumtables ({label}) differs from its "
                             "plain version")
    err = float((st - st_p).abs().max())
    ms = device_ms(lambda: deriv.edge_sumtables(*args), 10)
    b_ms, b_by = sumtable_bound(part, eref, tabs.basis)
    cf = sumtable_design(part, E)
    composite = sumtable_composite_ms(part, clvs, eref, tabs.basis)
    print(f"edge_sumtables ({label}): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), {E} edges, "
          f"bit for bit; design {cf}; two matmuls and a mul "
          f"{composite:.4f} ms")
    rows.append(dict(name="edge_sumtables", route="cuda",
                     source="pllmod_tpu_torch/csrc/deriv.cu",
                     replaces="pllmod_tpu/ops/pallas_deriv.py:109",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     design=cf, composite_matmul_ms=composite))
    SUMTABLE_SHAPES.append((f"{label}, all {E} edges", args))

    # kernel 9
    t = brl[live]
    kw = dict(lw=tabs.lw, lnB=tabs.lnB)
    want = deriv.edge_derivatives_plain(part, st, sc, t, **kw)
    plain_ms = time_ms(
        lambda: deriv.edge_derivatives_plain(part, st, sc, t, **kw), 1, 0)
    got = deriv.edge_derivatives_k(part, st, sc, t, **kw)
    errs = [_rel(got[0], want[0], 1e-3), _rel(got[1], want[1], 1.0),
            _rel(got[2], want[2], 1.0)]
    print(f"edge_derivatives ({label}): relative errors {errs}")
    if errs[0] > DERIV_RTOL["lnl"] or max(errs[1:]) > DERIV_RTOL["d"]:
        raise AssertionError(f"edge_derivatives ({label}) differs from its "
                             f"plain version: {errs}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ms = time_ms(lambda: deriv.edge_derivatives_k(part, st, sc, t, **kw), 10)
    in_bytes = nbytes(st, sc, t, tabs.lw, tabs.lnB) + Ppad * 4
    site_flops = Ppad * (6 * CS + SITE_OPS)
    b_ms, b_by = bound(in_bytes + 3 * E * 4, E * site_flops)
    print(f"edge_derivatives ({label}): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows.append(dict(name="edge_derivatives", route="cuda",
                     source="pllmod_tpu_torch/csrc/deriv.cu",
                     replaces="pllmod_tpu/ops/pallas_deriv.py:288",
                     max_abs_err=err, max_rel_err=errs, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))

    # kernel 10
    nargs = (part, st, sc, t, MIN_BRANCH_LEN, MAX_BRANCH_LEN,
             TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS)
    want = deriv.newton_edges_plain(*nargs, **kw)
    plain_ms = time_ms(lambda: deriv.newton_edges_plain(*nargs, **kw), 1, 0)
    got = deriv.newton_edges(*nargs, **kw)
    errs = [_rel(got[0], want[0], 1e-4), _rel(got[1], want[1], 1e-2)]
    print(f"newton_edges ({label}): relative errors t {errs[0]}, lnl0 "
          f"{errs[1]}")
    if errs[0] > DERIV_RTOL["t"] or errs[1] > DERIV_RTOL["lnl0"]:
        raise AssertionError(f"newton_edges ({label}) differs from its "
                             f"plain version: {errs}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    ms = time_ms(lambda: deriv.newton_edges(*nargs, **kw), 10)
    iters = int(got[2].sum())
    b_ms, b_by = bound(in_bytes + 3 * E * 4, iters * site_flops)
    print(f"newton_edges ({label}): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), mean "
          f"{iters / E:.2f} iterations an edge")
    design = newton_design([part])
    NEWTON_SHAPES.append((f"{label}, all {E} edges", [part], [st], [sc], t,
                          (1.0,), [tabs.lw], [tabs.lnB]))
    # the colored BLO's launch shapes: kernels 8 and 10 on each color
    # class of edges (blo._edge_colors)
    classes = []
    for k, mask in enumerate(blo._edge_colors(tree)):
        sel = torch.as_tensor(np.nonzero(mask)[0], device=part.device)
        cargs = (part, clvs, scalers, tabs.eref6[sel], tabs.basis)
        st_c, sc_c = deriv.edge_sumtables(*cargs)
        cn = (part, st_c, sc_c, brl[sel], MIN_BRANCH_LEN, MAX_BRANCH_LEN,
              TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS)
        c_iters = int(deriv.newton_edges(*cn, **kw)[2].sum())
        row = dict(color=k, edges=len(sel),
                   edge_sumtables_ms=device_ms(
                       lambda: deriv.edge_sumtables(*cargs), 10),
                   edge_sumtables_bound_ms=sumtable_bound(
                       part, cargs[3], tabs.basis)[0],
                   newton_edges_ms=device_ms(
                       lambda: deriv.newton_edges(*cn, **kw), 10),
                   mean_iters=c_iters / len(sel))
        print(f"class shape ({label}): {row}")
        classes.append(row)
        SUMTABLE_SHAPES.append((f"{label}, color {k} ({len(sel)} edges)",
                                cargs))
        NEWTON_SHAPES.append((f"{label}, color {k} ({len(sel)} edges)",
                              [part], [st_c], [sc_c], brl[sel], (1.0,),
                              [tabs.lw], [tabs.lnB]))
    print(f"newton_edges ({label}): design {design}")
    rows.append(dict(name="newton_edges", route="cuda",
                     source="pllmod_tpu_torch/csrc/deriv.cu",
                     replaces="pllmod_tpu/ops/pallas_deriv.py:400",
                     max_abs_err=err, max_rel_err=errs, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, mean_iters=iters / E, design=design,
                     class_shapes=classes))
    return rows


# kernel 10's launch shapes, for --parent: (label, parts, sts, scs, t0,
# scalers, lws, lnBs)
NEWTON_SHAPES: list = []
# kernel 8's, for --parent: (label, edge_sumtables' arguments)
SUMTABLE_SHAPES: list = []


def sumtable_bound(part, eref, basis):
    """Kernel 8's bound at these edge rows: each inner side's CLV and
    scaler rows and each tip side's codes read once, st and sc written
    once, against 2 C·S·S flops a pattern for every inner side and the
    C·S products."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    ref = eref.cpu().numpy()
    n_inner = int((ref[:, 2:4] == 0).sum())
    E = len(ref)
    in_bytes = (n_inner * (C * S + 1) * Ppad * 4          # CLV + scaler rows
                + int((ref[:, 2:4] != 0).sum()) * Ppad * 4   # tip codes
                + nbytes(eref, basis))
    out_bytes = E * (C * S + 1) * Ppad * 4
    return bound(in_bytes + out_bytes,
                 Ppad * (n_inner * 2 * C * S * S + E * C * S))


def sumtable_design(part, E: int) -> dict:
    """Kernel 8's configuration for E edges at this partition's shape
    (``_build.sumtable_config``), with the CTAs an SM the card reports for
    it (the library's ``pllmod_sumtable_occupancy``)."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    n_codes = part.code_clv.shape[0]
    cf = _build.sumtable_config(C, S, n_codes, Ppad, E)
    if cf is None:
        return dict(kind="simple")
    return dict(cf, ctas_per_sm=_build.load().pllmod_sumtable_occupancy(
        C, S, n_codes, Ppad, E, 0))


def sumtable_composite_ms(part, clvs, eref, basis) -> float:
    """For information only, never called by the port: device ms of two
    ``torch.matmul`` calls and a ``mul`` that compute the sumtables of
    these edges from both sides' [E, C, S, Ppad] values, gathered
    beforehand (tip sides expanded from their codes), untimed."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    ref = eref.long()
    tab = part.code_clv.to(torch.float32)

    def side(k):
        x = clvs[ref[:, k]].view(-1, C, S, Ppad)
        codes = part.tip_states[ref[:, 4 + k]].long()
        tip = tab[codes].permute(0, 2, 1)[:, None].expand(-1, C, -1, -1)
        return torch.where(ref[:, 2 + k].bool()[:, None, None, None], tip,
                           x).contiguous()
    x1, x2 = side(0), side(1)
    ms = device_ms(lambda: torch.matmul(basis[0], x1) * torch.matmul(
        basis[1], x2), 10)
    del x1, x2
    return ms


def newton_design(parts) -> dict:
    """Kernel 10's design for these partitions (``deriv.newton_config``)."""
    return deriv.newton_config([p.n_cats * p.states for p in parts],
                               [p.n_patterns_padded for p in parts])


# ---------------------------------------------------------------------------
# the level and grouped schedules: kernels 3, 4, 5 (csrc/levels.cu) and 7
# (csrc/grouped.cu)
# ---------------------------------------------------------------------------
def _child_cost(part, rows, side: int, n_codes: int):
    """(bytes read, flops) of the side-``side`` children of level rows
    ``rows`` (numpy [W, 6]): an inner child's CLV and scaler rows and
    2·C·S·S flops a pattern; a tip child's code row and, as in
    ``walk_flops``, a lookup of P·codetab (n_codes columns a row)."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    tip = rows[:, 2 + side] != 0
    n_in, n_tip = int((~tip).sum()), int(tip.sum())
    return ((n_in * (C * S + 1) + n_tip) * Ppad * 4,
            2 * C * S * S * (n_in * Ppad + n_tip * n_codes))


def level_bounds(part, idx, slices, n_codes: int):
    """Per kernel, its mean bound over the levels' launches (ms), what
    sets the larger share of it, and its mean exact-arithmetic ceiling
    (ms: the operations at half the float32 rate, a multiply and an add
    a term, since the exactness contract forbids FMA): inputs read once
    (children, rows, matrices, code table, and kernel 4's left and s1),
    outputs written once; the product, maximum and scale cost C·S flops
    each a pattern."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    rows_all = idx.cpu().numpy()
    per = {"child_pass": [], "child2_pass": [], "level_combined": []}
    for s in slices:
        r = rows_all[s]
        W = len(r)
        fixed = W * 6 * 4 + W * C * S * S * 4 + n_codes * S * 4
        blk = W * (C * S + 1) * Ppad * 4           # CLV + scaler rows
        b0, f0 = _child_cost(part, r, 0, n_codes)
        b1, f1 = _child_cost(part, r, 1, n_codes)
        comb = 3 * C * S * Ppad * W
        per["child_pass"].append((b0 + fixed + blk, f0))
        per["child2_pass"].append((b1 + fixed + 2 * blk, f1 + comb))
        per["level_combined"].append(
            (b0 + b1 + fixed + W * C * S * S * 4 + blk, f0 + f1 + comb))
    out = {}
    for k, v in per.items():
        ms = sum(bound(b, f)[0] for b, f in v) / len(v)
        exact = sum(f for _, f in v) / len(v) / (F32_FLOPS / 2) * 1e3
        out[k] = (ms, bound(sum(b for b, _ in v), sum(f for _, f in v))[1],
                  exact)
    return out


LEVEL_SWEEP_REPEATS = 5   # whole-schedule runs a tile of kernels 4 and 5


def level_tile_sweep(label, kernel, run, want, sl, C: int, S: int,
                     n_codes: int) -> dict:
    """Kernel 4 (``kernel`` "child2") or 5 ("combined") at every pattern
    tile where a configuration fits, each a configuration the rule can
    pick for some level: ``run(T, s, bufs)`` launches level ``s`` at tile
    T into ``bufs``. At each tile the whole schedule runs
    LEVEL_SWEEP_REPEATS times into buffers poisoned first, each held bit
    for bit against the plain walk's ``want``; then each level is timed
    (the least of two device ms a launch). Returns the tiles' rows and, a
    level, the rule's tile and ms beside the fastest (the measurements
    behind ``_build.level_tile``)."""
    Ppad = want[0].shape[2]
    rows = []
    for T in _build.LEVEL_TILES:
        cf = _build.level_config(kernel, C, S, n_codes, T)
        if cf is None:
            continue
        for _ in range(LEVEL_SWEEP_REPEATS):
            bufs = (torch.full_like(want[0], float("nan")),
                    torch.full_like(want[1], -999))
            for s in sl:
                run(T, s, bufs)
            if not (torch.equal(bufs[0], want[0])
                    and torch.equal(bufs[1], want[1])):
                raise AssertionError(f"{kernel} ({label}) at tile {T} "
                                     "differs from its plain version")
        rows.append(dict(tile=T, kind=cf["kind"],
                         ms=[least_device_ms(lambda s=s: run(T, s, bufs), 10)
                             for s in sl]))
    per_level = []
    for i, s in enumerate(sl):
        W = s.stop - s.start
        rule = _build.level_tile(kernel, C, S, n_codes, Ppad, W)
        best = min(rows, key=lambda r: r["ms"][i])
        per_level.append(dict(W=W, rule_tile=rule, rule_ms=next(
            r["ms"][i] for r in rows if r["tile"] == rule),
            best_tile=best["tile"], best_ms=best["ms"][i]))
    rule_sum = sum(r["rule_ms"] for r in per_level)
    best_sum = sum(r["best_ms"] for r in per_level)
    print(f"{kernel} ({label}) tile sweep: the rule's tiles "
          f"{rule_sum / len(sl):.4f} ms a launch, the fastest a level "
          f"{best_sum / len(sl):.4f}, every tile bit for bit in "
          f"{LEVEL_SWEEP_REPEATS} runs; " + json.dumps(per_level))
    return dict(tiles=rows, levels=per_level, rule_ms=rule_sum / len(sl),
                best_ms=best_sum / len(sl))


def check_levels(part, tree, label):
    """Kernels 3, 4 and 5 against their plain versions on every level of
    the cell's LevelSchedule, bit for bit: kernel 3 on both children of
    each level (on the plain walk's buffers), kernels 3+4 and kernel 5 as
    drivers of the whole schedule (every level's block and scaler rows
    against the plain walk), kernels 4 and 5 at every tile where they fit
    (``level_tile_sweep``) and once more when timed in place. Times per
    launch are means over the levels; kernel 5's row also times the split
    step (two kernel-3 launches and the torch combine a level) for
    information. Returns the three kernel rows."""
    lvls, offsets, _, ns = engine.compile_schedule(part, tree)
    tables = levels.level_tables(part, lvls)
    idx, e1, e2 = tables
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=part.device)
    P = part.prob_matrices(brl)
    P1, P2 = P[e1], P[e2]
    tc, tab = part.tip_states, fused.code_table(part)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    sl = [slice(o, o + len(lv)) for lv, o in zip(lvls, offsets)]
    L = len(sl)
    ref = (torch.zeros((ns, C * S, Ppad), device=part.device),
           torch.zeros((ns, 1, Ppad), dtype=torch.int32, device=part.device))
    lefts = []

    def walk_plain():
        lefts.clear()
        for s, off in zip(sl, offsets):
            left, s1 = levels.child_pass_plain(idx[s], 0, *ref, tc, tab, P1[s])
            levels.child2_pass_plain(idx[s], *ref, tc, tab, P2[s], left, s1,
                                     off)
            lefts.append((left, s1))

    walk_plain()
    want = [t.clone() for t in ref]
    err = 0.0

    def equal(got, ref_t, what):
        nonlocal err
        for g, w in zip(got, ref_t):
            if not torch.equal(g, w):
                raise AssertionError(f"{what} ({label}) differs from its "
                                     "plain version")
            if g.is_floating_point():
                err = max(err, float((g - w).abs().max()))

    for step in ("child2", "combined"):
        equal(levels.update_partials_pallas(part, P, lvls, offsets, ns, step,
                                            tables), want,
              f"the {step} driver's buffers")
    for s in sl:
        for side, Pm in ((0, P1[s]), (1, P2[s])):
            equal(levels.child_pass(idx[s], side, *ref, tc, tab, Pm),
                  levels.child_pass_plain(idx[s], side, *ref, tc, tab, Pm),
                  f"child_pass side {side}")
    left_of = {s.start: pair for s, pair in zip(sl, lefts)}
    sweeps = {
        "child2_pass": level_tile_sweep(
            label, "child2", lambda T, s, b: levels.child2_pass(
                idx[s], *b, tc, tab, P2[s], *left_of[s.start], s.start,
                tile=T), want, sl, C, S, tab.shape[0]),
        "level_combined": level_tile_sweep(
            label, "combined", lambda T, s, b: levels.level_update_combined(
                *b, idx[s], tc, tab, P1[s], P2[s], s.start, tile=T),
            want, sl, C, S, tab.shape[0])}

    def k3():
        for s in sl:
            levels.child_pass(idx[s], 0, *ref, tc, tab, P1[s])

    def k4():
        for s, off, (left, s1) in zip(sl, offsets, lefts):
            levels.child2_pass(idx[s], *ref, tc, tab, P2[s], left, s1, off)

    def k5():
        for s, off in zip(sl, offsets):
            levels.level_update_combined(*ref, idx[s], tc, tab, P1[s], P2[s],
                                         off)

    def split():
        for s, off in zip(sl, offsets):
            levels.level_update(*ref, idx[s], tc, tab, P1[s], P2[s], off)

    def p3():
        for s in sl:
            levels.child_pass_plain(idx[s], 0, *ref, tc, tab, P1[s])

    def p5():
        for s, off in zip(sl, offsets):
            levels.level_combined_plain(idx[s], *ref, tc, tab, P1[s], P2[s],
                                        off)

    # bmm of the gathered child block: the one library call that computes
    # kernel 3's P·child (its inputs gathered outside the timed call)
    xs = [levels.gather_children(idx[s], 0, *ref, tc, tab, C)[0]
          .reshape(-1, S, Ppad).contiguous() for s in sl]
    ms_ = [P1[s].reshape(-1, S, S).contiguous() for s in sl]
    bounds = level_bounds(part, idx, sl, tab.shape[0])
    # device time a launch (the per-level launches issue slower than the
    # kernels run; kernels 4 and 5 the least of two); the plain versions
    # are timed as issued
    times = {"child_pass": (device_ms(k3, 10) / L, time_ms(p3, 1) / L,
                            device_ms(lambda: [torch.bmm(m, x) for m, x
                                               in zip(ms_, xs)], 10) / L),
             "child2_pass": (least_device_ms(k4, 10) / L,
                             time_ms(walk_plain, 1) / L, None),
             "level_combined": (least_device_ms(k5, 10) / L,
                                time_ms(p5, 1) / L, None)}
    split_ms = least_device_ms(split, 10) / L
    walk_plain()       # the split step's unclipped rescale wrote ref
    k5()
    equal(ref, want, "kernel 5 timed in place")
    k4()
    equal(ref, want, "kernels 4 and 5 timed in place")
    del xs, ms_
    rows = []
    for name, line in (("child_pass", 113), ("child2_pass", 195),
                       ("level_combined", 282)):
        ms, plain_ms, lib_ms = times[name]
        b_ms, b_by, exact_ms = bounds[name]
        extra = {}
        if name in sweeps:
            extra = dict(tiles=sweeps[name], level_tiles=[
                r["rule_tile"] for r in sweeps[name]["levels"]])
        if name == "level_combined":
            extra["split_ms"] = split_ms
        print(f"{name} ({label}): {ms:.4f} ms/launch (mean of {L} levels), "
              f"plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"exact-arithmetic ceiling {exact_ms:.4f} ms, library "
              f"{lib_ms}" + (f", split step {split_ms:.4f} ms"
                             if name == "level_combined" else "")
              + ", bit for bit")
        rows.append(dict(name=name, route="cuda",
                         source="pllmod_tpu_torch/csrc/levels.cu",
                         replaces=f"pllmod_tpu/ops/pallas_clv.py:{line}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         levels=L, **extra))
    return rows


GROUP_WALK_SWEEP_LANES = (1, 2, 4, 8)


def group_walk_sweep(name, label, run, pick, want, part, n_codes) -> list:
    """Kernel 6 or 7 (``run(tile=, lanes=)``) at every pattern tile and
    row-lane count of the sweep whose configuration fits and whose grid
    has at least a CTA for every two SMs, each held bit for bit against
    the plain version (``pick(out)`` against ``want``) and timed (device
    ms a launch): the measurements behind ``_build.group_walk_tile``'s
    rule. Returns one row a configuration."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    rows = []
    for R in GROUP_WALK_SWEEP_LANES:
        for T in _build.TILES:
            cf = _build.group_walk_config(C, S, n_codes, T, R)
            if cf is None or -(-Ppad // T) < _build.SMS // 2:
                continue
            got = pick(run(tile=T, lanes=R))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} ({label}) at tile {T}, {R} "
                                     "lanes differs from its plain version")
            rows.append(dict(tile=T, lanes=R, kind=cf["kind"],
                             threads=cf["threads"], smem=cf["smem"],
                             ms=device_ms(lambda: run(tile=T, lanes=R), 5)))
    best = min(rows, key=lambda r: r["ms"])
    print(f"{name} ({label}) sweep: fastest tile {best['tile']}, "
          f"{best['lanes']} lanes, {best['ms']:.4f} ms; "
          + json.dumps(rows))
    return rows


def check_grouped(part, tree, label):
    """Kernel 7 against its plain version on every position a member
    writes, bit for bit; time per launch. Returns its kernel row."""
    sched = grouped.GroupedSchedule(part, tree)
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=part.device)
    PQ = grouped.grouped_pmats(part, brl, sched.e_sides)
    tab = fused.code_table(part)
    args = (sched.side_meta, sched.dst_meta, PQ, part.tip_states, tab)
    walk = dict(order=sched.order, windows=sched.windows)
    want_b, want_s = grouped.grouped_walk_plain(*args)
    plain_ms = time_ms(lambda: grouped.grouped_walk_plain(*args), 1)
    bufs, sbufs = grouped.grouped_walk(*args, **walk)
    dst = sched.dst_meta.long()
    dg, dq = dst[..., 0], dst[..., 1]
    if not (torch.equal(bufs[dg, dq], want_b[dg, dq])
            and torch.equal(sbufs[dg, dq], want_s[dg, dq])):
        raise AssertionError(f"grouped_walk ({label}) differs from its plain "
                             "version")
    err = float((bufs[dg, dq] - want_b[dg, dq]).abs().max())
    ms = device_ms(lambda: grouped.grouped_walk(*args, **walk), 10)
    tiles = group_walk_sweep(
        "grouped_walk", label, lambda **kw: grouped.grouped_walk(
            *args, **walk, **kw), lambda out: (out[0][dg, dq],
                                               out[1][dg, dq]),
        (want_b[dg, dq], want_s[dg, dq]), part, tab.shape[0])
    # work of the real members (a dummy writes a trash position of the
    # landing buffer, q >= 2): tip children read their code rows, inner
    # children are the kernel's own outputs
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    d = sched.dst_meta.cpu().numpy()
    side = sched.side_meta.cpu().numpy()
    real = ~((d[..., 0] == sched.nG) & (d[..., 1] >= 2))       # [nG, G]
    tips = np.concatenate([side[:, :sched.G, 0], side[:, sched.G:, 0]],
                          axis=1)[np.concatenate([real, real], axis=1)] != 0
    n_real, n_tip = int(real.sum()), int(tips.sum())
    n_in = 2 * n_real - n_tip
    in_bytes = nbytes(sched.side_meta, sched.dst_meta, PQ, tab) + \
        n_tip * Ppad * 4
    out_bytes = n_real * (C * S + 1) * Ppad * 4
    flops = (2 * C * S * S * (n_in * Ppad + n_tip * tab.shape[0])
             + 3 * C * S * Ppad * n_real)
    b_ms, b_by = bound(in_bytes + out_bytes, flops)
    T, R = _build.group_walk_tile(C, S, tab.shape[0], Ppad)
    print(f"grouped_walk ({label}): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), G {sched.G}, "
          f"{sched.nG} groups, {n_real} members, "
          f"{len(sched.windows) - 1} windows, tile {T}, {R} lanes, bit for "
          "bit")
    return dict(name="grouped_walk", route="cuda",
                source="pllmod_tpu_torch/csrc/grouped.cu",
                replaces="pllmod_tpu/ops/pallas_grouped.py:234",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, G=sched.G, groups=sched.nG,
                windows=len(sched.windows) - 1, tile=T, lanes=R,
                kind=_build.group_walk_config(C, S, tab.shape[0], T,
                                              R)["kind"], tiles=tiles)


# the paths of phase 3 and the kernels each must launch
LEVEL_PATHS = {"pallas": ("child_pass", "child2_pass"),
               "level_update": ("child_pass",),
               "level_update_combined": ("level_combined",),
               "grouped": ("grouped_walk",), "levels": ()}


def run_level_paths(cells):
    """Phase 3: every path of LEVEL_PATHS at each (label, part, tree,
    part64) of ``cells``, its logL against the float64 serial engine,
    each run counted (``counted``: every count set to 0 just before and
    read just after, logged by cell and path)."""
    for label, part, tr, part64 in cells:
        l64 = float(engine.tree_loglikelihood(part64, tr, schedule="scan"))
        lvls, offsets, ri, ns = engine.compile_schedule(part, tr)
        brl = torch.as_tensor(tr.lengths, dtype=torch.float32,
                              device=part.device)
        runs = {
            "pallas": lambda: engine.tree_loglikelihood(part, tr,
                                                        schedule="pallas"),
            "level_update": lambda: levels.loglikelihood_pallas(
                part, lvls, brl, offsets, ri, ns, step="split"),
            "level_update_combined": lambda: levels.loglikelihood_pallas(
                part, lvls, brl, offsets, ri, ns, step="combined"),
            "grouped": lambda: grouped.loglikelihood_grouped(
                part, brl, grouped.GroupedSchedule(part, tr)),
            "levels": lambda: engine.tree_loglikelihood(part, tr,
                                                        schedule="levels")}
        for path, fn in runs.items():
            lnl, _ = counted(label, path, lambda: float(fn()),
                             must=LEVEL_PATHS[path])
            rel_close(lnl, l64, LOGL_RTOL, f"{path} logL ({label}) vs "
                      "float64 scan")


# ---------------------------------------------------------------------------
# the packed walk: kernel 6 (csrc/packed.cu)
# ---------------------------------------------------------------------------
def check_packed(part, tree, part64, label):
    """Kernel 6 against its plain version on every slot and scaler row
    (the dummy rows' included), bit for bit; its time per launch against
    the bound of the real rows' work; the packed logL against the
    float64 serial engine. Returns its kernel row."""
    sched = packed.PackedSchedule(part, tree)
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=part.device)
    P = part.prob_matrices(brl).to(torch.float32).contiguous()
    tab = fused.code_table(part)
    args = (sched.idxm, sched.e1, sched.e2, P, part.tip_states, tab,
            sched.G)
    want_c, want_s = packed.packed_walk_plain(*args)
    plain_ms = time_ms(lambda: packed.packed_walk_plain(*args), 1)
    clvs, scalers = packed.packed_walk(*args, sched.windows)
    torch.cuda.synchronize()
    if not (torch.equal(clvs, want_c) and torch.equal(scalers, want_s)):
        raise AssertionError(f"packed_walk ({label}) differs from its plain "
                             "version")
    err = float((clvs - want_c).abs().max())
    ms = device_ms(lambda: packed.packed_walk(*args, sched.windows), 10)
    tiles = group_walk_sweep(
        "packed_walk", label, lambda **kw: packed.packed_walk(
            *args, sched.windows, **kw), lambda out: out, (want_c, want_s),
        part, tab.shape[0])
    l_k = float(packed.loglikelihood_packed(part, brl, sched))
    l64 = float(engine.tree_loglikelihood(part64, tree, schedule="scan"))
    rel_close(l_k, l64, LOGL_RTOL, f"packed logL ({label}) vs float64 scan")
    # the real rows' work (a dummy row has tip 0 on both sides; no real
    # row does): tip children read their code rows, inner children are
    # the kernel's own outputs
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    m = sched.idxm.cpu().numpy()
    dummy = (m[:, 1] == 1) & (m[:, 3] == 1) & (m[:, 4] == 0) & (m[:, 5] == 0)
    real = m[~dummy]
    n_real = len(real)
    n_tip = int(real[:, 1].sum() + real[:, 3].sum())
    n_in = 2 * n_real - n_tip
    in_bytes = (nbytes(sched.idxm, sched.e1, sched.e2, P, tab)
                + n_tip * Ppad * 4)
    out_bytes = n_real * (C * S + 1) * Ppad * 4
    flops = (2 * C * S * S * (n_in * Ppad + n_tip * tab.shape[0])
             + 3 * C * S * Ppad * n_real)
    b_ms, b_by = bound(in_bytes + out_bytes, flops)
    T, R = _build.group_walk_tile(C, S, tab.shape[0], Ppad)
    print(f"packed_walk ({label}): {ms:.4f} ms/launch, plain {plain_ms:.1f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}), G {sched.G}, {sched.nG} groups, "
          f"{sched.n_slots_pad} padded slots for {sched.n_slots} real ones, "
          f"{len(sched.windows) - 1} windows, tile {T}, {R} lanes, "
          f"contig {sched.contig_frac:.3f}, bit for bit")
    return dict(name="packed_walk", route="cuda",
                source="pllmod_tpu_torch/csrc/packed.cu",
                replaces="pllmod_tpu/ops/pallas_clv.py:1511",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, G=sched.G, groups=sched.nG,
                n_slots_pad=sched.n_slots_pad, n_slots=sched.n_slots,
                windows=len(sched.windows) - 1, tile=T, lanes=R,
                kind=_build.group_walk_config(C, S, tab.shape[0], T,
                                              R)["kind"], tiles=tiles)


def run_packed_path(cells):
    """Phase 4: ``loglikelihood_packed`` at each (label, part, tree,
    part64) of ``cells``, its logL against the float64 serial engine and
    its ms/eval with the host issue time, counted by cell. Returns
    {label: (ms, issue ms)}."""
    ms = {}
    for label, part, tr, part64 in cells:
        def drive():
            lnl = float(packed.loglikelihood_packed(
                part, tr.lengths, packed.PackedSchedule(part, tr)))
            return lnl, timed_main_path(part, tr, label, "packed")
        (lnl, ms[label]), _ = counted(label, "packed", drive,
                                      must=("packed_walk",))
        rel_close(lnl, float(engine.tree_loglikelihood(part64, tr,
                                                       schedule="scan")),
                  LOGL_RTOL, f"packed path logL ({label}) vs float64 scan")
    return ms


# ---------------------------------------------------------------------------
# the partitioned analysis: TreeInfo, kernel 10 over two partitions
# ---------------------------------------------------------------------------
def f64_total(ti, parts64):
    """The float64 serial engine's total logL of a TreeInfo's state."""
    return sum(float(engine.tree_loglikelihood(
        p64, ti.tree, brlens=torch.as_tensor(ti.partition_brlens(i)),
        schedule="scan")) for i, p64 in enumerate(parts64))


def check_newton_multi(parts, tree, scalers, label):
    """Kernel 10 for K = len(parts) partitions (each sumtable at the
    tree's lengths times its scaler) against its plain version. Returns
    its kernel row."""
    trav = blo.DirectedTraversal(tree)
    live = torch.as_tensor(np.nonzero(trav.edge_mask)[0],
                           device=parts[0].device)
    brl = torch.as_tensor(np.clip(tree.lengths, MIN_BRANCH_LEN,
                                  MAX_BRANCH_LEN), dtype=torch.float32,
                          device=parts[0].device)
    sts, scs, lws, lnbs = [], [], [], []
    for part, s in zip(parts, scalers):
        tabs = blo._compile_tables(part, trav)
        clvs, sclr = blo._directed_clvs(part, tabs, brl * s)
        st, sc = deriv.edge_sumtables(part, clvs, sclr, tabs.eref6[live],
                                      tabs.basis)
        sts.append(st)
        scs.append(sc)
        lws.append(deriv._lam_weight_rows(part, scale=s))
        lnbs.append(tabs.lnB)
        del clvs, sclr
    t = brl[live]
    nargs = (parts, sts, scs, t, scalers, MIN_BRANCH_LEN, MAX_BRANCH_LEN,
             TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS, lws, lnbs)
    want = deriv.newton_edges_multi_plain(*nargs)
    plain_ms = time_ms(lambda: deriv.newton_edges_multi_plain(*nargs), 1, 0)
    got = deriv.newton_edges_multi(*nargs)
    errs = [_rel(got[0], want[0], 1e-4), _rel(got[1], want[1], 1e-2)]
    print(f"newton_edges_multi ({label}, K {len(parts)}): relative errors t "
          f"{errs[0]}, lnl0 {errs[1]}")
    if errs[0] > DERIV_RTOL["t"] or errs[1] > DERIV_RTOL["lnl0"]:
        raise AssertionError(f"newton_edges_multi ({label}) differs from its "
                             f"plain version: {errs}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    ms = time_ms(lambda: deriv.newton_edges_multi(*nargs), 10)
    iters = int(got[2].sum())
    E = len(t)
    in_bytes = nbytes(t, *sts, *scs, *lws, *lnbs) + sum(
        p.n_patterns_padded * 4 for p in parts)
    flops = iters * sum(p.n_patterns_padded
                        * (6 * p.n_cats * p.states + SITE_OPS)
                        for p in parts)
    b_ms, b_by = bound(in_bytes + 3 * E * 4, flops)
    design = newton_design(parts)
    NEWTON_SHAPES.append((f"{label}, all {E} edges", list(parts), sts, scs,
                          t, tuple(scalers), lws, lnbs))
    print(f"newton_edges_multi ({label}): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), mean "
          f"{iters / E:.2f} iterations an edge, design {design}")
    return dict(name="newton_edges_multi", route="cuda",
                source="pllmod_tpu_torch/csrc/deriv.cu",
                replaces="pllmod_tpu/ops/pallas_deriv.py:400",
                max_abs_err=err, max_rel_err=errs, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                mean_iters=iters / E, partitions=len(parts), design=design)


def _events_ms(fn, calls: int = 1):
    """(result of the last call, device ms a call by CUDA events, host ms
    a call) of ``fn`` called ``calls`` times."""
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(calls):
        out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return (out, ev0.elapsed_time(ev1) / calls,
            (time.perf_counter() - t0) * 1e3 / calls)


def run_partitioned(parts, parts64, tree):
    """Phase 5 on a two-partition TreeInfo over ``tree``: compute_loglh
    (against the partitions' own tree_loglikelihood and the float64
    engine, timed), the incremental path after one changed length, the
    per-site vectors, and optimize_branch_lengths_treeinfo in LINKED and
    SCALED modes (at or above the start, within LOGL_RTOL of the float64
    engine). The caller counts its launches (``counted``). Returns the
    summary row."""
    out = {}
    ti = TreeInfo(tree.copy(), list(parts))
    lnl, ms, host_ms = _events_ms(ti.compute_loglh, TIMED_LOGLH)
    each = sum(float(engine.tree_loglikelihood(p, tree)) for p in parts)
    if abs(lnl - each) > 1e-9 * abs(each):
        raise AssertionError(f"compute_loglh {lnl!r} is not the partitions' "
                             f"sum {each!r}")
    rel_close(lnl, f64_total(ti, parts64), LOGL_RTOL,
              "TreeInfo compute_loglh vs float64 scan")
    out.update(compute_loglh=lnl, ms_per_compute_loglh=ms,
               host_ms_per_compute_loglh=host_ms)
    # incremental: one changed length runs fewer rows than a full walk
    ti.compute_loglh(incremental=True)
    edge = int(np.nonzero(tree.edge_nodes[:, 0] >= 0)[0][5])
    ti.set_branch_length(edge, float(ti.tree.lengths[edge]) * 1.5)
    before = ti.counters.clv_updates, LAUNCHES["pllmod_fused_walk"]
    inc, inc_ms, _ = _events_ms(lambda: ti.compute_loglh(incremental=True))
    rows = (ti.counters.clv_updates - before[0]) // sum(
        p.n_patterns for p in parts)
    full = ti.compute_loglh()
    rel_close(inc, full, LOGL_RTOL, "incremental compute_loglh vs full")
    n_inner = tree.n_tips - 2
    launched = LAUNCHES["pllmod_fused_walk"] - before[1]
    if not 0 < rows < n_inner or not launched:
        raise AssertionError(f"the incremental path ran {rows} rows of "
                             f"{n_inner} on {launched} fused launches")
    out.update(incremental_rows=rows, inner_rows=n_inner,
               ms_incremental=inc_ms)
    total, persite = ti.compute_loglh_persite()
    by_sites = sum(float((torch.as_tensor(site, device=p.device)
                          * p.pattern_weights).sum())
                   for site, p in zip(persite, parts))
    rel_close(by_sites, total, LOGL_RTOL, "persite entries x weights vs total")
    # the multi-partition BLO, LINKED then SCALED
    blo_rows = []
    for mode, scalers in ((BRLEN_LINKED, (1.0, 1.0)),
                          (BRLEN_SCALED, SCALED_SCALERS)):
        ti = TreeInfo(tree.copy(), list(parts), brlen_linkage=mode)
        ti.brlen_scalers[:] = scalers
        start = ti.compute_loglh()
        stats = {}
        lnl, ms, host_ms = _events_ms(
            lambda: blo.optimize_branch_lengths_treeinfo(ti, stats=stats))
        name = "LINKED" if mode == BRLEN_LINKED else f"SCALED {scalers}"
        if not lnl >= start:
            raise AssertionError(f"TreeInfo BLO ({name}) ended below its "
                                 f"start: {lnl} < {start}")
        rel_close(lnl, f64_total(ti, parts64), LOGL_RTOL,
                  f"TreeInfo BLO logL ({name}) vs float64 scan")
        if stats["newton_edges"] == 0 or stats["iterative_edges"]:
            raise AssertionError(f"TreeInfo BLO ({name}) did not take kernel "
                                 f"10 for every edge: {stats}")
        row = dict(mode=name, start_lnl=start, lnl=lnl, ms_events=ms,
                   ms_host=host_ms, **stats)
        print(f"TreeInfo BLO: {row}")
        blo_rows.append(row)
    out["blo"] = blo_rows
    print(f"partitioned cell: {out}")
    return out


def run_blo(part, tree, part64, label, **kw):
    """One ``blo.optimize_branch_lengths`` call on a copy of ``tree``:
    ms by CUDA events and by the host clock, sweeps, sub-sweeps, mean
    Newton iterations; the logL checked against the start and against
    the float64 serial engine at the returned lengths."""
    tr = tree.copy()
    start_l = float(engine.tree_loglikelihood(part, tr))
    stats = {}
    (_, lnl), ms, host_ms = _events_ms(
        lambda: blo.optimize_branch_lengths(part, tr, stats=stats, **kw))
    if not lnl >= start_l:
        raise AssertionError(f"BLO ({label}) ended below its start: "
                             f"{lnl} < {start_l}")
    l64 = float(engine.tree_loglikelihood(part64, tr, schedule="scan"))
    rel_close(lnl, l64, LOGL_RTOL, f"BLO logL ({label}) vs float64 scan")
    row = dict(cell=label, start_lnl=start_l, lnl=lnl, lnl_f64=l64,
               ms_events=ms, ms_host=host_ms,
               sweeps=stats["sweeps"], sub_sweeps=stats["sub_sweeps"],
               mean_newton_iters=(stats["newton_iters"]
                                  / max(stats["newton_edges"], 1)), **kw)
    row["ms_per_sub_sweep"] = row["ms_events"] / stats["sub_sweeps"]
    print(f"BLO ({label}, {kw or 'defaults'}): {row}")
    return row, tr


def sub_sweep_split(part, tree, label):
    """Device ms of one colored sub-sweep at ``tree``'s lengths, and of
    its stages: the fused walk over the directed table, kernel 8 on the
    color's edges, kernel 10 on them."""
    trav = blo.DirectedTraversal(tree)
    tabs = blo._compile_tables(part, trav)
    sel = torch.as_tensor(np.nonzero(blo._edge_colors(tree)[0])[0],
                          device=part.device)
    brl = torch.as_tensor(np.clip(tree.lengths, MIN_BRANCH_LEN,
                                  MAX_BRANCH_LEN), dtype=torch.float32,
                          device=part.device)
    clvs, scalers = blo._directed_clvs(part, tabs, brl)
    st, sc = deriv.edge_sumtables(part, clvs, scalers, tabs.eref6[sel],
                                  tabs.basis)
    nargs = (part, st, sc, brl[sel], MIN_BRANCH_LEN, MAX_BRANCH_LEN,
             TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS, tabs.lw, tabs.lnB)
    split = dict(
        cell=label, edges=len(sel),
        sub_sweep_ms=time_ms(lambda: blo._blo_sweep(
            part, tabs, sel, brl, MIN_BRANCH_LEN, MAX_BRANCH_LEN,
            TOL_BRANCH_LEN), 10),
        fused_walk_ms=time_ms(lambda: blo._directed_clvs(part, tabs, brl),
                              10),
        edge_sumtables_ms=time_ms(lambda: deriv.edge_sumtables(
            part, clvs, scalers, tabs.eref6[sel], tabs.basis), 10),
        newton_edges_ms=time_ms(lambda: deriv.newton_edges(*nargs), 10),
        newton_iters=float(deriv.newton_edges(*nargs)[2].float().mean()))
    print(f"sub-sweep split ({label}): {split}")
    return split


def eval_loop(part, tree, schedule="auto"):
    """The main path's compiled evaluator over TIMED_EVALS varying branch
    lengths: returns ``loop()``, which issues them all and returns the
    summed logL (a device tensor). ``schedule="grouped"`` evaluates
    through ``grouped.loglikelihood_grouped`` on a schedule compiled
    once, "packed" through ``packed.loglikelihood_packed``, "combined"
    through ``levels.loglikelihood_pallas(step="combined")`` (kernel 5 a
    level) on a LevelSchedule and its tables compiled once."""
    if schedule == "combined":
        lvls, offsets, ri, ns = engine.compile_schedule(part, tree)
        tables = levels.level_tables(part, lvls)

        def ev(p, brl):
            return levels.loglikelihood_pallas(p, lvls, brl, offsets, ri, ns,
                                               step="combined", tables=tables)
    elif schedule == "grouped":
        sched = grouped.GroupedSchedule(part, tree)

        def ev(p, brl):
            return grouped.loglikelihood_grouped(p, brl, sched)
    elif schedule == "packed":
        psched = packed.PackedSchedule(part, tree)

        def ev(p, brl):
            return packed.loglikelihood_packed(p, brl, psched)
    else:
        ev = engine.compile_fast_eval(part, tree, schedule=schedule)
    base = torch.as_tensor(tree.lengths, dtype=torch.float32,
                           device=part.device)
    scales = 1.0 + 1e-4 * torch.arange(TIMED_EVALS, device=part.device)
    brls = base[None, :] * scales[:, None]

    def loop():
        acc = torch.zeros((), dtype=torch.float32, device=part.device)
        for i in range(TIMED_EVALS):
            acc = acc + ev(part, brls[i])
        return acc
    return loop


def timed_main_path(part, tree, label, schedule="auto"):
    """(ms per full evaluation on the device, host ms to issue one):
    P-matrices, kernel and epilogue, after one warm-up loop."""
    loop = eval_loop(part, tree, schedule)
    loop()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    acc = loop()
    stop.record()
    issue_ms = (time.perf_counter() - t0) * 1e3 / TIMED_EVALS
    stop.synchronize()
    if not np.isfinite(float(acc)):
        raise AssertionError(f"non-finite logL sum on the main path "
                             f"({label}, {schedule})")
    ms = start.elapsed_time(stop) / TIMED_EVALS
    print(f"main path ({label}, {schedule}): {ms:.4f} ms/eval on the "
          f"device, host issues one eval in {issue_ms:.4f} ms")
    return ms, issue_ms


def profile_window(label, fn, calls: int) -> dict:
    """Trace ``fn()`` (``calls`` evaluations or BLO calls, after one
    warm-up): device time per call of each device kernel (torch.profiler's
    kernel events, not the host ops that launched them) and the device's
    busy share of the window. Prints and returns the summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    per_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = per_kernel.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us()
            row[1] += 1
    busy_us = sum(us for us, _ in per_kernel.values())
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    summary = {
        "profile": label, "calls": calls,
        "window_ms_per_call": window_s * 1e3 / calls,
        "device_busy_ms_per_call": busy_us / 1e3 / calls,
        "device_busy_share": busy_us / 1e6 / window_s,
        "kernel_launches_per_call": sum(n for _, n in per_kernel.values())
        / calls,
        "kernels": [{"name": k[:90], "device_us_per_call": us / calls,
                     "calls_per_call": n / calls}
                    for k, (us, n) in rows[:12]]}
    print(json.dumps(summary))
    return summary


PHASE_DEFINES = ("PLLMOD_PHASES",)    # csrc/common.cuh PHASE_MARK
RESIDENT_PHASES = ("wait", "issue", "children", "product_max", "barrier",
                   "rescale_store")
# kernel 1's thread kind: consumer thread 0's row (marks 0-4), and the
# producer warp's lane 0 filling that row's entry (marks 5-7)
RESIDENT_THREAD_PHASES = ("wait_full", "children_max", "rescale", "stores")
RESIDENT_PRODUCER_PHASES = ("producer_wait_empty", "producer_issue")
NEWTON_PHASES = ("coefficients", "sums", "reduce_push", "cluster_sync",
                 "newton_step")
SUMTABLE_PHASES = ("barrier", "loads", "products", "stores")  # + staging


GROUP_THREAD_PHASES = ("children_products", "barrier", "rescale_store")
# kernels 4 and 5 (csrc/levels.cu level_tiled), a row's tile 0
LEVEL_PHASES = ("issue", "wait", "products", "maxima_barrier",
                "rescale_store")
GROUP_TILE_PHASES = ("issue", "wait", "products", "barrier",
                     "rescale_store")


def start_phase_build():
    """Start building pruning.cu, deriv.cu, packed.cu, grouped.cu and
    levels.cu with their phase marks in a thread, beside the default
    build; returns the build's future."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    future = pool.submit(_build.build, ("pruning", "deriv", "packed",
                                        "grouped", "levels"), PHASE_DEFINES)
    pool.shutdown(wait=False)
    return future


def phase_profile(marked, set_buffer, label, kernel, fn, rows: int,
                  names, once=None, side=()) -> None:
    """Where a row of kernel 1, a step of kernel 6 or 7, a Newton
    iteration of kernel 10 or a row's tile of kernel 4 or 5 spends its
    cycles: ``fn`` (one launch through the port's wrapper) run through
    ``marked``, the build with phase marks, records CTA 0's thread 0's
    clock64() (kernels 4 and 5: tile 0's of each row) at each phase
    boundary of its first ``rows`` rows or iterations; prints the mean
    cycles of each
    phase over the inner ones (the first and last two dropped where there
    are eight or more, else one), and ms a launch of the marked build
    against the port's own library, timed in turns (library, marked,
    marked, library) with the marks recording. ``once``: the name of a
    phase the kernel runs once, before its loop, marked in row 127 (kernel
    8's staging). ``side``: the phases of a second marked thread, between
    marks len(names) + 1 and 7 of a row (kernel 1's producer warp)."""
    clk = torch.zeros(128 * 8, dtype=torch.int64, device="cuda")
    set_buffer(clk.data_ptr())
    t = []
    for use in (False, True, True, False):
        with _build.using(marked) if use else contextlib.nullcontext():
            t.append(device_ms(fn, 20))
    clk.zero_()
    with _build.using(marked):
        fn()
    torch.cuda.synchronize()
    set_buffer(None)
    c_all = clk.view(-1, 8).cpu().numpy()
    c = c_all[:min(rows, 128)]
    cut = 2 if len(c) >= 8 else 1
    c = c[cut:len(c) - cut] if len(c) > 2 * cut else c
    d = np.diff(c[:, :len(names) + 1], axis=1).mean(axis=0)
    extra = {once: float(c_all[127, 1] - c_all[127, 0])} if once else {}
    if side:
        first = len(names) + 1
        extra.update(zip(side, map(float, np.diff(
            c[:, first:first + len(side) + 1], axis=1).mean(axis=0))))
    print(json.dumps(dict(
        phases=label, kernel=kernel, rows=rows, library_ms=[t[0], t[3]],
        marked_ms=[t[1], t[2]],
        cycles=float((c[:, len(names)] - c[:, 0]).mean()),
        **{n: float(v) for n, v in zip(names, d)}, **extra)))


def resident_phase_profile(marked, set_buffer, label, args) -> None:
    """:func:`phase_profile` of kernel 1 on ``args`` (resident_walk's),
    with the phases of its kind at this shape."""
    idx8, P5, tc, tab, ns = args
    _, _, C, S, _ = P5.shape
    T, cf = _build.walk_launch_config("pllmod_resident_walk", C, S,
                                      tab.shape[0], ns, tc.shape[1])
    thread = cf["kind"] == "thread"
    phase_profile(marked, set_buffer, f"{label}, {cf['kind']} kind, tile "
                  f"{T}", "resident_walk",
                  lambda: resident.resident_walk(*args), len(idx8),
                  RESIDENT_THREAD_PHASES if thread else RESIDENT_PHASES,
                  side=RESIDENT_PRODUCER_PHASES if thread else ())


def kernel1_phase_profiles(build, shapes) -> None:
    """:func:`resident_phase_profile` of kernel 1 at each of ``shapes``
    (:func:`kernel1_shapes`), with the build that
    :func:`start_phase_build` started."""
    import ctypes
    paths = build.result()
    marked = _build.entry_points({"pruning": paths["pruning"]})
    setter = ctypes.CDLL(paths["pruning"]).pllmod_phase_buffer

    def set_buffer(ptr):
        if setter(ctypes.c_void_p(ptr)):
            raise RuntimeError("pllmod_phase_buffer failed")
    for label, args in shapes:
        resident_phase_profile(marked, set_buffer, label, args)


def run_phase_profiles(build, cells) -> None:
    """:func:`phase_profile` of kernels 1, 4, 5, 6 and 7 at the flagship
    and protein cells (kernels 4 and 5 on the widest level and on the
    level with the most rows of two inner children) and of kernels 8 and
    10 at SUMTABLE_SHAPES' and NEWTON_SHAPES' all-edge shapes, with the
    build that :func:`start_phase_build` started."""
    import ctypes
    paths = build.result()
    marked = _build.entry_points(paths)
    setters = [ctypes.CDLL(p).pllmod_phase_buffer for p in paths.values()]

    def set_buffer(ptr):
        for f in setters:
            if f(ctypes.c_void_p(ptr)):
                raise RuntimeError("pllmod_phase_buffer failed")
    for label, part, tree in cells:
        resident_phase_profile(marked, set_buffer, label,
                               resident_args(part, tree))
        brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                              device=part.device)
        # kernels 6 and 7: the cycles of a step (R rows of a window)
        C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
        tab = fused.code_table(part)
        T, R = _build.group_walk_tile(C, S, tab.shape[0], Ppad)
        names = (GROUP_THREAD_PHASES if _build.group_walk_config(
            C, S, tab.shape[0], T, R)["kind"] == "thread"
            else GROUP_TILE_PHASES)
        ps = packed.PackedSchedule(part, tree)
        pargs = (ps.idxm, ps.e1, ps.e2, part.prob_matrices(brl).contiguous(),
                 part.tip_states, tab, ps.G, ps.windows)
        gs = grouped.GroupedSchedule(part, tree)
        gargs = (gs.side_meta, gs.dst_meta,
                 grouped.grouped_pmats(part, brl, gs.e_sides),
                 part.tip_states, tab, gs.order, gs.windows)
        for name, fn, win in (
                ("packed_walk", lambda: packed.packed_walk(*pargs),
                 ps.windows),
                ("grouped_walk", lambda: grouped.grouped_walk(*gargs),
                 gs.windows)):
            steps = int(sum(-(-int(n) // R)
                            for n in np.diff(win.cpu().numpy())))
            phase_profile(marked, set_buffer, label, name, fn, steps, names)
        # kernels 4 and 5: a row's tile, on two levels
        lvls, offsets, _, ns = engine.compile_schedule(part, tree)
        idx, e1, e2 = levels.level_tables(part, lvls)
        P = part.prob_matrices(brl)
        P1, P2 = P[e1], P[e2]
        bufs = levels.update_partials_pallas(part, P, lvls, offsets, ns)
        rows_np = idx.cpu().numpy()
        sl = [slice(o, o + len(lv)) for lv, o in zip(lvls, offsets)]
        inner = [int(((rows_np[s, 2] == 0) & (rows_np[s, 3] == 0)).sum())
                 for s in sl]
        for li in sorted({0, int(np.argmax(inner))}):
            s = sl[li]
            W = s.stop - s.start
            left, s1 = levels.child_pass(idx[s], 0, *bufs, part.tip_states,
                                         tab, P1[s])
            where = f"{label}, level {li} (W {W}, {inner[li]} inner rows)"
            for kernel, fn in (
                    ("child2_pass", lambda: levels.child2_pass(
                        idx[s], *bufs, part.tip_states, tab, P2[s], left, s1,
                        s.start)),
                    ("level_combined", lambda: levels.level_update_combined(
                        *bufs, idx[s], part.tip_states, tab, P1[s], P2[s],
                        s.start))):
                mode = "child2" if kernel == "child2_pass" else "combined"
                T = _build.level_tile(mode, C, S, tab.shape[0], Ppad, W)
                phase_profile(marked, set_buffer, f"{where}, tile {T}",
                              kernel, fn, min(W, 128), LEVEL_PHASES)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, args in SUMTABLE_SHAPES:
        cf = sumtable_design(args[0], len(args[3]))
        if "all" not in label or "T" not in cf:
            continue
        items = len(args[3]) * (args[0].n_patterns_padded // cf["T"])
        phase_profile(marked, set_buffer, label, "edge_sumtables",
                      lambda: deriv.edge_sumtables(*args),
                      min(127, -(-items // (n_sm * cf["ctas_per_sm"]))),
                      SUMTABLE_PHASES, once="staging")
    for label, parts, sts, scs, t0, scalers, lws, lnbs in NEWTON_SHAPES:
        if "all" not in label:
            continue
        nargs = (parts, sts, scs, t0, scalers, MIN_BRANCH_LEN,
                 MAX_BRANCH_LEN, TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS, lws,
                 lnbs)
        iters0 = int(deriv.newton_edges_multi(*nargs)[2][0])
        phase_profile(marked, set_buffer, label, "newton_edges",
                      lambda: deriv.newton_edges_multi(*nargs), iters0,
                      NEWTON_PHASES)


def sweep_rows(part, tree, n_taxa, slot_counts=(None,)):
    """Both walk kernels, forced, on ``part`` / ``tree``: the fused walk
    once, the resident walk at each of ``slot_counts`` (None: the tree's
    own live slots; a larger count reserves that many slots, the shape of
    a tree that needs them) where its slots fit a block at some tile,
    held bit for bit against its plain version and its root product
    against the fused walk's. Returns a row a slot count: device ms a
    launch of each, which was faster and what ``auto`` picks."""
    states, cats = part.states, part.n_cats
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32, device="cuda")
    tab = fused.code_table(part)
    fi, fe1, fe2, ri, fns = fused.compile_fused(part, tree, fuse_root=True)
    fargs = (fi, fused.pair_pmats(part, brl, fe1, fe2, root_row=True),
             part.tip_states, tab, fns)
    fused_ms = device_ms(lambda: fused.fused_walk(*fargs), 10)
    fused_root = fused.fused_walk(*fargs)[0][ri[3]]
    out = []
    for want_ns in slot_counts:
        ri8, re1, re2, rns = resident.compile_resident(part, tree,
                                                       n_slots_min=want_ns)
        T = _build.resident_tile(cats, states, tab.shape[0], rns,
                                 part.n_patterns_padded)
        res_ms, cf = None, None
        if T is not None:
            cf = _build.resident_config(cats, states, tab.shape[0], rns, T)
            rargs = (ri8, fused.pair_pmats(part, brl, re1, re2,
                                           root_row=True),
                     part.tip_states, tab, rns)
            res_ms = device_ms(lambda: resident.resident_walk(*rargs), 10)
            got = resident.resident_walk(*rargs)
            want = resident.resident_walk_plain(*rargs)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"resident walk (S={states}, C={cats}, "
                                     f"{rns} slots) differs from its plain "
                                     "version")
            compare(f"resident vs fused root product (S={states}, "
                    f"C={cats}, {rns} slots)", got[0], fused_root)
        faster = ("fused" if res_ms is None or fused_ms < res_ms
                  else "resident")
        row = dict(taxa=n_taxa, patterns=part.n_patterns_padded,
                   states=states, cats=cats, cs=states * cats,
                   resident_slots=rns, forced_slots=want_ns is not None,
                   resident_tile=T, resident_kind=cf and cf["kind"],
                   resident_threads=cf and cf["threads"],
                   resident_smem=cf and cf["smem"],
                   resident_ctas_per_sm=cf and _build.ctas_per_sm(
                       cf["threads"], cf["smem"]),
                   resident_ms=res_ms, fused_ms=fused_ms, faster=faster,
                   auto=engine.auto_schedule(part, rns))
        row["auto_is_faster"] = row["auto"] == faster
        print(f"sweep: {row}")
        out.append(row)
    return out


def slot_ladder(part, n_taxa, own: int) -> list:
    """The tree's own slot count (None), then, up to the slot bound of
    ``n_taxa`` tips (resident.resident_slot_bound), the first and last
    slot count of each pattern tile that the resident walk takes there."""
    C, S, nc, P = (part.n_cats, part.states, part.code_clv.shape[0],
                   part.n_patterns_padded)
    by_tile: dict = {}
    for ns in range(own + 1, resident.resident_slot_bound(n_taxa) + 1):
        by_tile.setdefault(_build.resident_tile(C, S, nc, ns, P),
                           []).append(ns)
    return [None] + sorted({x for v in by_tile.values()
                            for x in (v[0], v[-1])})


# kernel 8's rule: (taxa, patterns, states, categories) of the cells
# whose BLO launches it (flagship DNA, protein) and of other state
# counts on a 128-taxon tree
SUMTABLE_SWEEP = [(128, 16384, 4, 4), (512, 4096, 20, 4), (128, 4096, 4, 1),
                  (128, 4096, 5, 4), (128, 4096, 8, 4), (128, 4096, 16, 4),
                  (128, 4096, 20, 4), (128, 4096, 32, 4)]


def sumtable_routing_sweep() -> list:
    """Kernel 8 at the BLO's launch shapes (every live edge, and each
    edge-color class) of SUMTABLE_SWEEP's trees: the simple kernel and
    the tiled kernel at every tile and ring depth it takes, device ms a
    launch, each held bit for bit to the simple kernel (the measurements
    behind ``_build.sumtable_config``'s rule)."""
    rows = []
    for taxa, sites, S, C in SUMTABLE_SWEEP:
        part, tree = flagship.example(taxa, sites, seed=11, states=S,
                                      n_rate_cats=C, device="cuda")
        part = part.cache_eigen()
        trav = blo.DirectedTraversal(tree)
        tabs = blo._compile_tables(part, trav)
        brl = torch.as_tensor(np.clip(tree.lengths, MIN_BRANCH_LEN,
                                      MAX_BRANCH_LEN), dtype=torch.float32,
                              device=part.device)
        clvs, scalers = blo._directed_clvs(part, tabs, brl)
        n_codes, Ppad = part.code_clv.shape[0], part.n_patterns_padded
        tiles = [T for T in _build.SUMTABLE_TILES
                 if _build.sumtable_config(C, S, n_codes, Ppad, 1, T)]
        sets = [("all", trav.edge_mask)] + [
            (f"color {k}", m) for k, m in enumerate(blo._edge_colors(tree))]
        for name, mask in sets:
            sel = torch.as_tensor(np.nonzero(mask)[0], device=part.device)
            args = (part, clvs, scalers, tabs.eref6[sel], tabs.basis)
            want = deriv.edge_sumtables(*args, simple=True)
            ms = {"simple": device_ms(
                lambda: deriv.edge_sumtables(*args, simple=True), 10)}
            for T in tiles:
                got = deriv.edge_sumtables(*args, tile=T)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"edge_sumtables at tile {T} "
                                         "differs from the simple kernel")
                ms[f"tile {T}"] = device_ms(lambda: deriv.edge_sumtables(
                    *args, tile=T), 10)
            rule = _build.sumtable_config(C, S, n_codes, Ppad, len(sel))
            pick = f"tile {rule['T']}" if rule else "simple"
            best = min(ms, key=ms.get)
            rows.append(dict(taxa=taxa, patterns=sites, states=S, cats=C,
                             edges=len(sel), set=name, rule=pick,
                             rule_ms=ms[pick], best=best, best_ms=ms[best],
                             simple_ms=ms["simple"], ms=ms))
            print(f"kernel 8 sweep: {rows[-1]}")
        del clvs, scalers
    return rows


def routing_sweep():
    """The routing sweep: :func:`sweep_rows` at every (states,
    categories) of SWEEP_SHAPES and size of SWEEP_SIZES (the trees' own
    slots), and at SLOT_SWEEP's larger trees, there over
    :func:`slot_ladder` as well."""
    out = []
    runs = [(n, p, s, c, False) for n, p in SWEEP_SIZES
            for s, c in SWEEP_SHAPES] + list(SLOT_SWEEP)
    for n_taxa, n_sites, states, cats, ladder in runs:
        part, tree = flagship.example(n_taxa, n_sites, seed=11 + states,
                                      states=states, n_rate_cats=cats,
                                      device="cuda")
        part = part.cache_eigen()
        counts = (None,)
        if ladder:
            own = resident.compile_resident(part, tree)[3]
            counts = slot_ladder(part, n_taxa, own)
        out += sweep_rows(part, tree, n_taxa, counts)
        del part
        torch.cuda.empty_cache()
    return out


def supermatrix_cell():
    """(partition, tree) at SUPERMATRIX's shape: a :func:`flagship.example`
    alignment of its size (uncompressed: 413,568 padded patterns) on a
    :func:`flagship.random_binary_tree` with lengths U(0.02, 0.4), the
    recipe of the aa144 configuration's tree."""
    sm = SUPERMATRIX
    part, _ = flagship.example(sm["n_taxa"], sm["n_sites"], seed=sm["seed"],
                               states=sm["states"], device="cuda")
    tree = flagship.random_binary_tree(np.random.default_rng(sm["seed"]),
                                       sm["n_taxa"], 0.02, 0.4)
    return part.cache_eigen(), tree


def supermatrix_turns() -> dict:
    """Kernel 1 (the resident walk at its rule's tile and kind) and kernel
    2 (the fused walk, fuse_root), both forced, at the supermatrix's shape
    on the tree's own slots (:func:`supermatrix_cell`):
    :func:`sweep_rows` SUPERMATRIX_TURNS times, so that each walk is
    timed in turns with the other. Returns the rows, each walk's device
    ms a launch, which was faster by the sums and what ``auto`` picks."""
    part, tree = supermatrix_cell()
    rows = [r for _ in range(SUPERMATRIX_TURNS)
            for r in sweep_rows(part, tree, SUPERMATRIX["n_taxa"])]
    res = [r["resident_ms"] for r in rows]
    fus = [r["fused_ms"] for r in rows]
    faster = "resident" if sum(res) < sum(fus) else "fused"
    out = dict(rows=rows, resident_ms=res, fused_ms=fus, faster=faster,
               auto=rows[0]["auto"], auto_is_faster=rows[0]["auto"] == faster)
    print(f"supermatrix: {out}")
    del part
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: model-parameter optimization (algorithm/opt_model.py)
# ---------------------------------------------------------------------------
OPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "opt_model")      # the eval command's input files
PROTGTR = dict(n_taxa=10, n_sites=256, seed=0)   # tools/tpu_parity.py:306
CANARY_GAIN = 0.05        # the canary's float64 restart may gain this much
DECOMP_F_RTOL, DECOMP_G_RTOL = 1e-6, 1e-3     # tools/tpu_parity.py:296-299
EM_LOG_ATOL = 1e-5        # E-step: kernel 2 vs serial engine, ln L[p]
# every kernel a phase-6 run must launch (kernel 2 on every gradient path)
OPT_MUST = {"cli": ("resident_walk", "fused_walk", "edge_sumtables",
                    "edge_derivatives", "newton_edges"),
            "protein": ("resident_walk", "fused_walk", "edge_sumtables",
                        "edge_derivatives", "newton_edges"),
            "free_rates": ("resident_walk", "fused_walk"),
            "canary": ("fused_walk",)}


def f64_copy(part):
    """A partition's float64 copy on its device (a sharded partition's
    gathered on its first device), without the cached
    eigendecomposition (recomputed in float64)."""
    if is_sharded(part):
        part = part.gather()
    return part.to(dtype=torch.float64).with_model_params()


def f64_treeinfo_lnl(ti) -> float:
    """The float64 serial engine's total logL at a TreeInfo's parameters
    and lengths."""
    ops, ri = ti.tree.traversal_ops()
    return sum(float(engine.loglikelihood(
        f64_copy(ti.partitions[i]), ops,
        torch.as_tensor(ti.partition_brlens(i), dtype=torch.float64,
                        device="cuda"), ri))
        for i in ti.local_indices())


def _decomp_vg(build, brl, et, x):
    xt = torch.tensor(x, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    f = edge_grad.edge_decomp_neg_loglh(build(xt), brl, et)
    g, = torch.autograd.grad(f, xt)
    return float(f.detach()), g.cpu().numpy()


def check_decomposition(part, tree, label, families):
    """The edge-decomposition (value, grad) of the float32 card path
    (kernel 2's directed walk) against the float64 decomposition on the
    card (the serial engine's directed CLVs), per family: relative f <
    DECOMP_F_RTOL, relative g < DECOMP_G_RTOL (tools/tpu_parity.py's
    bar). Returns the rows."""
    part64 = f64_copy(part)
    ets = {dt: edge_grad.edge_tables(p, tree)
           for dt, p in (("f32", part), ("f64", part64))}
    brls = {dt: torch.as_tensor(tree.lengths, dtype=p.dtype, device="cuda")
            for dt, p in (("f32", part), ("f64", part64))}
    rows = []
    for name, x in families:
        build = {"rates": lambda p: lambda z: edge_grad.with_rates(
                     p, edge_grad.expand_sym(z, torch.arange(
                         len(z) + 1, device="cuda"), len(z))),
                 "freqs": lambda p: lambda z: edge_grad.with_freq_ratios(
                     p, z),
                 "alpha_pinv": lambda p: lambda z:
                     edge_grad.with_alpha_pinv(p, z),
                 "cats": lambda p: lambda z: edge_grad.with_cats(p, z)}
        f32, g32 = _decomp_vg(build[name](part), brls["f32"], ets["f32"], x)
        f64, g64 = _decomp_vg(build[name](part64), brls["f64"], ets["f64"],
                              x)
        _, ms, _ = _events_ms(lambda: _decomp_vg(
            build[name](part), brls["f32"], ets["f32"], x), 3)
        rel_f = abs(f32 - f64) / abs(f64)
        rel_g = float(np.max(np.abs(g32 - g64)
                             / (np.abs(g64) + 1e-2 * np.abs(g64).max())))
        print(f"edge decomposition ({label}, {name}): rel f {rel_f:.3e}, "
              f"rel g {rel_g:.3e}, {ms:.3f} ms a (value, grad)")
        if not (rel_f < DECOMP_F_RTOL and rel_g < DECOMP_G_RTOL):
            raise AssertionError(f"edge decomposition ({label}, {name}) "
                                 f"off float64: f {rel_f}, g {rel_g}")
        rows.append(dict(family=name, rel_f=rel_f, rel_g=rel_g,
                         ms_per_value_and_grad=ms, dims=len(x)))
    return rows


def check_em_estep(part, tree, label):
    """The EM E-step's per-site per-category likelihoods from kernel 2's
    walk (float32) against the serial engine (float64) on the card: the
    site mixtures' logs, the posterior category shares (what the M-step
    reads; a category that underflows in float32 has a share of 0 in
    both) and the EM weights of both."""
    out = {}
    for dt, p in (("f32", part), ("f64", f64_copy(part))):
        brl = torch.as_tensor(tree.lengths, dtype=p.dtype, device="cuda")
        with torch.no_grad():
            lh, sc = opt_model.site_cat_likelihood(p, tree, brl)
        mix = lh.double()[:p.n_patterns] * p.rate_weights.double()
        site = mix.sum(1)
        ln_site = torch.log(site) + sc.double()[:p.n_patterns] * clv.LN2
        w = em_rates_weights(lh.to("cpu", torch.float64),
                             p.pattern_weights.to("cpu", torch.float64),
                             p.rate_weights.to("cpu", torch.float64))
        out[dt] = (ln_site, mix / site[:, None], w)
    err = float((out["f32"][0] - out["f64"][0]).abs().max())
    perr = float((out["f32"][1] - out["f64"][1]).abs().max())
    werr = float((out["f32"][2] - out["f64"][2]).abs().max())
    print(f"EM E-step ({label}): kernel 2 against the float64 serial "
          f"engine: max |Δ ln L[p]| {err!r}, max |Δ posterior| {perr!r}, "
          f"max |Δw| {werr!r}")
    if not (err <= EM_LOG_ATOL and perr <= EM_LOG_ATOL and werr <= 1e-4):
        raise AssertionError(f"EM E-step ({label}) off float64: {err}, "
                             f"{perr}, {werr}")
    return dict(max_abs_site_log_err=err, max_abs_posterior_err=perr,
                max_abs_weight_err=werr)


def reset_peak_memory() -> float:
    """Reset the card's peak-allocation counter; returns the GiB of
    tensors allocated now (what a run's peak starts from)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def opt_row(cell, what, start, lnl, ti, got, stats, gpu, mem):
    """A phase-6 row: the run's logL against its start and the float64
    serial engine at its parameters, its counts and host ms by family
    (``stats``: ``opt_model``'s, or host ``seconds`` a family of its
    own), its launches and its device memory: ``mem`` = (GiB allocated
    at its start, :func:`reset_peak_memory`'s return), the peak read
    here, before the float64 check allocates."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"opt_model ({cell}, {what}): device memory {mem!r} GiB "
          f"allocated at the start, peak {peak!r} GiB")
    want = f64_treeinfo_lnl(ti)
    if not lnl >= start - 1e-9 * abs(start):
        raise AssertionError(f"opt_model ({cell}, {what}) ended below its "
                             f"start: {lnl} < {start}")
    rel_close(lnl, want, LOGL_RTOL, f"opt_model ({cell}, {what}) vs float64")
    p = ti.partitions[0]
    by_family = {fam: {("ms" if k == "seconds" else k):
                       (v * 1e3 if k == "seconds" else v)
                       for k, v in c.items()} for fam, c in stats.items()}
    return dict(cell=cell, run=what, start_lnl=start, lnl=lnl,
                f64_lnl=want, rel_to_f64=abs(lnl - want) / abs(want),
                by_family=by_family,
                launches={k: n for k, n in got.items() if n},
                alpha=float(p.alpha), pinv=float(p.prop_invar[0]),
                start_gib=mem, peak_gib=peak, gpu=gpu)


def run_opt_model(gpu, profile: bool):
    """Phase 6: (a) ``eval --opt`` at the flagship DNA cell (GTR+G4: rates,
    frequencies, alpha, branches) through the CLI's ``eval``; (b) LG+G4+I from
    the AA registry at the protein cell: ``opt_alpha_pinv`` then
    ``opt_brlen``; (c) free rates (+R4, alpha NaN) at the flagship DNA
    cell: ``opt_rates_weights``, its E-step held against the serial
    engine; (d) the PROTGTR canary: ``opt_subst_rates`` at tol 1e-3 in
    float32, restarted in float64 from its endpoint. The edge
    decomposition of the four gradient families is held against float64
    first. Each run is counted under path ``opt_model``. Returns (rows,
    decomposition rows)."""
    rows, decomp = [], {}
    os.makedirs(OPT_DIR, exist_ok=True)
    seqs, newick, _, _ = flagship.simulated_data(**FLAGSHIP,
                                                 sim_seed=SIM_SEED)
    n = FLAGSHIP["n_taxa"]
    fasta = os.path.join(OPT_DIR, "flagship.fasta")
    nwk = os.path.join(OPT_DIR, "flagship.nwk")
    msa_io.write_fasta(MSA([f"t{i}" for i in range(n)], seqs), fasta)
    with open(nwk, "w") as fh:
        fh.write(newick)
    argv = ["eval", "--msa", fasta, "--tree", nwk, "--model", "GTR+G4",
            "--opt"]

    # (a) the CLI path; the decomposition and the E-step checks first, on
    # the same partition
    msa = msa_io.load_msa(fasta)
    tree = Tree.from_newick(newick)
    cli._order_tree_tips(tree, msa)
    part, _, _ = cli.build_partition(msa, "GTR+G4")
    decomp["flagship DNA"] = check_decomposition(part, tree, "flagship DNA", [
        ("rates", np.array([1.1, 2.0, 0.7, 0.9, 3.0])),
        ("freqs", np.array([1.2, 0.8, 1.1])),
        ("alpha_pinv", np.array([0.6, 0.15])),
        ("cats", np.array([0.2, 0.6, 1.2, 2.0]))])
    decomp["em_estep"] = {"flagship DNA": check_em_estep(
        part, tree, "flagship DNA")}
    args = cli.parse_args(argv)

    def cli_run():
        t0 = time.perf_counter()
        out = args.fn(args)
        out["stats"]["eval --opt"] = {"seconds": time.perf_counter() - t0}
        return out
    mem = reset_peak_memory()
    res, got = counted("flagship DNA", "opt_model", cli_run,
                       must=OPT_MUST["cli"])
    rows.append(opt_row("flagship DNA", "eval --opt GTR+G4", res["lnl0"],
                        res["lnl"], res["treeinfo"], got, res["stats"], gpu,
                        mem))
    if profile:
        rows[-1]["profile"] = profile_window(
            "opt_model, flagship DNA (eval --opt)",
            lambda: args.fn(args), 1)

    # (b) protein, LG+G4+I
    pseqs, pnewick, _, _ = flagship.example_data(**PROTEIN)
    ptree = Tree.from_newick(pnewick)
    labels = [f"t{i}" for i in range(PROTEIN["n_taxa"])]
    pmsa = MSA(labels, pseqs)
    cli._order_tree_tips(ptree, pmsa)
    ppart, _, mask = cli.build_partition(pmsa, "LG+G4+I")
    decomp["protein"] = check_decomposition(ppart, ptree, "protein", [
        ("alpha_pinv", np.array([0.6, 0.15]))])

    def protein_run():
        ti = TreeInfo(ptree.copy(), [ppart], params_to_optimize=mask)
        stats = {}
        start = ti.compute_loglh()
        t0 = time.perf_counter()
        opt_model.opt_alpha_pinv(ti, stats=stats)
        t1 = time.perf_counter()
        opt_model.opt_brlen(ti)
        stats["alpha_pinv"]["seconds"] = t1 - t0
        stats["brlen"] = {"seconds": time.perf_counter() - t1}
        return ti, start, ti.compute_loglh(), stats
    mem = reset_peak_memory()
    (ti, start, lnl, stats), got = counted("protein", "opt_model",
                                           protein_run,
                                           must=OPT_MUST["protein"])
    rows.append(opt_row("protein", "LG+G4+I opt_alpha_pinv, opt_brlen",
                        start, lnl, ti, got, stats, gpu, mem))
    if profile:
        rows[-1]["profile"] = profile_window("opt_model, protein",
                                             protein_run, 1)
    del ti, ppart
    torch.cuda.empty_cache()

    # (c) free rates + weights at the flagship DNA cell (+R4)
    rpart = create_partition(msa.sequences, states=4, n_rate_cats=4,
                             alpha=None, compress=False)
    decomp["em_estep"]["flagship DNA +R4"] = check_em_estep(
        rpart, tree, "flagship DNA +R4")

    def free_rates_run():
        ti = TreeInfo(tree.copy(), [rpart],
                      params_to_optimize=PARAM_FREE_RATES
                      | PARAM_RATE_WEIGHTS)
        start = ti.compute_loglh()
        stats = {}
        t0 = time.perf_counter()
        opt_model.opt_rates_weights(ti, stats=stats)
        stats["rates_weights"]["seconds"] = time.perf_counter() - t0
        return ti, start, ti.compute_loglh(), stats
    mem = reset_peak_memory()
    (ti, start, lnl, stats), got = counted("flagship DNA +R4", "opt_model",
                                           free_rates_run,
                                           must=OPT_MUST["free_rates"])
    rows.append(opt_row("flagship DNA +R4", "opt_rates_weights", start, lnl,
                        ti, got, stats, gpu, mem))
    if profile:
        rows[-1]["profile"] = profile_window("opt_model, flagship DNA +R4",
                                             free_rates_run, 1)

    # (d) the 189-dimension PROTGTR canary
    rng = np.random.default_rng(PROTGTR["seed"])
    ctree = Tree.from_newick(flagship.random_newick(PROTGTR["n_taxa"], rng))
    syms = np.array(list(charmap.MULTI_SYMBOLS[:20]))
    cseqs = ["".join(r) for r in syms[rng.integers(
        0, 20, (PROTGTR["n_taxa"], PROTGTR["n_sites"]))]]

    def canary_part(dt, rates=None):
        r = np.random.default_rng(5)
        p = create_partition(cseqs, states=20, n_rate_cats=4,
                             charmap=charmap.multistate(20), alpha=0.8,
                             subst_rates=r.uniform(0.5, 2.0, 190),
                             freqs=r.dirichlet([8] * 20), compress=False,
                             dtype=dt)
        if rates is not None:
            p = p.with_model_params(subst_rates=rates)
        return p.cache_eigen()

    def canary_run():
        ti = TreeInfo(ctree.copy(), [canary_part(torch.float32)],
                      params_to_optimize=PARAM_SUBST_RATES)
        start = ti.compute_loglh()
        stats = {}
        t0 = time.perf_counter()
        lnl = opt_model.opt_subst_rates(ti, tol=1e-3, stats=stats)
        stats["rates"]["seconds"] = time.perf_counter() - t0
        return ti, start, lnl, stats
    mem = reset_peak_memory()
    (ti, start, lnl, stats), got = counted("PROTGTR canary", "opt_model",
                                           canary_run,
                                           must=OPT_MUST["canary"])
    row = opt_row("PROTGTR canary", "opt_subst_rates tol 1e-3", start, lnl,
                  ti, got, stats, gpu, mem)
    polish = TreeInfo(ctree.copy(), [canary_part(
        torch.float64, ti.partitions[0].subst_rates.to(torch.float64))],
        params_to_optimize=PARAM_SUBST_RATES)
    at_end = polish.compute_loglh()
    gain = opt_model.opt_subst_rates(polish, tol=1e-3) - at_end
    print(f"PROTGTR canary: float32 {lnl!r}, float64 at its endpoint "
          f"{at_end!r}, float64 restart gains {gain!r}")
    if not gain <= CANARY_GAIN:
        raise AssertionError(f"PROTGTR canary: the float64 restart gained "
                             f"{gain} > {CANARY_GAIN}")
    row.update(f64_restart_gain=gain)
    rows.append(row)
    for r in rows:
        print(f"opt_model: {json.dumps(r)}")
    return rows, decomp


# ---------------------------------------------------------------------------
# phase 7: SPR rounds and ancestral states (algorithm/spr.py, ancestral.py)
# ---------------------------------------------------------------------------
SPR_PERTURB = 10          # seeded random SPR moves from the simulating tree
SPR_PERTURB_SEED = 17
# the thorough scorer's check is repeated on a second alignment simulated
# along the same tree from these seeds
SIM_SEED_2, SPR_PERTURB_SEED_2 = 23, 29
SPR_CHECK_K = 8           # candidates of the fast scorer's checked batch
SPR_CHECK_K_THOROUGH = 4  # and of the thorough one's
# thorough lengths vs float64: 1e-3 relative, or a tenth of the triplet
# Newton's stopping step absolute near the 1e-4 lower bound, where
# float32 rounding moves a flat optimum by ~1e-6
TRIPLET_RTOL, TRIPLET_ATOL = 1e-3, 0.1 * spr.TRIPLET_TOL
ANC_ATOL = 1e-5           # ancestral probabilities vs float64; site sums
# every kernel an SPR round must launch: kernel 1 (compute_loglh), kernel
# 2 (full-tree and K-candidate directed CLVs), kernels 8-10 (the BLO)
SPR_MUST = ("resident_walk", "fused_walk", "edge_sumtables",
            "edge_derivatives", "newton_edges")
SPR_ROUNDS = (("fast", dict(radius_min=1, radius_max=10)),
              ("thorough", dict(thorough=True, radius_min=1, radius_max=5)))


def check_spr_scorers(part, tree, modes=SPR_ROUNDS):
    """The first batch of each mode's scorer (kernel 2 in the loop, the
    float32 contractions) against the same scorer on float64 copies on
    the card (the serial engine): logL within LOGL_RTOL relative on every
    live edge, thorough lengths within TRIPLET_RTOL relative or
    TRIPLET_ATOL absolute. Returns the margins (with the float64 and
    float32 lengths where the relative and where the absolute length
    error is largest) and the checks' host ms."""
    out = {}
    cands = spr._prune_candidates(tree)
    for mode, kw in modes:
        thorough = kw.get("thorough", False)
        k = SPR_CHECK_K_THOROUGH if thorough else SPR_CHECK_K
        got = {}
        for dt, p in (("f32", part), ("f64", f64_copy(part))):
            ti = TreeInfo(tree.copy(), [p])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[dt] = spr.score_candidates(ti, cands[:k], kw["radius_min"],
                                           kw["radius_max"], thorough)
            torch.cuda.synchronize()
            got[dt + "_ms"] = (time.perf_counter() - t0) * 1e3
            del ti
            torch.cuda.empty_cache()
        rel_l = rel_t = abs_t = margin_t = 0.0
        at_rel = at_abs = (None, None)   # (float64, float32) lengths
        n_live = 0
        for r32, r64 in zip(got["f32"], got["f64"]):
            live = np.isfinite(r64[1])
            if r32[0] != r64[0] or not np.array_equal(
                    live, np.isfinite(r32[1])):
                raise AssertionError(f"SPR scorer ({mode}): the float32 and "
                                     f"float64 windows differ at {r32[0]}")
            n_live += int(live.sum())
            rel_l = max(rel_l, float(np.max(
                np.abs(r32[1][live] - r64[1][live]) / np.abs(r64[1][live]))))
            if thorough:
                for t32, t64 in zip(r32[2], r64[2]):
                    d = np.abs(t32[live] - t64[live])
                    t = np.abs(t64[live])
                    pair = (t64[live], t32[live])
                    j = int(np.argmax(d / t))
                    if d[j] / t[j] > rel_t:
                        rel_t = float(d[j] / t[j])
                        at_rel = tuple(float(x[j]) for x in pair)
                    j = int(np.argmax(d))
                    if d[j] > abs_t:
                        abs_t = float(d[j])
                        at_abs = tuple(float(x[j]) for x in pair)
                    margin_t = max(margin_t, float(np.max(
                        d / np.maximum(TRIPLET_RTOL * t, TRIPLET_ATOL))))
        print(f"SPR scorer ({mode}, first {k} candidates, {n_live} live "
              f"edges): float32 against float64 on the card: logL "
              f"relative {rel_l:.3e}; lengths relative {rel_t:.3e} "
              f"(float64 {at_rel[0]!r}, float32 {at_rel[1]!r}), absolute "
              f"{abs_t:.3e} (float64 {at_abs[0]!r}, float32 "
              f"{at_abs[1]!r}); {got['f32_ms']:.1f} / "
              f"{got['f64_ms']:.1f} ms")
        if not (len(got["f32"]) == len(got["f64"]) > 0 and n_live
                and rel_l <= LOGL_RTOL and margin_t <= 1.0):
            raise AssertionError(f"SPR scorer ({mode}) off float64: logL "
                                 f"{rel_l}, lengths {rel_t} relative, "
                                 f"{abs_t} absolute")
        out[mode] = dict(candidates=len(got["f32"]), live_edges=n_live,
                         rel_lnl=rel_l, rel_lengths=rel_t,
                         rel_lengths_at=at_rel, abs_lengths=abs_t,
                         abs_lengths_at=at_abs, margin_lengths=margin_t,
                         f32_ms=got["f32_ms"],
                         f64_ms=got["f64_ms"])
    return out


def check_spr_table(part, tree):
    """Kernel 2 over the K-candidate table a fast batch launches at the
    largest K (SPR_BATCH_CAP remainder trees of the round's first
    candidates, K·stride slots, built as ``spr._score_builds`` builds
    it) against its plain walk on the same inputs: equal bit for bit on
    every slot, CLVs and scalers. Returns its row."""
    K = spr.SPR_BATCH_CAP
    kw = dict(SPR_ROUNDS)["fast"]
    builds = []
    for e, j in spr._prune_candidates(tree):
        b = spr._build_candidate(tree, e, j, kw["radius_min"],
                                 kw["radius_max"])
        if b is not None:
            builds.append(b[0])
        if len(builds) == K:
            break
    stride = 3 * (tree.n_tips - 2) + 2
    tabs = spr._batch_tables(tree, builds, stride)
    wt = blo.walk_tables(part, tabs["ops_cat"], K * stride)
    brl = torch.as_tensor(tabs["brl_cat"], dtype=part.dtype,
                          device=part.device)
    P5 = fused.pair_pmats(part, brl, wt.e1, wt.e2, root_row=False)
    args = (wt.idx8, P5, part.tip_states, wt.codetab, wt.n_slots)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    got = {}
    for name, walk in (("kernel", fused.fused_walk),
                       ("plain", fused.fused_walk_plain)):
        out = (torch.zeros((wt.n_slots, C * S, Ppad), device=part.device),
               torch.zeros((wt.n_slots, 1, Ppad), dtype=torch.int32,
                           device=part.device))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = walk(*args, out=out)
        torch.cuda.synchronize()
        got[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    (k_clv, k_sc), (p_clv, p_sc) = got["kernel"], got["plain"]
    same = torch.equal(k_clv, p_clv) and torch.equal(k_sc, p_sc)
    err = float((k_clv - p_clv).abs().max())
    row = dict(candidates=len(builds), slots=wt.n_slots, rows=len(wt.idx8),
               buffer_gib=k_clv.numel() * 4 / 2**30, max_abs_err=err,
               kernel_ms=got["kernel_ms"], plain_ms=got["plain_ms"])
    print(f"SPR batch table (kernel 2 against its plain walk, one call "
          f"each, host ms): {json.dumps(row)}")
    del got, k_clv, k_sc, p_clv, p_sc, out
    torch.cuda.empty_cache()
    if not (same and len(builds) == K):
        raise AssertionError(f"kernel 2 over the {K}-candidate SPR table "
                             f"differs from its plain walk: {err}")
    return row


def run_spr(gpu, profile: bool):
    """Phase 7: the flagship cell simulated along its own tree
    (``flagship.simulated``, GTR+G4 at its rates, frequencies and α 0.75),
    started from that tree after SPR_PERTURB seeded random SPR moves: the
    scorers' first batches against float64 (:func:`check_spr_scorers`),
    then one fast round (radius 1-10) and one thorough round (radius
    1-5), each from the perturbed tree and counted under its path; each
    round's logL at or above its start and within LOGL_RTOL of the
    float64 serial engine at its final tree and lengths, the final tree
    binary and connected. Then the marginal ancestral states of every
    inner node of the thorough round's tree, counted under
    ``ancestral``: every site's probabilities sum to 1 within ANC_ATOL
    and agree with float64 on the card within ANC_ATOL. Returns (rows,
    scorer checks, the ancestral row)."""
    part, truth = flagship.simulated(**FLAGSHIP, sim_seed=SIM_SEED,
                                     device="cuda")
    part = part.cache_eigen()
    start = truth.copy()
    flagship.random_spr(start, SPR_PERTURB,
                        np.random.default_rng(SPR_PERTURB_SEED))
    start.check_integrity()
    scorer = check_spr_scorers(part, start)
    scorer["batch_table"] = check_spr_table(part, start)
    part2, _ = flagship.simulated(**FLAGSHIP, sim_seed=SIM_SEED_2,
                                  device="cuda")
    start2 = truth.copy()
    flagship.random_spr(start2, SPR_PERTURB,
                        np.random.default_rng(SPR_PERTURB_SEED_2))
    scorer["thorough, second seed"] = check_spr_scorers(
        part2.cache_eigen(), start2, SPR_ROUNDS[1:])["thorough"]
    del part2
    torch.cuda.empty_cache()
    rows = []
    final = None
    for mode, kw in SPR_ROUNDS:
        def one_round(kw=kw):
            ti = TreeInfo(start.copy(), [part])
            stats = {}
            spr.HOST_BUILD_SECONDS = 0.0
            lnl0 = ti.compute_loglh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lnl, n_applied, top = spr.spr_round(ti, stats=stats, **kw)
            torch.cuda.synchronize()
            stats["host_ms"] = (time.perf_counter() - t0) * 1e3
            stats["host_build_s"] = spr.HOST_BUILD_SECONDS
            return ti, lnl0, lnl, n_applied, top, stats
        mem = reset_peak_memory()
        (ti, lnl0, lnl, n_applied, top, stats), got = counted(
            "flagship SPR", f"spr_{mode}", one_round, must=SPR_MUST)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tree = ti.tree
        if not (tree.is_binary() and tree.check_integrity()):
            raise AssertionError(f"SPR round ({mode}): the final tree is "
                                 "not binary and connected")
        want = f64_treeinfo_lnl(ti)
        if not lnl >= lnl0 - 1e-9 * abs(lnl0):
            raise AssertionError(f"SPR round ({mode}) ended below its "
                                 f"start: {lnl} < {lnl0}")
        rel_close(lnl, want, LOGL_RTOL, f"SPR round ({mode}) vs float64")
        row = dict(cell="flagship SPR", round=mode, **kw,
                   host_ms=stats["host_ms"],
                   candidates=stats["candidates"],
                   batches=stats["batches"], max_batch=stats["max_batch"],
                   batch_limit=stats["batch_limit"],
                   full_clv_builds=stats["full_builds"],
                   applied=n_applied, toplist=len(top),
                   host_build_s=stats["host_build_s"], start_lnl=lnl0,
                   lnl=lnl, f64_lnl=want,
                   rel_to_f64=abs(lnl - want) / abs(want),
                   rf_start=splits.rf_distance(start, truth),
                   rf_end=splits.rf_distance(tree, truth),
                   launches={k: n for k, n in got.items() if n},
                   start_gib=mem, peak_gib=peak,
                   peak_less_start_gib=peak - mem, gpu=gpu)
        print(f"SPR round ({mode}): {json.dumps(row)}")
        if profile:
            row["profile"] = profile_window(f"SPR round ({mode})",
                                            lambda kw=kw: one_round(kw), 1)
        rows.append(row)
        final = tree
        del ti
        torch.cuda.empty_cache()

    def anc():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, probs = ancestral.ancestral_probabilities(part, final)
        return nodes, probs, (time.perf_counter() - t0) * 1e3
    (nodes, probs, ms), got = counted("flagship SPR", "ancestral", anc,
                                      must=("fused_walk",))
    _, probs64 = ancestral.ancestral_probabilities(f64_copy(part), final)
    n = part.n_patterns
    sum_err = float(np.abs(probs[:, :n].sum(-1) - 1.0).max())
    err = float(np.abs(probs[:, :n] - probs64[:, :n]).max())
    print(f"ancestral states ({len(nodes)} inner nodes): {ms:.1f} ms, "
          f"max |Σp − 1| {sum_err!r}, max |Δp| against float64 {err!r}")
    if not (len(nodes) == FLAGSHIP["n_taxa"] - 2 and sum_err <= ANC_ATOL
            and err <= ANC_ATOL):
        raise AssertionError(f"ancestral states off: {sum_err}, {err}")
    anc_row = dict(cell="flagship SPR", nodes=len(nodes), host_ms=ms,
                   max_abs_sum_err=sum_err, max_abs_err_to_f64=err,
                   launches={k: n for k, n in got.items() if n}, gpu=gpu)
    return rows, scorer, anc_row


# ---------------------------------------------------------------------------
# phase 8: the full ML search (algorithm/search.py, tree/starting.py,
# binary/)
# ---------------------------------------------------------------------------
SEARCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "search")    # checkpoints, the CLI's input
SEARCH_CELL = dict(seed=246, n_taxa=246, n_sites=4465)
SEARCH_ALPHA0 = 0.5       # the starting Γ shape (tools/probe_search246.py)
SEARCH_PARSIMONY_SEED = 1
SEARCH_MASK = (PARAM_SUBST_RATES | PARAM_FREQUENCIES | PARAM_ALPHA
               | PARAM_BRANCHES_ITERATIVE)
SEARCH_KW = dict(radius_min=1, radius_step=5, radius_max=15, max_rounds=18,
                 thorough=True)
MONOTONE_SLACK = 1e-3     # a round's logL vs the best before it
RESUME_AFTER = 2          # the checkpoint copied aside after this round
RESUME_SLACK = 0.1        # resumed end vs the full run's next round
CLI_SEARCH_TAXA = 32
CLI_SEARCH_ARGS = ["--radius-max", "5"]
# every kernel the search must launch (SPR_MUST), and the CLI's search
CLI_SEARCH_MUST = ("resident_walk", "fused_walk", "edge_sumtables",
                   "edge_derivatives", "newton_edges")


@contextlib.contextmanager
def search_stages(calls: list):
    """``ml_search``'s two callees timed by host clock while the block
    runs: each ``opt_model`` and ``spr_round`` call appends (name, ms,
    the round's ``stats`` for ``spr_round``) to ``calls``."""
    real = search.opt_model, search.spr_round

    def opt(*a, **kw):
        t0 = time.perf_counter()
        out = real[0](*a, **kw)
        calls.append(("opt_model", (time.perf_counter() - t0) * 1e3, None))
        return out

    def round_(*a, **kw):
        stats = {}
        t0 = time.perf_counter()
        out = real[1](*a, stats=stats, **kw)
        calls.append(("spr_round", (time.perf_counter() - t0) * 1e3, stats))
        return out

    search.opt_model, search.spr_round = opt, round_
    try:
        yield calls
    finally:
        search.opt_model, search.spr_round = real


def checkpoint_partition_arrays(path: str, idx: int = 0) -> dict:
    """The arrays of partition ``idx`` as the checkpoint file holds them
    (numpy, read from the block itself)."""
    with binary.BinaryFile.open(path) as f:
        _, _, _, data = f._load_block(2 + idx, binary.BLOCK_PARTITION)
    return binary.binary._unpack_arrays(data)


def run_search(gpu, profile: bool):
    """Phase 8: the search cell (``flagship.search_cell``: 246 taxa ×
    4465 sites simulated along a random tree, GTR+Γ4, float32,
    compressed): a native parsimony start; ``ml_search`` with the probe's
    settings (SEARCH_KW), checkpointed after every round, path
    ``ml_search``; a resume from the checkpoint after round RESUME_AFTER
    into a fresh TreeInfo on the start, path ``ml_search_resume``; the
    CLI's ``search`` on a CLI_SEARCH_TAXA-taxon slice at its default
    device, path ``cli_search``. Checks: no round below the best before
    it less MONOTONE_SLACK, the end above the start and within LOGL_RTOL
    of float64, the final tree binary and connected; the resumed run's
    first rounds equal the full run's, its next round has the full run's
    mode and radius, its end at or above that round's less RESUME_SLACK
    and within LOGL_RTOL of float64; a checkpoint loaded onto the card
    holds the file's arrays bit for bit. Returns the phase's row."""
    from pllmod_tpu_torch import native
    from pllmod_tpu_torch.tree import starting
    os.makedirs(SEARCH_DIR, exist_ok=True)
    t0 = time.perf_counter()
    seqs, labels, truth = flagship.search_cell(**SEARCH_CELL)
    sim_ms = (time.perf_counter() - t0) * 1e3
    if not native.available():
        raise AssertionError("the port's native library did not load: the "
                             "parsimony start would take its Python path")
    t0 = time.perf_counter()
    start, pscore = starting.parsimony_stepwise(
        labels, seqs, charmap.DNA, seed=SEARCH_PARSIMONY_SEED)
    pars_ms = (time.perf_counter() - t0) * 1e3
    rf_start = splits.rf_distance(start, truth)
    part = create_partition(seqs, states=4, n_rate_cats=4,
                            alpha=SEARCH_ALPHA0, device="cuda")
    print(f"search 246: simulated {len(seqs)} x {len(seqs[0])} in "
          f"{sim_ms:.1f} ms ({part.n_patterns} patterns, "
          f"{part.n_patterns_padded} padded); parsimony start score "
          f"{pscore} in {pars_ms:.1f} ms (native), RF {rf_start} to the "
          f"simulating tree")
    ck = os.path.join(SEARCH_DIR, "search.ck")
    ck_resume = os.path.join(SEARCH_DIR, f"round{RESUME_AFTER}.ck")
    ck_side = os.path.join(SEARCH_DIR, "side.ck")
    rounds, calls = [], []
    clock = {}

    def on_round(rec):
        now = time.perf_counter()
        row = dict(mode=rec.mode, radius=rec.radius, applied=rec.n_applied,
                   lnl=rec.loglh, host_ms=(now - clock["prev"]) * 1e3,
                   checkpoint_bytes=os.path.getsize(ck))
        if len(rounds) + 1 == RESUME_AFTER:
            shutil.copy(ck, ck_resume)
        # one save_treeinfo of the same state, timed beside the search
        t0 = time.perf_counter()
        binary.save_treeinfo(ck_side, clock["ti"])
        row["checkpoint_ms"] = (time.perf_counter() - t0) * 1e3
        rounds.append(row)
        print(f"search 246 round {len(rounds)}: {json.dumps(row)}")
        clock["prev"] = time.perf_counter()

    def full_search():
        ti = clock["ti"] = TreeInfo(start.copy(), [part],
                                    params_to_optimize=SEARCH_MASK)
        clock["start"] = clock["prev"] = time.perf_counter()
        with search_stages(calls):
            res = search.ml_search(ti, checkpoint_path=ck,
                                   on_round=on_round, **SEARCH_KW)
        clock["end"] = time.perf_counter()
        return ti, res

    mem = reset_peak_memory()
    (ti, res), got = counted("search 246", "ml_search", full_search,
                             must=SPR_MUST)
    peak = torch.cuda.max_memory_allocated() / 2**30
    host_ms = (clock["end"] - clock["start"]) * 1e3
    best, viol = res.start_loglh, 0
    for r in res.rounds:
        viol += r.loglh < best - MONOTONE_SLACK
        best = max(best, r.loglh)
    tree = ti.tree
    want = f64_treeinfo_lnl(ti)
    opt_ms = [ms for name, ms, _ in calls if name == "opt_model"]
    spr_calls = [(ms, st) for name, ms, st in calls if name == "spr_round"]
    ck_ms = sum(r["checkpoint_ms"] for r in rounds)
    for r, (ms, st) in zip(rounds, spr_calls):
        r.update(spr_ms=ms, candidates=st["candidates"],
                 batches=st["batches"], max_batch=st["max_batch"])
    row = dict(
        cell="search 246", taxa=len(seqs), sites=len(seqs[0]),
        patterns=part.n_patterns, settings=SEARCH_KW, alpha0=SEARCH_ALPHA0,
        parsimony_score=pscore, parsimony_ms=pars_ms, simulate_ms=sim_ms,
        rounds=rounds, n_rounds=res.n_rounds, start_lnl=res.start_loglh,
        lnl=res.loglh, f64_lnl=want, rel_to_f64=abs(res.loglh - want)
        / abs(want), monotone_violations=viol, rf_start=rf_start,
        rf_end=splits.rf_distance(tree, truth), host_ms=host_ms,
        host_ms_by_stage=dict(
            parsimony=pars_ms, opening_opt_model=opt_ms[0],
            spr_rounds=sum(ms for ms, _ in spr_calls),
            interleaved_opt_model=sum(opt_ms[1:-1]),
            final_opt_model=opt_ms[-1],
            checkpoint_writes_timed_beside=ck_ms),
        opt_model_calls=len(opt_ms),
        alpha=float(ti.partitions[0].alpha),
        launches={k: n for k, n in got.items() if n},
        start_gib=mem, peak_gib=peak, peak_less_start_gib=peak - mem,
        gpu=gpu)
    summary = {k: v for k, v in row.items() if k != "rounds"}
    print(f"search 246: {json.dumps(summary)}")
    if viol or not res.loglh > res.start_loglh:
        raise AssertionError(f"search 246: {viol} rounds below the best "
                             f"before them, or the end {res.loglh} not "
                             f"above the start {res.start_loglh}")
    rel_close(res.loglh, want, LOGL_RTOL, "search 246 vs float64")
    if not (tree.is_binary() and tree.check_integrity()):
        raise AssertionError("search 246: the final tree is not binary "
                             "and connected")

    # ---- a yardstick for the search's end: the simulating tree, its
    # own lengths and the starting model through the same opt_model
    def on_truth():
        ti_t = TreeInfo(truth.copy(), [part], params_to_optimize=SEARCH_MASK)
        lnl0 = ti_t.compute_loglh()
        t0 = time.perf_counter()
        lnl = opt_model.opt_model(ti_t, tol=1e-3)
        return (lnl0, lnl, float(ti_t.partitions[0].alpha),
                float(ti_t.tree.lengths.sum()),
                (time.perf_counter() - t0) * 1e3)
    (l0, lt, at, sum_t, ms_t), _ = counted("search 246", "opt_model_truth",
                                           on_truth)
    row["simulating_tree"] = dict(
        start_lnl=l0, lnl=lt, alpha=at, length_sum=sum_t,
        search_length_sum=float(tree.lengths.sum()),
        truth_length_sum=float(truth.lengths.sum()), host_ms=ms_t)
    print(f"search 246, the simulating tree through opt_model: "
          f"{json.dumps(row['simulating_tree'])}")

    # ---- the checkpoint after round RESUME_AFTER: loaded onto the card,
    # then resumed into a fresh TreeInfo on the start
    on_card, _ = binary.load_treeinfo(ck_resume)
    held = checkpoint_partition_arrays(ck_resume)
    for f in convert.ARRAY_FIELDS:
        t = getattr(on_card.partitions[0], f)
        if not (t.is_cuda and np.array_equal(t.cpu().numpy(), held[f])
                and t.cpu().numpy().dtype == held[f].dtype):
            raise AssertionError(f"checkpoint loaded onto the card: {f} "
                                 "differs from the file")
    del on_card

    def resumed():
        ti2 = TreeInfo(start.copy(), [part], params_to_optimize=SEARCH_MASK)
        t0 = time.perf_counter()
        r2 = search.ml_search(ti2, checkpoint_path=ck_resume, resume=True,
                              **dict(SEARCH_KW, max_rounds=RESUME_AFTER + 1))
        return ti2, r2, (time.perf_counter() - t0) * 1e3
    (ti2, res2, resume_ms), got2 = counted("search 246", "ml_search_resume",
                                           resumed, must=SPR_MUST)
    want2 = f64_treeinfo_lnl(ti2)
    nxt = res.rounds[RESUME_AFTER]
    resume = dict(rounds=[dataclasses.asdict(r) for r in res2.rounds],
                  lnl=res2.loglh, f64_lnl=want2,
                  rel_to_f64=abs(res2.loglh - want2) / abs(want2),
                  full_run_round=dataclasses.asdict(nxt), host_ms=resume_ms,
                  launches={k: n for k, n in got2.items() if n})
    print(f"search 246, resumed after round {RESUME_AFTER}: "
          f"{json.dumps(resume)}")
    if not (res2.rounds[:RESUME_AFTER] == res.rounds[:RESUME_AFTER]
            and res2.n_rounds == RESUME_AFTER + 1
            and (res2.rounds[-1].mode, res2.rounds[-1].radius)
            == (nxt.mode, nxt.radius)
            and res2.loglh >= nxt.loglh - RESUME_SLACK):
        raise AssertionError("search 246: the resumed run lost its history "
                             "or ended below the full run's round "
                             f"{RESUME_AFTER + 1}")
    rel_close(res2.loglh, want2, LOGL_RTOL, "resumed search vs float64")
    row["resume"] = resume
    del ti2

    # ---- the CLI's search on a slice of the cell, at its default device
    fasta = os.path.join(SEARCH_DIR, "slice.fasta")
    msa_io.write_fasta(MSA(labels[:CLI_SEARCH_TAXA], seqs[:CLI_SEARCH_TAXA]),
                       fasta)
    args = cli.parse_args(["search", "--msa", fasta] + CLI_SEARCH_ARGS)

    def cli_search():
        t0 = time.perf_counter()
        out = args.fn(args)
        return out, (time.perf_counter() - t0) * 1e3
    (out, cli_ms), got3 = counted("search 246", "cli_search", cli_search,
                                  must=CLI_SEARCH_MUST)
    cres, cti = out["result"], out["treeinfo"]
    want3 = f64_treeinfo_lnl(cti)
    row["cli"] = dict(argv=["search", "--msa", "slice.fasta"]
                      + CLI_SEARCH_ARGS, taxa=CLI_SEARCH_TAXA,
                      device=str(cti.partitions[0].device),
                      n_rounds=cres.n_rounds, start_lnl=cres.start_loglh,
                      lnl=cres.loglh, f64_lnl=want3,
                      rel_to_f64=abs(cres.loglh - want3) / abs(want3),
                      host_ms=cli_ms,
                      launches={k: n for k, n in got3.items() if n})
    print(f"search 246, the CLI's search: {json.dumps(row['cli'])}")
    if not (cti.partitions[0].device.type == "cuda"
            and cres.loglh > cres.start_loglh):
        raise AssertionError("the CLI's search did not run on the card or "
                             "did not improve its start")
    rel_close(cres.loglh, want3, LOGL_RTOL, "the CLI's search vs float64")
    del ti, cti
    torch.cuda.empty_cache()
    if profile:
        row["profile"] = profile_window(
            "search 246, opening opt_model and 2 rounds",
            lambda: search.ml_search(
                TreeInfo(start.copy(), [part],
                         params_to_optimize=SEARCH_MASK),
                **dict(SEARCH_KW, max_rounds=2)), 1)
    return row


# ---------------------------------------------------------------------------
# phase 9: the site mesh (parallel/, multichip.py)
# ---------------------------------------------------------------------------
MESH_SHARDS_ONE_CARD = 4  # shards on cuda:0 where the machine has one card
MESH_TIMED_LOGLH = 20     # compute_loglh calls timed a mesh
MESH_SPR = dict(radius_min=1, radius_max=5)
MESH_DP_PARTS = 4         # the flagship alignment as 4096-site partitions
MESH_OPT_MASK = (PARAM_SUBST_RATES | PARAM_FREQUENCIES | PARAM_ALPHA
                 | PARAM_BRANCHES_ITERATIVE)
MESH_SEARCH_KW = dict(radius_min=1, radius_step=5, radius_max=5)
MESH_SEARCH_ROUNDS = 2    # the sharded search's rounds; its resume one more
# the kernels each mesh path must launch, on every shard (their launches
# a multiple of the shard count); kernel 10 must not launch under a mesh
MESH_MUST = {
    "compute_loglh": ("resident_walk",),
    "compute_loglh_incremental": ("fused_walk",),
    "fused_sharded": ("fused_walk",),
    "resident_sharded": ("resident_walk",),
    "blo": ("fused_walk", "edge_sumtables", "edge_derivatives"),
    "opt_model": ("resident_walk", "fused_walk", "edge_sumtables",
                  "edge_derivatives"),
    "spr_fast": ("resident_walk", "fused_walk", "edge_sumtables",
                 "edge_derivatives"),
    "partition_dp": ("resident_walk",),
    "partition_dp_2d": ("resident_walk",),
    "ml_search": ("resident_walk", "fused_walk", "edge_sumtables",
                  "edge_derivatives"),
    "ml_search_resume": ("resident_walk", "fused_walk", "edge_sumtables",
                         "edge_derivatives"),
}
PER_SHARD = ("resident_walk", "fused_walk", "edge_sumtables",
             "edge_derivatives")


def sync_all(mesh) -> None:
    for dev in dict.fromkeys(mesh.device_list):
        torch.cuda.synchronize(dev)


def mesh_counted(cell: str, what: str, mesh, fn):
    """``fn()`` counted under path ``mesh`` (:func:`counted`): the kernels
    of MESH_MUST[what] launched a multiple of the mesh's shard count
    times, kernel 10 never. Returns (fn's result, host ms, the
    counts)."""
    def run():
        sync_all(mesh)
        t0 = time.perf_counter()
        out = fn()
        sync_all(mesh)
        return out, (time.perf_counter() - t0) * 1e3
    (out, ms), got = counted(cell, "mesh", run, must=MESH_MUST[what])
    n = mesh.size
    odd = {k: got[k] for k in PER_SHARD if got[k] % n}
    if odd or got["newton_edges"] or got["newton_edges_multi"]:
        raise AssertionError(
            f"{what} ({cell}): launches not on every one of {n} shards "
            f"{odd} or kernel 10 under the mesh {got}")
    return out, ms, {k: v for k, v in got.items() if v}


def mesh_devices():
    """The meshes phase 9 runs: MESH_SHARDS_ONE_CARD shards on cuda:0,
    and on a machine with several cards one shard a card as well (the
    largest power of two of them that divides the flagship's 16384
    patterns)."""
    cards = torch.cuda.device_count()
    meshes = [(f"{MESH_SHARDS_ONE_CARD} shards on cuda:0",
               ["cuda:0"] * MESH_SHARDS_ONE_CARD)]
    if cards > 1:
        k = 1 << (cards.bit_length() - 1)
        meshes.append((f"{k} cards", [f"cuda:{i}" for i in range(k)]))
    return meshes


def mesh_timings(label, mesh, part, tree, spr_cell, row, profile: bool):
    """One shard against the mesh: ms (CUDA events on the first device
    and the host clock, every device synchronised) of a compute_loglh
    on a one-shard mesh of the first device and on ``mesh``; of a
    treeinfo BLO call and a fast SPR round on the one-shard mesh, beside
    the mesh's own from its checked runs (``row``). ``--profile`` adds
    each path's device busy share (torch.profiler, kernel time summed
    over the devices) over its window, for both meshes. ``spr_cell``:
    phase 7's (partition, perturbed start tree)."""
    from pllmod_tpu_torch.parallel import make_mesh, shard_treeinfo
    spart, spr_start = spr_cell
    one = make_mesh(mesh.device_list[:1])
    rows = {}
    for tag, m in (("1 shard", one), (label, mesh)):
        ti = shard_treeinfo(TreeInfo(tree.copy(), [part]), m)
        ti.compute_loglh()
        sync_all(m)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(MESH_TIMED_LOGLH):
            ti.compute_loglh()
        ev1.record()
        sync_all(m)
        host = (time.perf_counter() - t0) * 1e3 / MESH_TIMED_LOGLH
        out = dict(shards=m.size, compute_loglh_ms=ev0.elapsed_time(ev1)
                   / MESH_TIMED_LOGLH, compute_loglh_host_ms=host)
        if m is one:
            ti = shard_treeinfo(TreeInfo(tree.copy(), [part]), m)
            _, out["blo_ms"], out["blo_launches"] = mesh_counted(
                f"flagship DNA, {tag}", "blo", m,
                lambda ti=ti: blo.optimize_branch_lengths_treeinfo(ti))
            ti = shard_treeinfo(TreeInfo(spr_start.copy(), [spart]), m)
            res, out["spr_fast_ms"], out["spr_launches"] = mesh_counted(
                f"flagship SPR, {tag}", "spr_fast", m,
                lambda ti=ti: spr.spr_round(ti, **MESH_SPR))
            out["spr_applied"] = res[1]
        else:
            out.update({k: row[k] for k in (
                "blo_ms", "blo_launches", "spr_fast_ms", "spr_launches")},
                spr_applied=row["spr_fast"]["applied"])
        if profile:
            ti = shard_treeinfo(TreeInfo(tree.copy(), [part]), m)
            out["profile_compute_loglh"] = profile_window(
                f"mesh compute_loglh, {tag}",
                lambda ti=ti: [ti.compute_loglh()
                               for _ in range(MESH_TIMED_LOGLH)],
                MESH_TIMED_LOGLH)
            out["profile_blo"] = profile_window(
                f"mesh BLO, {tag}",
                lambda: blo.optimize_branch_lengths_treeinfo(
                    shard_treeinfo(TreeInfo(tree.copy(), [part]), m)), 1)
            out["profile_spr_fast"] = profile_window(
                f"mesh fast SPR round, {tag}", lambda: spr.spr_round(
                    shard_treeinfo(TreeInfo(spr_start.copy(), [spart]), m),
                    **MESH_SPR), 1)
        print(f"mesh timings ({tag}): {json.dumps(out)}")
        rows[tag] = out
    return rows


def run_mesh(gpu, profile: bool):
    """Phase 9: the site mesh (``pllmod_tpu_torch/parallel``) on every
    card: MESH_SHARDS_ONE_CARD shards on cuda:0, and with several cards
    one shard a card as well (:func:`mesh_devices`). At the flagship's
    full width (128 × 16384 GTR+Γ4 float32), each run counted under path
    ``mesh`` (:func:`mesh_counted`: kernels 1, 2, 8 and 9 on every shard,
    kernel 10 never) and held within LOGL_RTOL of the float64 serial
    engine: ``compute_loglh`` full and incremental, the fused and
    resident sharded evaluations, the treeinfo BLO (at or above its
    start), ``opt_model`` GTR+G4 on phase 6's simulated alignment, one
    fast ``spr_round`` (radius 1-5) on phase 7's cell (at or above its
    start); the partition DP of the flagship alignment as four 4096-site
    partitions on the 1-D and the 2 × 2 mesh; at small width
    ``ml_search`` (two rounds, checkpointed) and its resume on phase 8's
    32-taxon cell; ``multichip.dryrun_multichip``; and one shard against
    the mesh for the evaluation, the BLO call and the SPR round
    (:func:`mesh_timings`). Returns the phase's row."""
    from pllmod_tpu_torch import multichip
    from pllmod_tpu_torch.parallel import (loglikelihood_fused_sharded,
                                           loglikelihood_resident_sharded,
                                           make_2d_mesh, make_mesh,
                                           shard_treeinfo, stack_partitions,
                                           total_loglh_partition_dp,
                                           total_loglh_partition_dp_2d)
    from pllmod_tpu_torch.tree import starting
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    meshes = mesh_devices()
    print(f"mesh: {json.dumps({lbl: devs for lbl, devs in meshes})}, "
          f"{cards} card(s), {gpu}")
    part, tree = flagship.example(**FLAGSHIP, device="cuda")
    part = part.cache_eigen()
    part64 = f64_copy(part)
    ops, ri = tree.traversal_ops()
    brl64 = torch.as_tensor(tree.lengths, dtype=torch.float64, device="cuda")
    want = float(engine.loglikelihood(part64, ops, brl64, ri))
    sim_part, spr_start = flagship.simulated(**FLAGSHIP, sim_seed=SIM_SEED,
                                             device="cuda")
    sim_part = sim_part.cache_eigen()
    flagship.random_spr(spr_start, SPR_PERTURB,
                        np.random.default_rng(SPR_PERTURB_SEED))
    spr_cell = (sim_part, spr_start)
    out = dict(cards=cards, gpu=gpu)
    for label, devs in meshes:
        mesh = make_mesh(devs)
        n = mesh.size
        row = dict(devices=devs)
        cell = f"flagship DNA, {label}"
        # compute_loglh, full then incremental after one changed length
        ti = shard_treeinfo(TreeInfo(tree.copy(), [part]), mesh)
        lnl, row["compute_loglh_ms"], row["compute_loglh_launches"] = \
            mesh_counted(cell, "compute_loglh", mesh, ti.compute_loglh)
        rel_close(lnl, want, LOGL_RTOL, f"mesh compute_loglh ({label})")
        ti.compute_loglh(incremental=True)
        edge = int(np.nonzero(tree.edge_nodes[:, 0] >= 0)[0][5])
        ti.set_branch_length(edge, float(ti.tree.lengths[edge]) * 1.5)
        inc, _, row["incremental_launches"] = mesh_counted(
            cell, "compute_loglh_incremental", mesh,
            lambda ti=ti: ti.compute_loglh(incremental=True))
        brl_inc = torch.as_tensor(ti.tree.lengths, dtype=torch.float64,
                                  device="cuda")
        rel_close(inc, float(engine.loglikelihood(part64, ops, brl_inc, ri)),
                  LOGL_RTOL, f"mesh incremental compute_loglh ({label})")
        for what, fn in (("fused_sharded", loglikelihood_fused_sharded),
                         ("resident_sharded",
                          loglikelihood_resident_sharded)):
            got, row[f"{what}_ms"], _ = mesh_counted(
                cell, what, mesh, lambda fn=fn: float(fn(part, tree,
                                                         tree.lengths, mesh)))
            rel_close(got, want, LOGL_RTOL, f"mesh {what} ({label})")
        # the treeinfo BLO
        ti = shard_treeinfo(TreeInfo(tree.copy(), [part]), mesh)
        start = ti.compute_loglh()
        stats = {}
        lnl, row["blo_ms"], row["blo_launches"] = mesh_counted(
            cell, "blo", mesh,
            lambda ti=ti: blo.optimize_branch_lengths_treeinfo(ti,
                                                                stats=stats))
        if not lnl >= start:
            raise AssertionError(f"mesh BLO ({label}) ended below its "
                                 f"start: {lnl} < {start}")
        rel_close(lnl, f64_treeinfo_lnl(ti), LOGL_RTOL,
                  f"mesh BLO ({label}) vs float64")
        row["blo"] = dict(start=start, lnl=lnl, **stats)
        # opt_model GTR+G4 on phase 6's simulated alignment
        msa = msa_io.load_msa(os.path.join(OPT_DIR, "flagship.fasta"))
        with open(os.path.join(OPT_DIR, "flagship.nwk")) as fh:
            otree = Tree.from_newick(fh.read())
        cli._order_tree_tips(otree, msa)
        opart, _, omask = cli.build_partition(msa, "GTR+G4", device="cuda")
        ti = shard_treeinfo(TreeInfo(otree, [opart],
                                     params_to_optimize=omask), mesh)
        ostart = ti.compute_loglh()
        ostats = {}
        lnl, row["opt_model_ms"], row["opt_model_launches"] = mesh_counted(
            f"flagship opt_model, {label}", "opt_model", mesh,
            lambda ti=ti: opt_model.opt_model(ti, stats=ostats))
        if not lnl >= ostart:
            raise AssertionError(f"mesh opt_model ({label}) ended below its "
                                 f"start: {lnl} < {ostart}")
        rel_close(lnl, f64_treeinfo_lnl(ti), LOGL_RTOL,
                  f"mesh opt_model ({label}) vs float64")
        row["opt_model"] = dict(start=ostart, lnl=lnl, stats=ostats)
        del ti, opart
        # one fast SPR round on phase 7's cell
        ti = shard_treeinfo(TreeInfo(spr_start.copy(), [sim_part]), mesh)
        sstart = ti.compute_loglh()
        sstats = {}
        (lnl, applied, _), row["spr_fast_ms"], row["spr_launches"] = \
            mesh_counted(f"flagship SPR, {label}", "spr_fast", mesh,
                         lambda ti=ti: spr.spr_round(ti, stats=sstats,
                                                     **MESH_SPR))
        if not (lnl >= sstart and ti.tree.is_binary()
                and ti.tree.check_integrity()):
            raise AssertionError(f"mesh SPR round ({label}) ended below its "
                                 f"start ({lnl} < {sstart}) or broke the "
                                 "tree")
        rel_close(lnl, f64_treeinfo_lnl(ti), LOGL_RTOL,
                  f"mesh SPR round ({label}) vs float64")
        row["spr_fast"] = dict(start=sstart, lnl=lnl, applied=applied,
                               **sstats)
        del ti
        # partition DP: the flagship alignment as 4096-site partitions
        # (as many as the mesh has devices, where that is more)
        seqs, _, rates, freqs = flagship.example_data(**FLAGSHIP)
        n_dp = max(MESH_DP_PARTS, n)
        w = FLAGSHIP["n_sites"] // n_dp
        dparts = [create_partition(
            [s[k * w:(k + 1) * w] for s in seqs], states=4,
            subst_rates=rates, freqs=freqs, alpha=0.75, compress=False,
            device="cuda") for k in range(n_dp)]
        dwant = sum(float(engine.loglikelihood(f64_copy(p), ops, brl64, ri))
                    for p in dparts)
        stacked = stack_partitions(dparts)
        dbrl = torch.stack([torch.as_tensor(tree.lengths, dtype=torch.float32,
                                            device="cuda")] * n_dp)
        dp_mesh = make_mesh(devs, axis_name="parts")
        got, row["partition_dp_ms"], _ = mesh_counted(
            cell, "partition_dp", dp_mesh, lambda: float(
                total_loglh_partition_dp(stacked, ops, dbrl, ri, dp_mesh)))
        rel_close(got, dwant, LOGL_RTOL, f"mesh partition DP ({label})")
        if n % 2 == 0:
            m2 = make_2d_mesh((2, n // 2), devs)
            got, row["partition_dp_2d_ms"], _ = mesh_counted(
                cell, "partition_dp_2d", m2, lambda: float(
                    total_loglh_partition_dp_2d(stacked, ops, dbrl, ri, m2)))
            rel_close(got, dwant, LOGL_RTOL,
                      f"mesh 2-D partition DP ({label})")
        del stacked, dparts
        # ml_search and its resume on phase 8's 32-taxon cell
        sseqs, slabels, _ = flagship.search_cell(**SEARCH_CELL)
        sseqs, slabels = sseqs[:CLI_SEARCH_TAXA], slabels[:CLI_SEARCH_TAXA]
        sstart_tree, _ = starting.parsimony_stepwise(
            slabels, sseqs, charmap.DNA, seed=SEARCH_PARSIMONY_SEED)
        spart = create_partition(sseqs, states=4, alpha=SEARCH_ALPHA0,
                                 pattern_pad=128 * n, device="cuda")
        os.makedirs(SEARCH_DIR, exist_ok=True)
        ck = os.path.join(SEARCH_DIR, f"mesh{n}.ck")
        if os.path.exists(ck):
            os.remove(ck)

        def sharded_ti():
            return shard_treeinfo(TreeInfo(sstart_tree.copy(), [spart],
                                           params_to_optimize=SEARCH_MASK),
                                  mesh)
        ti = sharded_ti()
        res, row["ml_search_ms"], _ = mesh_counted(
            f"search 32, {label}", "ml_search", mesh,
            lambda ti=ti: search.ml_search(
                ti, checkpoint_path=ck, max_rounds=MESH_SEARCH_ROUNDS,
                **MESH_SEARCH_KW))
        rel_close(res.loglh, f64_treeinfo_lnl(ti), LOGL_RTOL,
                  f"mesh ml_search ({label}) vs float64")
        ti2 = sharded_ti()
        res2, row["ml_search_resume_ms"], _ = mesh_counted(
            f"search 32, {label}", "ml_search_resume", mesh,
            lambda: search.ml_search(
                ti2, checkpoint_path=ck, resume=True,
                max_rounds=MESH_SEARCH_ROUNDS + 1, **MESH_SEARCH_KW))
        kept = [(r.mode, r.radius, r.loglh) for r in res2.rounds[:len(
            res.rounds)]]
        if (kept != [(r.mode, r.radius, r.loglh) for r in res.rounds]
                or not all(p.device.type == "cuda" and len(p.shards) == n
                           for p in ti2.partitions)):
            raise AssertionError(f"mesh resume ({label}) lost its history "
                                 "or its shards")
        rel_close(res2.loglh, f64_treeinfo_lnl(ti2), LOGL_RTOL,
                  f"mesh ml_search resume ({label}) vs float64")
        row["ml_search"] = dict(
            start=res.start_loglh, lnl=res.loglh, rounds=res.n_rounds,
            resume_lnl=res2.loglh, resume_rounds=res2.n_rounds)
        del ti, ti2, spart
        # the dry run, then one shard against n for the timed paths
        (row["dryrun"], row["dryrun_ms"]), _ = counted(
            f"dryrun, {label}", "mesh_dryrun",
            lambda: timed_host(lambda: multichip.dryrun_multichip(n, devs)))
        torch.cuda.empty_cache()
        row["timings"] = mesh_timings(label, mesh, part, tree, spr_cell,
                                      row, profile)
        print(f"mesh ({label}): {json.dumps(row)}")
        out[label] = row
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: the capacity mode (10,000 taxa × 100,000 sites), the chunked
# BLO at the flagship width, the example drivers
# ---------------------------------------------------------------------------
CAPACITY = dict(n_taxa=10_000, n_sites=100_000, seed=3)
CAPACITY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "capacity")
CAPACITY_EVALS = 10       # auto evaluations timed, at varied lengths
CAPACITY_KERNEL_ITERS = 5  # launches timed a capacity-shape kernel
CAPACITY_MUST = {
    "auto": ("resident_walk",),
    "bounded_fused": ("fused_walk",),
    "blo_bounded": ("fused_walk", "edge_sumtables", "newton_edges")}
CHUNKED_WINDOW = 16
# chunked vs full driver, on float64 evaluations at each call's lengths:
# the JAX package's test bar (tests/test_bounded_slots.py:72-73)
CHUNKED_BELOW, CHUNKED_ABS = 1e-3, 0.05
CHUNKED_MUST = ("fused_walk", "edge_sumtables", "newton_edges")
# each demo's main(["--device", "cuda"]) and what its output must hold
# (tests/test_examples_smoke.py's strings, and the same for the two
# demos it does not run)
EXAMPLES = {
    "consensus_demo": ("splits kept",),
    "rf_distance_demo": ("max RF",),
    "genotype_demo": ("optimized logL",),
    "ml_search_demo": ("parsimony starting tree", "search:", "final tree:"),
    "protein_mixture_demo": ("37 models", "bounded"),
    "constrained_search_demo": ("constraint satisfied: True",),
    "partitioned_demo": ("optimized logL", "RF(ML, consensus) ="),
    "spr_round": ("SPR round 1:", "final tree:"),
}


def write_capacity_cell(out_dir: str) -> None:
    """Build the capacity cell on the host: simulate it
    (``flagship.capacity_cell`` at CAPACITY) and run ``create_partition``
    on its sequences with ``device="cpu"`` (host seconds by step), and
    write it into ``out_dir``: the tree (``tree.npz``), the partition's
    arrays (one ``.npy`` a field of ``convert.ARRAY_FIELDS``) and the
    seconds and the partition's static fields (``cell.json``, written
    last)."""
    t0 = time.perf_counter()
    seqs, _, tree = flagship.capacity_cell(**CAPACITY)
    host = dict(simulate_s=time.perf_counter() - t0)
    steps = {}
    t0 = time.perf_counter()
    part = create_partition(
        seqs, states=4, n_rate_cats=4, alpha=flagship.CAPACITY_ALPHA,
        subst_rates=flagship.CAPACITY_RATES, freqs=flagship.CAPACITY_FREQS,
        device="cpu", timings=steps)
    host["create_partition"] = dict(steps, total_s=time.perf_counter() - t0)
    del seqs
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "tree.npz"), edge_nodes=tree.edge_nodes,
             lengths=tree.lengths, n_nodes=tree.n_nodes)
    for f in convert.ARRAY_FIELDS:
        np.save(os.path.join(out_dir, f"{f}.npy"), getattr(part, f).numpy())
    host["write_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "cell.json"), "w") as fh:
        json.dump(dict(host=host, meta={f: getattr(part, f)
                                        for f in convert.META_FIELDS}), fh)


def start_capacity_cell():
    """Start :func:`write_capacity_cell` into CAPACITY_DIR in a process of
    its own: host work only, which runs beside phases 1-9 (one CPU core
    of the card's host); returns the process."""
    shutil.rmtree(CAPACITY_DIR, ignore_errors=True)
    code = ("import chip_smoke; "
            f"chip_smoke.write_capacity_cell({CAPACITY_DIR!r})")
    return subprocess.Popen(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load_capacity_cell(proc=None):
    """(partition on the card, tree, host seconds by step): the cell of
    the process of :func:`start_capacity_cell` when given, else built
    here (:func:`write_capacity_cell`); then its arrays read back
    (``load_s``) and copied onto the card (``card_upload_s``)."""
    if proc is None:
        write_capacity_cell(CAPACITY_DIR)
    else:
        out, err = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"the capacity cell's build failed:\n"
                               f"{err[-4000:]}")
    with open(os.path.join(CAPACITY_DIR, "cell.json")) as fh:
        cell = json.load(fh)
    host = dict(cell["host"], built_beside_phases=proc is not None)
    t0 = time.perf_counter()
    arrays = {f: np.load(os.path.join(CAPACITY_DIR, f"{f}.npy"))
              for f in convert.ARRAY_FIELDS}
    t = np.load(os.path.join(CAPACITY_DIR, "tree.npz"))
    host["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = convert.partition_from_arrays(arrays, cell["meta"], "cuda")
    torch.cuda.synchronize()
    host["card_upload_s"] = time.perf_counter() - t0
    n = CAPACITY["n_taxa"]
    tree = Tree(n, [f"t{i}" for i in range(n)], t["edge_nodes"],
                t["lengths"], n_nodes=int(t["n_nodes"]))
    return part, tree, host


def trace_top(logdir: str, n: int = 10) -> dict:
    """The device kernels of the Chrome traces ``profile.trace`` wrote
    into ``logdir``: total device ms, and the ``n`` largest by device
    ms with their launches."""
    per: dict = {}
    for path in os.listdir(logdir):
        with open(os.path.join(logdir, path)) as fh:
            events = json.load(fh)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                row = per.setdefault(e["name"][:90], [0.0, 0])
                row[0] += e.get("dur", 0) / 1e3
                row[1] += 1
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:n]
    return dict(device_ms=sum(v[0] for v in per.values()),
                top=[dict(name=k, ms=v[0], launches=v[1]) for k, v in top])


def capacity_kernel_rows(part, tree, brl) -> dict:
    """Kernels 1, 2, 8 and 10 at the capacity cell's shapes, each against
    its plain version on the same inputs (kernels 1, 2 and 8 bit for
    bit, kernel 10 to DERIV_RTOL), timed by CUDA events over
    CAPACITY_KERNEL_ITERS launches, with its bound: kernel 1 on the
    ``auto`` table, kernel 2 on the bounded evaluation's serial table,
    kernels 8 and 10 on the first emits of the bounded sweep's walk
    (its first segments walked, all emits of a segment). Returns (the
    rows by kernel, the host seconds of each table build)."""
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    tab = fused.code_table(part)
    rows = {}
    host = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        host[name] = time.perf_counter() - t0
        return out

    def held(name, kernel, plain):
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = kernel()
        torch.cuda.synchronize()
        return got, want, plain_ms

    # kernel 1: the auto evaluation's resident table
    idx8, e1, e2, ns = timed("compile_resident_s", lambda: resident.
                             compile_resident(part, tree))
    P5 = fused.pair_pmats(part, brl, e1, e2, root_row=True)
    args = (idx8, P5, part.tip_states, tab, ns)
    (prod_k, sc_k), (prod_p, sc_p), plain_ms = held(
        "resident", lambda: resident.resident_walk(*args),
        lambda: resident.resident_walk_plain(*args))
    if not (torch.equal(prod_k, prod_p) and torch.equal(sc_k, sc_p)):
        raise AssertionError("resident walk (capacity) differs from its "
                             "plain version")
    b_ms, b_by = bound(nbytes(idx8, P5, part.tip_states, tab, prod_k, sc_k),
                       walk_flops(idx8, C, S, Ppad, tab.shape[0]))
    rows["resident_walk"] = dict(
        ms=time_ms(lambda: resident.resident_walk(*args),
                   CAPACITY_KERNEL_ITERS),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        rows=len(idx8), slots=ns)
    del prod_k, prod_p, P5

    # kernel 2: the bounded evaluation's serial table (its root row last)
    ops, (u, v, e) = timed("traversal_ops_s", tree.traversal_ops)
    ops_b, _, slot_map = timed("bounded_slot_ops_s", lambda: clv.
                               bounded_slot_ops(ops, part.n_tips,
                                                root_refs=(u, v)))

    def remap(x):
        return x if x < part.n_tips else part.n_tips + int(slot_map[
            x - part.n_tips])
    t8, f1, f2, nsf = timed("compile_fused_ops_serial_s", lambda: fused.
                            compile_fused_ops(part, ops_b, serial=True))
    t8, f1, f2, _ = fused.append_root_row(t8, f1, f2, part.n_tips, remap(u),
                                          remap(v), int(e), nsf)
    dev = part.device
    t8 = torch.as_tensor(t8, device=dev)
    f1 = torch.as_tensor(f1, device=dev).long()
    f2 = torch.as_tensor(f2, device=dev).long()
    P5 = fused.pair_pmats(part, brl, f1, f2, root_row=True)
    args = (t8, P5, part.tip_states, tab, nsf)
    (clv_k, sc_k), (clv_p, sc_p), plain_ms = held(
        "fused", lambda: fused.fused_walk(*args),
        lambda: fused.fused_walk_plain(*args))
    w = torch.unique(t8[:, 6].long())
    if not (torch.equal(clv_k[w], clv_p[w]) and torch.equal(sc_k[w],
                                                           sc_p[w])):
        raise AssertionError("fused walk (capacity, bounded table) differs "
                             "from its plain version")
    b_ms, b_by = bound(nbytes(t8, P5, part.tip_states, tab)
                       + written_bytes(t8, C, S, Ppad),
                       walk_flops(t8, C, S, Ppad, tab.shape[0]))
    rows["fused_walk"] = dict(
        ms=time_ms(lambda: fused.fused_walk(*args), CAPACITY_KERNEL_ITERS),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        rows=len(t8), slots=nsf)
    del clv_k, clv_p, P5

    # kernels 8 and 10: the bounded sweep's first segment with emits,
    # every emit of it
    sched = timed("bounded_sweep_schedule_s", lambda: blo_bounded.
                  BoundedSweepSchedule(tree))
    tables = timed("bounded_compile_tables_s", lambda: sched.
                   compile_tables(part))
    n_slots_k = tables[-1]
    plan = timed("bounded_pass_plan_s", lambda: blo_bounded._pass_plan(
        part, sched, tables, None, True))
    bufs = (torch.zeros((n_slots_k, C * S, Ppad), device=dev),
            torch.zeros((n_slots_k, 1, Ppad), dtype=torch.int32,
                        device=dev))
    for walk, emits in plan:
        if walk is not None:
            P5 = fused.pair_pmats(part, brl, walk[1], walk[2],
                                  root_row=False)
            fused.fused_walk(walk[0], P5, part.tip_states, tab, n_slots_k,
                             out=bufs)
        if emits is not None:
            break
    eref, eids = emits
    basis = deriv.sumtable_basis(part)
    sargs = (part, *bufs, eref, basis)
    (st, sc), (st_p, sc_p), plain_ms = held(
        "sumtables", lambda: deriv.edge_sumtables(*sargs),
        lambda: deriv.edge_sumtables_plain(*sargs))
    if not (torch.equal(st, st_p) and torch.equal(sc, sc_p)):
        raise AssertionError("edge_sumtables (capacity) differs from its "
                             "plain version")
    b_ms, b_by = sumtable_bound(part, eref, basis)
    rows["edge_sumtables"] = dict(
        ms=time_ms(lambda: deriv.edge_sumtables(*sargs),
                   CAPACITY_KERNEL_ITERS),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        edges=len(eref))
    del st_p, sc_p, bufs
    kw = dict(lw=deriv._lam_weight_rows(part),
              lnB=deriv.invar_log_plane(part))
    t = brl[eids]
    nargs = (part, st, sc, t, MIN_BRANCH_LEN, MAX_BRANCH_LEN,
             TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS)
    got, want, plain_ms = held(
        "newton", lambda: deriv.newton_edges(*nargs, **kw),
        lambda: deriv.newton_edges_plain(*nargs, **kw))
    errs = [_rel(got[0], want[0], 1e-4), _rel(got[1], want[1], 1e-2)]
    if errs[0] > DERIV_RTOL["t"] or errs[1] > DERIV_RTOL["lnl0"]:
        raise AssertionError(f"newton_edges (capacity) differs from its "
                             f"plain version: {errs}")
    iters = int(got[2].sum())
    CS = C * S
    b_ms, b_by = bound(nbytes(st, sc, t, kw["lw"], kw["lnB"]) + Ppad * 4
                       + 3 * len(t) * 4, iters * Ppad * (6 * CS + SITE_OPS))
    rows["newton_edges"] = dict(
        ms=time_ms(lambda: deriv.newton_edges(*nargs, **kw),
                   CAPACITY_KERNEL_ITERS),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(float((g - w).abs().max())
                        for g, w in zip(got[:2], want[:2])),
        max_rel_err=errs, edges=len(t), mean_iters=iters / len(t))
    for name, r in rows.items():
        print(f"{name} (capacity): {json.dumps(r)}")
    print(f"capacity host tables (s): {json.dumps(host)}")
    torch.cuda.empty_cache()
    return rows, host


def run_chunked(gpu) -> dict:
    """The chunked BLO at the flagship width on the simulated flagship
    alignment (``flagship.simulated``, phase 7's cell: tree-signal data,
    whose optimum the JAX test's bar is about), beside the full and the
    bounded drivers from the same start: each call's host ms, sweeps and
    logL, each logL against float64 at its lengths; the chunked one
    counted (path ``blo_chunked``) and, on float64 evaluations, at or
    above the full driver's less CHUNKED_BELOW and within CHUNKED_ABS
    of it; and one window's stacked kernel-2 table against its plain
    walk, bit for bit."""
    part, tree = flagship.simulated(**FLAGSHIP, sim_seed=SIM_SEED,
                                    device="cuda")
    part = part.cache_eigen()
    part64 = f64_copy(part).cache_eigen()
    ops, ri = tree.traversal_ops()

    def f64(tr):
        return float(engine.loglikelihood(
            part64, ops, torch.as_tensor(tr.lengths, device="cuda"), ri))
    row = dict(cell="flagship DNA, simulated", start_lnl=f64(tree))
    runs = (("full", lambda tr, st: blo.optimize_branch_lengths(
                part, tr, stats=st)),
            ("bounded", lambda tr, st: blo_bounded.
             optimize_branch_lengths_bounded(part, tr, stats=st)),
            ("chunked", lambda tr, st: blo.optimize_branch_lengths_chunked(
                part, tr, window=CHUNKED_WINDOW, stats=st)))
    for name, fn in runs:
        tr, stats = tree.copy(), {}
        if name == "chunked":
            (_, lnl), ms = counted(
                "flagship DNA, simulated", "blo_chunked",
                lambda: timed_host(lambda: fn(tr, stats)),
                must=CHUNKED_MUST)[0]
        else:
            (_, lnl), ms = timed_host(lambda: fn(tr, stats))
        l64 = f64(tr)
        rel_close(lnl, l64, LOGL_RTOL, f"{name} BLO (flagship, simulated) "
                  "vs float64")
        row[name] = dict(ms=ms, sweeps=stats["sweeps"], lnl=lnl, f64=l64,
                         **({"windows": stats["windows"]}
                            if name == "chunked" else {}))
    gap = row["chunked"]["f64"] - row["full"]["f64"]
    print(f"chunked BLO (flagship, simulated): {json.dumps(row)}; chunked "
          f"less full {gap!r} (float64)")
    if gap < -CHUNKED_BELOW or abs(gap) > CHUNKED_ABS:
        raise AssertionError(f"chunked BLO off the full driver by {gap}")
    row["chunked_less_full"] = gap

    # one window's stacked table: kernel 2 against its plain walk
    ops_w, refs_w, _, _, n_slots = blo.compile_chunked_blo(
        part, tree, CHUNKED_WINDOW)
    tabs = blo._window_tables(part, ops_w[0], refs_w[0], n_slots)
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32, device="cuda")
    P5 = fused.pair_pmats(part, brl, tabs.e1, tabs.e2, root_row=False)
    args = (tabs.idx8, P5, part.tip_states, tabs.codetab, tabs.n_slots)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    outs = {}
    for name, walk in (("kernel", fused.fused_walk),
                       ("plain", fused.fused_walk_plain)):
        out = (torch.zeros((tabs.n_slots, C * S, Ppad), device="cuda"),
               torch.zeros((tabs.n_slots, 1, Ppad), dtype=torch.int32,
                           device="cuda"))
        outs[name] = walk(*args, out=out)
    torch.cuda.synchronize()
    (k_clv, k_sc), (p_clv, p_sc) = outs["kernel"], outs["plain"]
    if not (torch.equal(k_clv, p_clv) and torch.equal(k_sc, p_sc)):
        raise AssertionError("kernel 2 over a chunked window's table "
                             "differs from its plain walk")
    row["window_table"] = dict(traversals=CHUNKED_WINDOW, rows=len(
        tabs.idx8), slots=tabs.n_slots, bit_for_bit=True)
    print(f"chunked window table (kernel 2 against its plain walk): "
          f"{json.dumps(row['window_table'])}")
    del part64, outs, k_clv, p_clv
    torch.cuda.empty_cache()
    return row


def run_examples() -> dict:
    """Each demo of ``pllmod_tpu_torch/examples`` as ``main(["--device",
    "cuda"])`` in this process, its output written to
    ``build/capacity/examples/<name>.txt`` and held to EXAMPLES' strings;
    launches counted (cell ``examples``, path the demo's name). Returns
    each one's status (0: returned) and host seconds."""
    import importlib
    out_dir = os.path.join(CAPACITY_DIR, "examples")
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for name, strings in EXAMPLES.items():
        demo = importlib.import_module(f"pllmod_tpu_torch.examples.{name}")
        path = os.path.join(out_dir, f"{name}.txt")
        t0 = time.perf_counter()
        with open(path, "w") as fh, contextlib.redirect_stdout(fh):
            counted("examples", name, lambda: demo.main(["--device",
                                                         "cuda"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(path) as fh:
            text = fh.read()
        missing = [s for s in strings if s not in text]
        if missing:
            raise AssertionError(f"example {name} printed no {missing}")
        rows[name] = dict(status=0, seconds=seconds)
        print(f"example {name}: status 0, {seconds:.1f} s")
    return rows


def run_capacity(gpu, profile: bool, cell_proc=None) -> dict:
    """Phase 10: the capacity cell (``flagship.capacity_cell``: 10,000
    taxa × 100,000 sites simulated along a random tree, GTR+Γ4, float32,
    nothing cut; built on the host by the process of
    :func:`start_capacity_cell` when given, else here, and copied onto
    the card): ``create_partition`` by step; ``auto``'s route, its
    CAPACITY_EVALS timed evaluations and updates a second;
    ``loglikelihood_bounded_fused``; both logLs against the float64
    bounded evaluation on the card; the BLO's route to the bounded sweep
    and one bounded whole-tree sweep (``max_sweeps=1``); kernels 1, 2, 8
    and 10 at the cell's shapes; then the chunked BLO at the flagship
    width (:func:`run_chunked`) and the eight examples
    (:func:`run_examples`). ``profile``: one capacity evaluation and the
    sweep under ``profile.trace``, the top device kernels and the busy
    share of the window. Returns the phase's row, with its seconds by
    step (``steps_s``)."""
    from pllmod_tpu_torch import profile as profile_mod
    t_phase = time.perf_counter()
    steps, clock = {}, [t_phase]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now
    row = dict(cell=dict(CAPACITY, model="GTR+G4 float32"), gpu=gpu,
               steps_s=steps)
    part, tree, row["host"] = load_capacity_cell(cell_proc)
    step("cell")
    part = part.cache_eigen()
    part64 = f64_copy(part).cache_eigen()    # shares the tip codes
    row.update(patterns=part.n_patterns, patterns_padded=(
        part.n_patterns_padded), tip_codes_gib=nbytes(part.tip_states)
        / 2**30)
    print(f"capacity cell: {json.dumps(row)}")
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32, device="cuda")
    l64, ns64 = engine.loglikelihood_bounded(
        part64, tree, brlens=brl.double())
    l64 = float(l64)
    step("f64_start")

    # auto: its route, CAPACITY_EVALS timed evaluations
    t0 = time.perf_counter()
    ev = engine.compile_fast_eval(part, tree)
    compile_s = time.perf_counter() - t0
    n_slots = resident.compile_resident(part, tree)[3]
    scales = 1.0 + 1e-4 * torch.arange(CAPACITY_EVALS, device="cuda")
    brls = brl[None, :] * scales[:, None]

    def evals():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = [ev(part, brls[i]) for i in range(CAPACITY_EVALS)]
        stop.record()
        issue = (time.perf_counter() - t0) * 1e3 / CAPACITY_EVALS
        stop.synchronize()
        return out, start.elapsed_time(stop) / CAPACITY_EVALS, issue
    lnl_auto = float(ev(part, brl))
    (lnls, ms, issue_ms), _ = counted("capacity", "auto", evals,
                                      must=CAPACITY_MUST["auto"])
    if not all(np.isfinite(float(x)) for x in lnls):
        raise AssertionError("capacity auto evaluation: a non-finite logL")
    rel_close(lnl_auto, l64, LOGL_RTOL, "capacity auto logL vs float64 "
              "bounded")
    row["auto"] = dict(
        route=ev.schedule, n_slots=n_slots, compile_s=compile_s,
        ms_per_eval=ms, host_issue_ms_per_eval=issue_ms, lnl=lnl_auto,
        f64=l64, rel_to_f64=abs(lnl_auto - l64) / abs(l64),
        clv_pattern_node_updates_per_s=(CAPACITY["n_taxa"] - 2)
        * part.n_patterns / (ms * 1e-3))
    print(f"capacity auto: {json.dumps(row['auto'])}")
    step("auto")

    # the bounded fused evaluation (kernel 2 on the serial table)
    (res, host_ms), _ = counted(
        "capacity", "bounded_fused", lambda: timed_host(
            lambda: engine.loglikelihood_bounded_fused(part, tree)),
        must=CAPACITY_MUST["bounded_fused"])
    lnl_f = float(res[0])
    _, again_ms = timed_host(lambda: engine.loglikelihood_bounded_fused(
        part, tree))
    rel_close(lnl_f, l64, LOGL_RTOL, "capacity bounded fused logL vs "
              "float64 bounded")
    row["bounded_fused"] = dict(ms=host_ms, ms_again=again_ms,
                                n_slots=res[1], lnl=lnl_f,
                                rel_to_f64=abs(lnl_f - l64) / abs(l64))
    row["f64_bounded"] = dict(lnl=l64, n_slots=ns64)
    print(f"capacity bounded fused: {json.dumps(row['bounded_fused'])}")
    step("bounded_fused")

    # the BLO's route and one bounded whole-tree sweep
    if not blo._bounded_blo_auto(part, tree, blo.BLO_MEM_BUDGET):
        raise AssertionError("the capacity cell's BLO does not route to "
                             "the bounded sweep")
    tr, stats = tree.copy(), {}
    mem = reset_peak_memory()
    ((_, lnl_s), sweep_ms), got = counted(
        "capacity", "blo_bounded", lambda: timed_host(
            lambda: blo.optimize_branch_lengths(part, tr, max_sweeps=1,
                                                stats=stats)),
        must=CAPACITY_MUST["blo_bounded"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    if stats.get("route") != "bounded":
        raise AssertionError(f"blo.optimize_branch_lengths took route "
                             f"{stats.get('route')}, not the bounded sweep")
    s64, _ = engine.loglikelihood_bounded(
        part64, tr, brlens=torch.as_tensor(tr.lengths, device="cuda"))
    s64 = float(s64)
    if not s64 >= l64:
        raise AssertionError(f"the bounded sweep ended below its start "
                             f"(float64): {s64} < {l64}")
    rel_close(lnl_s, s64, LOGL_RTOL, "capacity bounded sweep logL vs "
              "float64 at its lengths")
    row["blo_bounded"] = dict(
        ms=sweep_ms, start_lnl=lnl_auto, start_f64=l64, lnl=lnl_s, f64=s64,
        rel_to_f64=abs(lnl_s - s64) / abs(s64), start_gib=mem,
        peak_gib=peak, **stats,
        launches={k: n for k, n in got.items() if n})
    print(f"capacity bounded sweep: {json.dumps(row['blo_bounded'])}")
    del part64
    torch.cuda.empty_cache()
    step("blo_bounded_and_f64")

    row["kernels"], row["host_tables"] = capacity_kernel_rows(part, tree,
                                                              brl)
    step("kernels")
    if profile:
        # the bounded schedule's structural check: a test's, O(n·depth)
        # sets, never on the sweep's path
        sched = blo_bounded.BoundedSweepSchedule(tree)
        row["host_tables"]["validate_schedule_s"] = timed_host(
            lambda: blo_bounded.validate_schedule(sched, tree))[1] / 1e3
        del sched
        logdir = os.path.join(CAPACITY_DIR, "trace")
        shutil.rmtree(logdir, ignore_errors=True)
        t0 = time.perf_counter()
        with profile_mod.trace(logdir):
            float(ev(part, brl))
            blo.optimize_branch_lengths(part, tree.copy(), max_sweeps=1)
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        row["profile"] = trace_top(logdir)
        row["profile"].update(window_ms=window_ms, device_busy_share=row[
            "profile"]["device_ms"] / window_ms)
        print(f"capacity profile: {json.dumps(row['profile'])}")
        step("profile")
    del part, ev, brls
    torch.cuda.empty_cache()
    row["chunked"] = run_chunked(gpu)
    step("chunked")
    row["examples"] = run_examples()
    step("examples")
    row["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {row['seconds']:.1f} s")
    return row


def timed_host(fn):
    """(fn(), host ms)."""
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# --parent: kernels 1-8 and 10 against another checkout's, by device
# time
# ---------------------------------------------------------------------------
PARENT_KERNELS = ("pllmod_fused_walk",
                  "pllmod_child_pass", "pllmod_child2_pass",
                  "pllmod_level_combined",
                  "pllmod_edge_sumtables", "pllmod_newton_edges",
                  "pllmod_packed_walk", "pllmod_grouped_walk")


def start_parent_build(parent: str):
    """Start building another checkout's kernels (its own ``_build``, in
    its own ``build/``) in a process of its own; returns the process,
    whose last output line is JSON: each entry point of PARENT_KERNELS
    that the checkout defines with its library's path and its C argument
    and result types, from that checkout's own ``ENTRY_POINTS``."""
    code = (
        "import json; from pllmod_tpu_torch.ops import _build; "
        "paths = _build.build(); "
        f"names = {PARENT_KERNELS!r}; "
        "print(json.dumps({n: [paths[_build.ENTRY_POINTS[n][0]], "
        "[t.__name__ for t in _build.ENTRY_POINTS[n][1]], "
        "_build.ENTRY_POINTS[n][2].__name__] for n in names "
        "if n in _build.ENTRY_POINTS}))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def parent_libs(proc) -> dict:
    """The entry points of PARENT_KERNELS of the checkout that ``proc``
    (:func:`start_parent_build`) built, each from the library that
    defines it there and with its own C signature: {name: function}."""
    import ctypes
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's build failed:\n{err[-4000:]}")
    fns = {}
    for name, (path, args, res) in json.loads(
            out.strip().splitlines()[-1]).items():
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = [getattr(ctypes, t) for t in args]
        fn.restype = getattr(ctypes, res)
        fns[name] = fn
    return fns


def _call(fn, label, *args):
    with torch.cuda.device(0):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent {label}: error {err}")


def parent_build_module(parent: str):
    """The ``ops/_build`` module of the checkout at ``parent`` (its own
    launch configurations and tile rules, its libraries under its own
    ``build/``), loaded beside this tree's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pllmod_tpu_torch", "ops",
                                     "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# kernel 1's capacity shape: 10,000 taxa x 100,000 sites (padded to
# 100,096), the five codes of the capacity cell's arrays (gap, A, C, G, T)
KERNEL1_CAPACITY = dict(n_taxa=10_000, n_sites=100_000, seed=3)


def resident_args(part, tree, tip_codes=None, codetab=None) -> tuple:
    """resident_walk's arguments for ``tree`` with ``part``'s model: its
    resident table, the P-matrices at the tree's lengths, and the tip
    codes and code table (by default ``part``'s)."""
    from types import SimpleNamespace
    tc = part.tip_states if tip_codes is None else tip_codes
    tab = fused.code_table(part) if codetab is None else codetab
    idx8, e1, e2, ns = resident.compile_resident(
        SimpleNamespace(n_tips=tc.shape[0], device=tc.device), tree)
    brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                          device=tc.device)
    return (idx8, fused.pair_pmats(part, brl, e1, e2, root_row=True), tc,
            tab, ns)


def kernel1_shapes(dna, tree) -> list:
    """(label, resident_walk's arguments) of kernel 1 at three DNA +G4
    shapes: the flagship cell (``dna``, ``tree``), the search cell's 246 ×
    4465 (:func:`flagship.search_cell`, its own partition) and the
    capacity shape (KERNEL1_CAPACITY: a :func:`flagship.random_binary_tree`
    with lengths U(0.02, 0.4), tip codes drawn on the card from the five
    codes, the flagship cell's P-matrices; kernel 1's time does not
    depend on the values)."""
    seqs, _, tr246 = flagship.search_cell()
    p246 = create_partition(seqs, states=4, alpha=0.9,
                            device="cuda").cache_eigen()
    cap = KERNEL1_CAPACITY
    rng = np.random.default_rng(cap["seed"])
    trc = flagship.random_binary_tree(rng, cap["n_taxa"], 0.02, 0.4)
    gen = torch.Generator(device="cuda").manual_seed(cap["seed"])
    ppad = -(-cap["n_sites"] // 128) * 128
    codes = torch.randint(0, 5, (cap["n_taxa"], ppad), dtype=torch.int32,
                          device="cuda", generator=gen)
    tab5 = torch.cat([torch.ones(1, 4), torch.eye(4)]).to("cuda")
    return [("flagship DNA", resident_args(dna, tree)),
            ("246 x 4465", resident_args(p246, tr246)),
            ("capacity", resident_args(dna, trc, codes, tab5))]


def kernel1_against_parent(parent: str, shapes) -> list:
    """Kernel 1 of the checkout at ``parent`` (its library and its own
    tile rule, :func:`parent_build_module`) beside this tree's at each of
    ``shapes`` (:func:`kernel1_shapes`): both held bit for bit to the
    plain version, device ms a launch in turns (parent, this tree, this
    tree, parent) over 20 launches (5 where the plain version takes more
    than a second), and the bound. Returns a row a shape."""
    pb = parent_build_module(parent)
    fn = pb.entry_points(pb.build(("pruning",))).pllmod_resident_walk
    rows = []
    for label, args in shapes:
        idx8, P5, tc, tab, ns = args
        _, _, C, S, _ = P5.shape
        n_codes, Ppad = tab.shape[0], tc.shape[1]
        Tp, cfp = pb.walk_launch_config("pllmod_resident_walk", C, S,
                                        n_codes, ns, Ppad)
        T, cf = _build.walk_launch_config("pllmod_resident_walk", C, S,
                                          n_codes, ns, Ppad)
        mats = torch.empty((len(idx8), 2, cfp["Q"]), device="cuda")
        out = (torch.empty((C * S, Ppad), device="cuda"),
               torch.empty((1, Ppad), dtype=torch.int32, device="cuda"))

        def theirs():
            _call(fn, "resident walk", idx8.data_ptr(), len(idx8),
                  P5.data_ptr(), tc.data_ptr(), tab.data_ptr(), n_codes,
                  out[0].data_ptr(), out[1].data_ptr(), Ppad, C, S, ns, Tp,
                  mats.data_ptr())

        def mine():
            return resident.resident_walk(*args)
        t0 = time.perf_counter()
        want = resident.resident_walk_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        theirs()
        got = mine()
        for a, b, who in ((got, want, "this tree's"), (out, want,
                                                       "the parent's")):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"kernel 1 ({label}): {who} kernel "
                                     "differs from the plain version")
        del want, got
        n = 5 if plain_ms > 1e3 else 20
        t = [device_ms(f, n) for f in (theirs, mine, mine, theirs)]
        b_ms, b_by = bound(nbytes(idx8, P5, tc, tab, *out),
                           walk_flops(idx8, C, S, Ppad, n_codes))
        rows.append(dict(
            kernel="resident_walk", shape=label, rows=len(idx8), slots=ns,
            patterns=Ppad, kind=cf["kind"], tile=T, threads=cf["threads"],
            smem=cf["smem"], parent_kind=cfp["kind"], parent_tile=Tp,
            parent_ms=[t[0], t[3]], ms=[t[1], t[2]],
            speedup=(t[0] + t[3]) / (t[1] + t[2]), bound_ms=b_ms,
            bound_by=b_by, plain_ms=plain_ms))
        print(f"kernel 1 against the parent: {rows[-1]}")
        del mats, out
    return rows


def parent_compare(proc, cells, newton_shapes, sumtable_shapes) -> list:
    """Kernels 2-8 and 10 of another checkout (its C entry points,
    :func:`parent_libs`) beside this tree's on the same inputs (kernel 1:
    :func:`kernel1_against_parent`): kernels
    2-8 bit for bit (kernel 7 on the positions its members write, kernels
    4 and 5 on the whole buffers after every level), kernel 10 within
    DERIV_RTOL; device ms a
    launch timed in turns (parent, this tree, this tree, parent).
    ``cells``: (label, part, tree) of the flagship DNA, protein and
    64-state cells; ``newton_shapes``: (label, parts, sts, scs, t0,
    scalers, lws, lnBs) of kernel 10's launches, ``sumtable_shapes``:
    (label, edge_sumtables' arguments) of kernel 8's (all edges and each
    color class)."""
    import ctypes
    libs = parent_libs(proc)
    rows = []

    def ab(label, mine, theirs, check, iters, per=1):
        check()
        t = [device_ms(f, iters) / per for f in (theirs, mine, mine,
                                                 theirs)]
        row = dict(kernel=label, parent_ms=[t[0], t[3]], ms=[t[1], t[2]],
                   speedup=(t[0] + t[3]) / (t[1] + t[2]))
        print(f"parent compare: {row}")
        rows.append(row)

    def equal(a, b, label):
        def check():
            for x, y in zip(a(), b()):
                if not torch.equal(x, y):
                    raise AssertionError(f"{label}: this tree's kernel and "
                                         "the parent's differ")
        return check

    for label, part, tree in cells:
        brl = torch.as_tensor(tree.lengths, dtype=torch.float32,
                              device=part.device)
        tab = fused.code_table(part)
        C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
        n_codes = tab.shape[0]
        # kernel 2
        tables = [(label, *fused.compile_fused(part, tree,
                                               fuse_root=True)[:3], True)]
        if label == "flagship DNA":
            tabs = blo._compile_tables(part, blo.DirectedTraversal(tree))
            tables.append((f"{label}, directed", tabs.idx8, tabs.e1,
                           tabs.e2, False))
        for name, idx8, e1, e2, root in tables:
            P5 = fused.pair_pmats(part, brl, e1, e2, root_row=root)
            ns = int(idx8[:, 6].max()) + 1
            w = torch.unique(idx8[:, 6].long())
            mine_out = fused.fused_walk(idx8, P5, part.tip_states, tab, ns)
            theirs_out = (torch.empty_like(mine_out[0]),
                          torch.empty_like(mine_out[1]))
            T = _build.fused_tile(C, S, n_codes, Ppad)
            mats = torch.empty((len(idx8), 2, _build.fused_config(
                C, S, n_codes, T)["Q"]), device=part.device)

            def theirs2():
                _call(libs["pllmod_fused_walk"], "fused walk",
                      idx8.data_ptr(), len(idx8), P5.data_ptr(),
                      part.tip_states.data_ptr(), tab.data_ptr(), n_codes,
                      theirs_out[0].data_ptr(), theirs_out[1].data_ptr(),
                      Ppad, C, S, ns, T, mats.data_ptr())

            def mine2():
                fused.fused_walk(idx8, P5, part.tip_states, tab, ns,
                                 out=mine_out)
            theirs2()
            ab(f"fused_walk ({name})", mine2, theirs2,
               equal(lambda: (mine_out[0][w], mine_out[1][w]),
                     lambda: (theirs_out[0][w], theirs_out[1][w]),
                     f"fused_walk ({name})"), 10)
        if label == "64-state":
            continue
        # kernel 3 on every level's side 0
        lvls, offsets, _, ns = engine.compile_schedule(part, tree)
        idx, e1, e2 = levels.level_tables(part, lvls)
        P1 = part.prob_matrices(brl)[e1].contiguous()
        sl = [slice(o, o + len(lv)) for lv, o in zip(lvls, offsets)]
        # the children's slots hold random CLVs and scalers: both kernels
        # read the same
        bufs = (torch.rand((ns, C * S, Ppad), device=part.device),
                torch.randint(-3, 3, (ns, 1, Ppad), dtype=torch.int32,
                              device=part.device))
        outs = [(torch.empty((len(lv), C * S, Ppad), device=part.device),
                 torch.empty((len(lv), 1, Ppad), dtype=torch.int32,
                             device=part.device)) for lv in lvls]

        def theirs3():
            for s, (o, so) in zip(sl, outs):
                W = s.stop - s.start
                _call(libs["pllmod_child_pass"], "child pass",
                      idx[s].data_ptr(), W, 0, P1[s].data_ptr(),
                      bufs[0].data_ptr(), bufs[1].data_ptr(), ns,
                      part.tip_states.data_ptr(), part.tip_states.shape[0],
                      tab.data_ptr(), n_codes, o.data_ptr(), so.data_ptr(),
                      Ppad, C, S, _build.child_tile(C, S, n_codes, Ppad, W))

        def mine3():
            return [levels.child_pass(idx[s], 0, *bufs, part.tip_states,
                                      tab, P1[s]) for s in sl]
        theirs3()
        ab(f"child_pass ({label})", mine3, theirs3,
           equal(lambda: [t for pair in mine3() for t in pair],
                 lambda: [t for pair in outs for t in pair],
                 f"child_pass ({label})"), 10, per=len(sl))
        # kernels 4 and 5 on every level, into buffers that start alike:
        # a parent from before their tiled kernel (18 and 17 arguments)
        # runs at pattern_tile, a later one at this tree's rule with the
        # scratch of its pre-pass
        s1s = [torch.randint(-3, 3, (len(lv), 1, Ppad), dtype=torch.int32,
                             device=part.device) for lv in lvls]
        lfts = [torch.rand((len(lv), C * S, Ppad), device=part.device)
                for lv in lvls]
        P2 = part.prob_matrices(brl)[e2].contiguous()
        for kernel, fn45 in (("child2", libs["pllmod_child2_pass"]),
                             ("combined", libs["pllmod_level_combined"])):
            mine_b = [t.clone() for t in bufs]
            theirs_b = [t.clone() for t in bufs]

            old45 = len(fn45.argtypes) == (18 if kernel == "child2" else 17)
            sides45 = _build.LEVEL_MODES.index(kernel) + 1
            mats45 = []       # the scratch of each level's pre-pass
            for lv in lvls:
                T45 = _build.level_tile(kernel, C, S, n_codes, Ppad, len(lv))
                mats45.append((T45, torch.empty(
                    len(lv) * sides45 * _build.level_config(
                        kernel, C, S, n_codes, T45)["Q"],
                    device=part.device)))
            scratch45 = [(_build.pattern_tile(C),) if old45 else
                         (T45, m45.data_ptr()) for T45, m45 in mats45]

            def theirs45():
                for s, lf, s1, tail45 in zip(sl, lfts, s1s, scratch45):
                    W = s.stop - s.start
                    head = (idx[s].data_ptr(), W)
                    Ps = ((P2[s].data_ptr(),) if kernel == "child2" else
                          (P1[s].data_ptr(), P2[s].data_ptr()))
                    body = (theirs_b[0].data_ptr(), theirs_b[1].data_ptr(),
                            ns, part.tip_states.data_ptr(),
                            part.tip_states.shape[0], tab.data_ptr(),
                            n_codes)
                    tail = ((lf.data_ptr(), s1.data_ptr()) if kernel ==
                            "child2" else ())
                    _call(fn45, kernel, *head, *Ps, *body, *tail, s.start,
                          Ppad, C, S, *tail45)

            def mine45():
                for s, lf, s1 in zip(sl, lfts, s1s):
                    if kernel == "child2":
                        levels.child2_pass(idx[s], *mine_b, part.tip_states,
                                           tab, P2[s], lf, s1, s.start)
                    else:
                        levels.level_update_combined(
                            *mine_b, idx[s], part.tip_states, tab, P1[s],
                            P2[s], s.start)
            name45 = ("child2_pass" if kernel == "child2"
                      else "level_combined")
            ab(f"{name45} ({label})", mine45, theirs45,
               equal(lambda: (mine45(), theirs45(), mine_b)[2],
                     lambda: theirs_b, f"{name45} ({label})"), 10,
               per=len(sl))
        # kernels 6 and 7: a parent from before the group-window walk
        # (17 and 16 arguments) runs at pattern_tile and takes no windows,
        # order or scratch; a later one takes this tree's tile, lanes,
        # tables and scratch (pre-pass and row table)
        n_tips = part.tip_states.shape[0]
        T, R = _build.group_walk_tile(C, S, n_codes, Ppad)
        psched = packed.PackedSchedule(part, tree)
        P = part.prob_matrices(brl).to(torch.float32).contiguous()
        pargs = (psched.idxm, psched.e1, psched.e2, P, part.tip_states, tab,
                 psched.G, psched.windows)
        n_rows = len(psched.idxm)
        theirs6 = (torch.empty((n_rows, C * S, Ppad), device=part.device),
                   torch.empty((n_rows, 1, Ppad), dtype=torch.int32,
                               device=part.device))
        fn6 = libs["pllmod_packed_walk"]
        mats6 = torch.empty((2 * n_rows, _build.group_walk_config(
            C, S, n_codes, T, R)["Q"]), device=part.device)
        rows6 = torch.empty((n_rows, _build.GROUP_WALK_ROW),
                            dtype=torch.int32, device=part.device)
        tail6 = ((_build.pattern_tile(C),) if len(fn6.argtypes) == 17 else
                 (T, R, psched.windows.data_ptr(), len(psched.windows) - 1,
                  mats6.data_ptr(), rows6.data_ptr()))

        def theirs6_call():
            _call(fn6, "packed walk", psched.idxm.data_ptr(),
                  psched.e1.data_ptr(), psched.e2.data_ptr(), n_rows,
                  P.data_ptr(), P.shape[0], part.tip_states.data_ptr(),
                  n_tips, tab.data_ptr(), n_codes, theirs6[0].data_ptr(),
                  theirs6[1].data_ptr(), Ppad, C, S, *tail6)
        theirs6_call()
        ab(f"packed_walk ({label})", lambda: packed.packed_walk(*pargs),
           theirs6_call, equal(lambda: packed.packed_walk(*pargs),
                               lambda: theirs6, f"packed_walk ({label})"), 10)
        gsched = grouped.GroupedSchedule(part, tree)
        PQ = grouped.grouped_pmats(part, brl, gsched.e_sides)
        gargs = (gsched.side_meta, gsched.dst_meta, PQ, part.tip_states, tab,
                 gsched.order, gsched.windows)
        theirs7 = (torch.empty((gsched.nG + 1, gsched.Q, C * S, Ppad),
                               device=part.device),
                   torch.empty((gsched.nG + 1, gsched.Q, Ppad),
                               dtype=torch.int32, device=part.device))
        fn7 = libs["pllmod_grouped_walk"]
        mats7 = torch.empty((gsched.nG * gsched.Q, _build.group_walk_config(
            C, S, n_codes, T, R)["Q"]), device=part.device)
        rows7 = torch.empty((gsched.nG * gsched.G, _build.GROUP_WALK_ROW),
                            dtype=torch.int32, device=part.device)
        tail7 = ((_build.pattern_tile(C),) if len(fn7.argtypes) == 16 else
                 (T, R, gsched.order.data_ptr(), gsched.windows.data_ptr(),
                  len(gsched.windows) - 1, mats7.data_ptr(),
                  rows7.data_ptr()))

        def theirs7_call():
            _call(fn7, "grouped walk", gsched.side_meta.data_ptr(),
                  gsched.dst_meta.data_ptr(), gsched.nG, gsched.G,
                  PQ.data_ptr(), part.tip_states.data_ptr(), n_tips,
                  tab.data_ptr(), n_codes, theirs7[0].data_ptr(),
                  theirs7[1].data_ptr(), Ppad, C, S, *tail7)
        dst = gsched.dst_meta.long()
        dg, dq = dst[..., 0], dst[..., 1]

        def written(out):
            return out[0][dg, dq], out[1][dg, dq]
        theirs7_call()
        ab(f"grouped_walk ({label})", lambda: grouped.grouped_walk(*gargs),
           theirs7_call, equal(lambda: written(grouped.grouped_walk(*gargs)),
                               lambda: written(theirs7),
                               f"grouped_walk ({label})"), 10)
    # kernel 8 at every BLO launch shape; a parent from before its tiled
    # kernel takes the simple kernel's tile as its last argument, a later
    # one the forced tile and ring depth (0, 0: its rule)
    fn8 = libs["pllmod_edge_sumtables"]
    mine_fn8 = _build.load().pllmod_edge_sumtables
    for label, args in sumtable_shapes:
        part, clvs, scalers, eref, basis = args
        C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
        tabs = deriv.sumtable_tip_tables(part, basis)
        outs = {}

        def call8(fn, tail, out):
            # the C entry point alone on the same inputs: no tip tables
            # rebuilt, no output allocated (the wrapper does both)
            _call(fn, "sumtables", eref.data_ptr(), len(eref),
                  clvs.data_ptr(), scalers.data_ptr(), clvs.shape[0],
                  part.tip_states.data_ptr(), part.n_tips, basis.data_ptr(),
                  tabs.data_ptr(), tabs.shape[1], out[0].data_ptr(),
                  out[1].data_ptr(), Ppad, C, S, *tail)
        for who in ("mine", "theirs"):
            outs[who] = (torch.empty((len(eref), C * S, Ppad),
                                     device=clvs.device),
                         torch.empty((len(eref), 1, Ppad), dtype=torch.int32,
                                     device=clvs.device))
        tail = ((_build.pattern_tile(C),) if len(fn8.argtypes) == 17
                else (0, 0))

        def theirs8():
            call8(fn8, tail, outs["theirs"])

        def mine8():
            call8(mine_fn8, (0, 0), outs["mine"])
        def mine8_out():
            mine8()
            return outs["mine"]
        theirs8()
        ab(f"edge_sumtables ({label})", mine8, theirs8,
           equal(mine8_out, lambda: outs["theirs"],
                 f"edge_sumtables ({label})"), 10)
        if not all(torch.equal(g, w) for g, w in zip(
                outs["mine"], deriv.edge_sumtables(*args))):
            raise AssertionError(f"edge_sumtables ({label}): the C entry "
                                 "point and the wrapper differ")
    # kernel 10 at every BLO launch shape
    for label, parts, sts, scs, t0, scalers, lws, lnbs in newton_shapes:
        nargs = (parts, sts, scs, t0, scalers, MIN_BRANCH_LEN,
                 MAX_BRANCH_LEN, TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS, lws,
                 lnbs)
        E = len(t0)
        got_t = [torch.empty(E, device=t0.device) for _ in range(2)] + [
            torch.empty(E, dtype=torch.int32, device=t0.device)]
        inputs = deriv._multi_inputs(parts, scalers, lws, lnbs)
        desc = torch.tensor([[st.data_ptr(), sc.data_ptr(), lw.data_ptr(),
                              lnB.data_ptr(), pw.data_ptr(), st.shape[1],
                              st.shape[2]] for st, sc, (lw, lnB, pw)
                             in zip(sts, scs, inputs)], dtype=torch.int64,
                            device=t0.device)

        # a parent from before kernel 10's cluster design (13 arguments)
        # takes the summed C·S; a later one each partition's (C·S, Ppad)
        # on the host and a forced design (0: its rule)
        fn10 = libs["pllmod_newton_edges"]
        if len(fn10.argtypes) == 13:
            shape_args, tail = (sum(st.shape[1] for st in sts),), ()
        else:
            dims = (ctypes.c_longlong * (2 * len(sts)))(
                *[v for st in sts for v in st.shape[1:]])
            shape_args, tail = (ctypes.addressof(dims),), (0,)

        def theirs10():
            _call(fn10, "newton", desc.data_ptr(), len(parts), *shape_args,
                  t0.data_ptr(), MIN_BRANCH_LEN, MAX_BRANCH_LEN,
                  TOL_BRANCH_LEN, blo.MAX_NEWTON_ITERS,
                  got_t[0].data_ptr(), got_t[1].data_ptr(),
                  got_t[2].data_ptr(), E, *tail)

        def check10():
            mine = deriv.newton_edges_multi(*nargs)
            theirs10()
            errs = [_rel(mine[0], got_t[0], 1e-4),
                    _rel(mine[1], got_t[1], 1e-2)]
            if errs[0] > DERIV_RTOL["t"] or errs[1] > DERIV_RTOL["lnl0"]:
                raise AssertionError(f"newton ({label}): this tree's kernel "
                                     f"and the parent's differ: {errs}")
        ab(f"newton_edges ({label})", lambda: deriv.newton_edges_multi(
            *nargs), theirs10, check10, 10)
    return rows


# ---------------------------------------------------------------------------
# --parent: the level evaluations of both checkouts, in turns, each in a
# process of its own (both packages are named pllmod_tpu_torch)
# ---------------------------------------------------------------------------
TURN_SCHEDULES = ("pallas", "combined")   # kernels 3 and 4, or 5, a level
HOST_CALLS = 200          # wrapper calls timed: fewer than the launch queue
TURN_REPEATS = 5          # timings a turn, the least kept (host stalls)


def wrapper_host_us(part, tree) -> dict:
    """Host µs to issue one call of kernel 4's and kernel 5's wrappers on
    the cell's widest level: the mean of HOST_CALLS calls after a warm-up,
    from an idle device, the least of TURN_REPEATS such means."""
    lvls, offsets, _, ns = engine.compile_schedule(part, tree)
    idx, e1, e2 = levels.level_tables(part, lvls)
    P = part.prob_matrices(torch.as_tensor(
        tree.lengths, dtype=torch.float32, device=part.device))
    w = max(range(len(lvls)), key=lambda i: len(lvls[i]))
    s = slice(offsets[w], offsets[w] + len(lvls[w]))
    P1, P2 = P[e1][s].contiguous(), P[e2][s].contiguous()
    tc, tab = part.tip_states, fused.code_table(part)
    C, S, Ppad = part.n_cats, part.states, part.n_patterns_padded
    bufs = (torch.zeros((ns, C * S, Ppad), device=part.device),
            torch.zeros((ns, 1, Ppad), dtype=torch.int32, device=part.device))
    left, s1 = levels.child_pass(idx[s], 0, *bufs, tc, tab, P1)
    calls = {"child2_pass": lambda: levels.child2_pass(
                 idx[s], *bufs, tc, tab, P2, left, s1, s.start),
             "level_combined": lambda: levels.level_update_combined(
                 *bufs, idx[s], tc, tab, P1, P2, s.start)}
    out = {}
    for name, fn in calls.items():
        fn()
        means = []
        for _ in range(TURN_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            means.append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
        torch.cuda.synchronize()
        out[name] = min(means)
    return out


def level_eval_times() -> dict:
    """The level evaluations of TURN_SCHEDULES at the flagship and protein
    cells on the package this process imports: {cell: {schedule: [ms/eval
    on the device, host issue ms/eval (the least of TURN_REPEATS
    timings), the timed loop's summed logL], "wrapper_host_us":
    wrapper_host_us}}."""
    out = {}
    for label, spec in (("flagship DNA", FLAGSHIP), ("protein", PROTEIN)):
        part, tree = flagship.example(**spec, device="cuda")
        part = part.cache_eigen()
        out[label] = {sched: [*min(timed_main_path(part, tree, label, sched)
                                   for _ in range(TURN_REPEATS)),
                              float(eval_loop(part, tree, sched)())]
                      for sched in TURN_SCHEDULES}
        out[label]["wrapper_host_us"] = wrapper_host_us(part, tree)
    return out


def eval_turn(checkout: str) -> dict:
    """:func:`level_eval_times` in a process of its own that runs this
    file's functions on the package and kernels of ``checkout`` (built in
    its build/ beforehand)."""
    code = ("import importlib.util, json; "
            "spec = importlib.util.spec_from_file_location("
            f"'smoke_turn', {os.path.abspath(__file__)!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "print(json.dumps(m.level_eval_times()))")
    done = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"the level evaluations of {checkout} failed: "
                           + done.stderr[-3000:])
    return json.loads(done.stdout.strip().splitlines()[-1])


def eval_turns(parent: str) -> dict:
    """The ``pallas`` and ``combined`` evaluations of the checkout at
    ``parent`` and of this tree in turns (parent, this tree, this tree,
    parent), each turn a process of its own, at the flagship and protein
    cells: ms/eval and host issue ms/eval, and the host µs of one kernel-4
    and kernel-5 wrapper call. Each turn's summed logLs equal the first
    turn's, bit for bit. Returns {cell: {schedule or "wrapper_host_us":
    {"parent": [...], "this": [...]}}}."""
    here = os.path.dirname(os.path.abspath(__file__))
    turns = [(who, eval_turn(d)) for who, d in (
        ("parent", parent), ("this", here), ("this", here),
        ("parent", parent))]
    out = {}
    for label, first in turns[0][1].items():
        out[label] = {}
        for key in first:
            got = {"parent": [], "this": []}
            for who, t in turns:
                v = t[label][key]
                if key in TURN_SCHEDULES and v[2] != first[key][2]:
                    raise AssertionError(
                        f"{key} ({label}): the summed logL of a turn of "
                        f"{who} differs from the parent's ({v[2]} against "
                        f"{first[key][2]})")
                got[who].append(v if key not in TURN_SCHEDULES else v[:2])
            out[label][key] = got
            print(f"in turns ({label}, {key}): parent {got['parent']}, "
                  f"this tree {got['this']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path's timed loops")
    ap.add_argument("--parent", metavar="DIR",
                    help="also time kernels 1-8 and 10 of the checkout "
                         "at DIR beside this tree's, by device time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # the parent's build runs beside this tree's (and is ended at exit,
    # should a check fail before it is read)
    parent_build = start_parent_build(args.parent) if args.parent else None
    if parent_build is not None:
        atexit.register(parent_build.kill)
    # and the build with kernels 1 and 10's phase marks, for --profile
    phase_build = start_phase_build() if args.profile else None
    # phase 10's cell, simulated on the host beside phases 1-9
    cell_proc = start_capacity_cell()
    atexit.register(cell_proc.kill)
    gpu = gpu_line()
    print(gpu)
    name, power = (s.strip() for s in gpu.split(",", 1))

    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if line.startswith("== ") or any(
                k in line for k in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())

    cells = {}
    for label, spec, want in CELLS:
        part, tree = flagship.example(**spec, device="cuda")
        part64, _ = flagship.example(**spec, dtype=torch.float64,
                                     device="cuda")
        cells[label] = (part.cache_eigen(), tree, part64, want)
    dna, tree, dna64, _ = cells["flagship DNA"]
    prot, ptree, prot64, _ = cells["protein"]
    wide, wtree, wide64, _ = cells["64-state"]

    res_row = check_resident(dna, tree, dna64)
    res_prot = check_resident(prot, ptree, prot64)
    res_row["protein"] = {k: res_prot[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tile",
        "slots", "RP", "threads", "smem")}
    # kernel 2 at its four shapes: the flagship's fuse_root and directed
    # (BLO) tables, protein and 64 states
    fused_shapes = {
        "flagship DNA": check_fused(dna, tree, dna64, "flagship DNA"),
        "flagship DNA, directed": check_fused(dna, tree, dna64,
                                              "flagship DNA, directed",
                                              directed=True),
        "protein": check_fused(prot, ptree, prot64, "protein"),
        "64-state": check_fused(wide, wtree, wide64, "64-state")}
    fused_row = dict(fused_shapes["64-state"], shapes={
        k: {f: v[f] for f in ("ms", "events_ms", "plain_ms", "bound_ms",
                               "bound_by", "max_abs_err", "tile", "rows",
                               "forwarded", "kind", "NB", "threads")}
        for k, v in fused_shapes.items()})

    # ---- main path: schedule="auto" on every cell; every launch from
    # the counts' reset to their reading is counted
    ms = {}
    for label, (part, tr, part64, want) in cells.items():
        got = engine.compile_fast_eval(part, tr).schedule
        if got != want:
            raise AssertionError(f"auto routed {label} to {got}, not "
                                 f"{want}")

        def drive():
            logl = float(engine.tree_loglikelihood(part, tr))
            ms[label], _ = timed_main_path(part, tr, label)
            return logl
        must = ("resident_walk",) if want == "resident" else ("fused_walk",)
        logl, _ = counted(label, "loglikelihood", drive, must=must)
        rel_close(logl, float(engine.tree_loglikelihood(part64, tr)),
                  LOGL_RTOL, f"main path logL ({label})")

    # ---- branch-length optimization: the derivative kernels against
    # their plain versions, then the BLO calls, each counted
    deriv_rows = check_deriv(dna, tree, "flagship DNA")
    for row, prow in zip(deriv_rows, check_deriv(prot, ptree, "protein")):
        row["protein"] = {k: v for k, v in prow.items() if k not in (
            "name", "route", "source", "replaces")}
    blo_kernels = ("fused_walk", "edge_sumtables", "edge_derivatives",
                   "newton_edges")
    full, _ = counted("flagship DNA", "blo", lambda: run_blo(
        dna, tree, dna64, "flagship DNA")[0], must=blo_kernels)
    blo_rows = [full]
    (row, opt_tree), _ = counted(
        "flagship DNA", "blo_fused_newton_false", lambda: run_blo(
            dna, tree, dna64, "flagship DNA", fused_newton=False),
        must=("fused_walk",))
    if row["lnl"] < full["lnl"] - 1e-4 * abs(full["lnl"]):
        raise AssertionError(f"fused_newton=False reached {row['lnl']}, "
                             f"below {full['lnl']}")
    blo_rows.append(row)
    blo_rows.append(counted("protein", "blo", lambda: run_blo(
        prot, ptree, prot64, "protein")[0], must=(
            "fused_walk", "edge_sumtables", "newton_edges"))[0])
    split = [sub_sweep_split(dna, tree, "flagship DNA, start lengths"),
             sub_sweep_split(dna, opt_tree, "flagship DNA, optimized")]
    tr = tree.copy()

    def bounded():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lnl = blo_bounded.optimize_branch_lengths_bounded(dna, tr)
        torch.cuda.synchronize()
        return lnl, (time.perf_counter() - t0) * 1e3
    (l_b, bounded_ms), _ = counted("flagship DNA", "blo_bounded", bounded,
                                   must=("fused_walk",))
    gap = abs(l_b - full["lnl"])
    print(f"bounded BLO (flagship DNA): {l_b!r} in {bounded_ms:.1f} ms, "
          f"|Δl| {gap!r} against the full driver")
    if gap > BOUNDED_ABS + BOUNDED_REL * abs(full["lnl"]):
        raise AssertionError(f"bounded BLO off the full driver by {gap}")
    blo_rows.append(dict(cell="flagship DNA", bounded=True, lnl=l_b,
                         ms_host=bounded_ms, gap_to_full=gap))

    # ---- the level and grouped schedules at the flagship and protein
    # cells: kernels 3, 4, 5 and 7 against their plain versions, then
    # their paths, each counted
    level_rows = {}
    for label, (part, tr) in (("flagship DNA", (dna, tree)),
                              ("protein", (prot, ptree))):
        level_rows[label] = check_levels(part, tr, label) + [
            check_grouped(part, tr, label)]
    run_level_paths([("flagship DNA", dna, tree, dna64),
                     ("protein", prot, ptree, prot64)])
    for row, prow in zip(*level_rows.values()):
        row["protein"] = {k: prow[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "split_ms", "level_tiles", "tiles")
            if k in prow}

    # ---- the packed walk (kernel 6) at the flagship and protein cells:
    # the kernel against its plain version, then its path, counted
    packed_row = check_packed(dna, tree, dna64, "flagship DNA")
    prow = check_packed(prot, ptree, prot64, "protein")
    packed_ms = run_packed_path([("flagship DNA", dna, tree, dna64),
                                 ("protein", prot, ptree, prot64)])
    packed_row["protein"] = {k: prow[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
        "G", "groups", "n_slots_pad", "n_slots")}

    # ---- the partitioned analysis on the flagship tree: DNA + protein
    prot2 = flagship.partition_on_tree(tree, **PARTITION2,
                                       device="cuda").cache_eigen()
    prot2_64 = flagship.partition_on_tree(tree, **PARTITION2,
                                          dtype=torch.float64, device="cuda")
    multi_row = check_newton_multi((dna, prot2), tree, SCALED_SCALERS,
                                   "flagship DNA + protein")
    partitioned, _ = counted(
        "partitioned", "treeinfo",
        lambda: run_partitioned((dna, prot2), (dna64, prot2_64), tree),
        must=("fused_walk", "resident_walk", "edge_sumtables",
              "newton_edges_multi"))
    del prot2_64

    # ---- model-parameter optimization: the CLI's eval --opt, protein
    # alpha+pinv and branches, free rates, the PROTGTR canary; each
    # counted under path opt_model
    opt_rows, decomp_rows = run_opt_model(gpu, args.profile)

    # ---- SPR rounds and ancestral states on the simulated flagship cell
    spr_rows, spr_scorer, anc_row = run_spr(gpu, args.profile)

    # ---- the full ML search on the search cell: parsimony start,
    # checkpoints, a resume, the CLI's search
    search_row = run_search(gpu, args.profile)

    # ---- the site mesh: the paths above sharded over 4 shards on cuda:0
    # (and one shard a card where there are several), counted under path
    # mesh; partition DP; the dry run
    torch.cuda.empty_cache()
    mesh_row = run_mesh(gpu, args.profile)

    # ---- the capacity mode: 10,000 × 100,000 (auto, bounded evaluation,
    # the bounded sweep, kernels 1, 2, 8, 10 at its shapes), the chunked
    # BLO at the flagship width, the eight examples
    torch.cuda.empty_cache()
    capacity_row = run_capacity(gpu, args.profile, cell_proc)
    for row in (res_row, fused_row, *deriv_rows):
        if row["name"] in capacity_row["kernels"]:
            row["capacity"] = capacity_row["kernels"][row["name"]]
    kernel_rows = [with_launches(r) for r in (
        res_row, fused_row, *deriv_rows, *level_rows["flagship DNA"],
        packed_row, multi_row)]
    print(f"launches: {json.dumps(LAUNCH_LOG)}")
    print(f"kernel 1 launches by kind: {json.dumps(KIND_LOG)}")

    # ---- the other schedules of each cell, forced, end to end (the
    # 64-state cell's resident slots do not fit)
    ms_by_schedule = {}
    for label, (part, tr) in (("flagship DNA", (dna, tree)),
                              ("protein", (prot, ptree))):
        ms_by_schedule[label] = {
            sched: dict(zip(("ms", "host_issue_ms"),
                            timed_main_path(part, tr, label, sched)))
            for sched in ("fused", "pallas", "combined", "levels",
                          "grouped")}
    if args.profile:
        for label, (part, tr, _, _) in cells.items():
            profile_window(label, eval_loop(part, tr), TIMED_EVALS)
        for sched in ("pallas", "combined", "grouped", "packed"):
            profile_window(f"flagship DNA, {sched}",
                           eval_loop(dna, tree, sched), TIMED_EVALS)
        for sched in ("pallas", "combined", "grouped", "packed"):
            profile_window(f"protein, {sched}",
                           eval_loop(prot, ptree, sched), TIMED_EVALS)
        profile_window("BLO, flagship DNA",
                       lambda: blo.optimize_branch_lengths(dna, tree.copy()),
                       1)
        profile_window("BLO, protein",
                       lambda: blo.optimize_branch_lengths(prot,
                                                           ptree.copy()), 1)
        profile_window("BLO LINKED, partitioned",
                       lambda: blo.optimize_branch_lengths_treeinfo(
                           TreeInfo(tree.copy(), [dna, prot2])), 1)
        run_phase_profiles(phase_build, [("flagship DNA", dna, tree),
                                         ("protein", prot, ptree)])
    # kernel 1 at the flagship, 246 x 4465 and capacity shapes: against
    # the parent's, and the phases of a row at the latter two
    k1_shapes = (kernel1_shapes(dna, tree) if args.profile or args.parent
                 else [])
    if args.profile:
        kernel1_phase_profiles(phase_build, k1_shapes[1:])
    if parent_build is not None:
        sm_part, sm_tree = supermatrix_cell()
        print(json.dumps({"kernel1_against_parent": kernel1_against_parent(
            args.parent, k1_shapes + [
                ("protein", resident_args(prot, ptree)),
                ("aa144 supermatrix", resident_args(sm_part, sm_tree))])}))
        del sm_part, sm_tree
    del k1_shapes
    if parent_build is not None:
        print(json.dumps({"parent_compare": parent_compare(
            parent_build, [("flagship DNA", dna, tree),
                           ("protein", prot, ptree),
                           ("64-state", wide, wtree)], NEWTON_SHAPES,
            SUMTABLE_SHAPES)}))
        print(json.dumps({"eval_turns": eval_turns(args.parent)}))
    NEWTON_SHAPES.clear()
    SUMTABLE_SHAPES.clear()
    del cells, dna64, prot64, wide64
    torch.cuda.empty_cache()
    routing = routing_sweep()
    supermatrix = supermatrix_turns()
    sumtable_routing = sumtable_routing_sweep()

    n_inner = FLAGSHIP["n_taxa"] - 2
    rate = n_inner * dna.n_patterns_padded / (ms["flagship DNA"] * 1e-3)
    print(json.dumps({"metric": "clv_pattern_node_updates_per_s",
                      "value": rate, "unit": "updates/s",
                      "ms_per_eval": ms,
                      "ms_per_eval_by_schedule": ms_by_schedule,
                      "gpu": name, "power_limit": power}))
    print(json.dumps({"blo": blo_rows, "sub_sweeps": split}))
    print(json.dumps({"packed": {k: dict(zip(("ms", "host_issue_ms"), v))
                                 for k, v in packed_ms.items()},
                      "partitioned": partitioned}))
    print(json.dumps({"routing": routing, "supermatrix": supermatrix}))
    print(json.dumps({"edge_decomposition": decomp_rows}))
    print(json.dumps({"opt_model": opt_rows}))
    print(json.dumps({"spr": spr_rows, "spr_scorer_checks": spr_scorer}))
    print(json.dumps({"ancestral": anc_row}))
    print(json.dumps({"search": search_row}))
    print(json.dumps({"mesh": mesh_row}))
    print(json.dumps({"capacity": capacity_row}))
    print(json.dumps({"sumtable_routing": sumtable_routing}))
    print(json.dumps({"kernels": kernel_rows}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
