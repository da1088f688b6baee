"""Build, load and launch the CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into its own shared library with a plain
C interface under ``build/`` at the repository root, named by a hash of
the source, the headers they share (``csrc/common.cuh``,
``csrc/tile.cuh``, ``csrc/tables.cuh``, ``csrc/group_walk.cuh``) and the
flags,
on first use; the sources that lack a library are
compiled all at once, one ``nvcc`` each. ctypes loads them. Nothing here
runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import types

from pllmod_tpu_torch.profile import LAUNCHES, RESIDENT_LAUNCHES

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("pruning", "fused", "deriv", "levels", "grouped",
                        "packed")}
# the shared headers (common.cuh is included by every source, tile.cuh by
# pruning.cu, fused.cu, levels.cu and group_walk.cuh, tables.cuh, the
# walks' pre-pass, by pruning.cu, fused.cu and group_walk.cuh, and
# group_walk.cuh, the group-window walk, by packed.cu and grouped.cu);
# every library's hash covers all four
HEADERS = tuple(os.path.join(_PKG, "csrc", h)
                for h in ("common.cuh", "tile.cuh", "tables.cuh",
                          "group_walk.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C entry points: name -> (source, argument types, result type); the
# launches return the CUDA error code of their launch
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WALK_ARGS = [_VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I]
ENTRY_POINTS = {
    # the resident walk: its arguments, then the scratch of its pre-pass
    "pllmod_resident_walk": ("pruning", _WALK_ARGS + [_VP, _VP], _I),
    "pllmod_resident_config": ("pruning", [_I] * 5 + [_VP], _I),
    # the fused walk: its arguments, then the scratch of its pre-pass
    "pllmod_fused_walk": ("fused", _WALK_ARGS + [_VP, _VP], _I),
    "pllmod_fused_tables": ("fused", [_VP, _I, _VP, _VP, _I, _VP, _I, _I, _I,
                                      _VP], _I),
    "pllmod_fused_config": ("fused", [_I] * 4 + [_VP], _I),
    "pllmod_child_config": ("levels", [_I] * 4 + [_VP], _I),
    # kernel 8: ..., Ppad, C, S, the forced tile (0: the rule), whether to
    # force the simple kernel
    "pllmod_edge_sumtables": ("deriv", [_VP, _I, _VP, _VP, _I, _VP, _I, _VP,
                                        _VP, _I, _VP, _VP] + [_I] * 5
                              + [_VP], _I),
    # kernel 8's tiled configuration: C, S, n_codes, Ppad, E, forced tile
    "pllmod_sumtable_config": ("deriv", [_I] * 6 + [_VP], _I),
    "pllmod_edge_derivs": ("deriv", [_VP] * 7 + [_I] * 3 + [_VP], _I),
    # kernel 10: descriptors (device), K, their (C·S, Ppad) on the host,
    # ..., the forced design (0: the rule)
    "pllmod_newton_edges": ("deriv", [_VP, _I, _VP, _VP, _F, _F, _F, _I, _VP,
                                      _VP, _VP, _I, _I, _VP], _I),
    "pllmod_newton_config": ("deriv", [_I, _VP, _I, _VP], _I),
    "pllmod_child_pass": ("levels", [_VP, _I, _I, _VP, _VP, _VP, _I, _VP, _I,
                                     _VP, _I, _VP, _VP] + [_I] * 4 + [_VP],
                          _I),
    # kernels 4 and 5: ..., the tile T, the scratch of their pre-pass
    "pllmod_child2_pass": ("levels", [_VP, _I, _VP, _VP, _VP, _I, _VP, _I,
                                      _VP, _I, _VP, _VP] + [_I] * 5
                           + [_VP, _VP], _I),
    "pllmod_level_combined": ("levels", [_VP, _I] + [_VP] * 4 + [_I, _VP, _I,
                                                                 _VP]
                              + [_I] * 6 + [_VP, _VP], _I),
    # kernels 4 and 5's configuration: mode (0 kernel 4, 1 kernel 5), C, S,
    # n_codes, T
    "pllmod_level_config": ("levels", [_I] * 5 + [_VP], _I),
    # kernels 6 and 7: their tables, ..., the tile T and lanes R, the
    # walk's windows (and kernel 7's member order), the scratch of the
    # pre-pass and of the row table
    "pllmod_grouped_walk": ("grouped", [_VP, _VP, _I, _I, _VP, _VP, _I, _VP,
                                        _I, _VP, _VP] + [_I] * 5
                            + [_VP, _VP, _I, _VP, _VP, _VP], _I),
    "pllmod_grouped_config": ("grouped", [_I] * 5 + [_VP], _I),
    "pllmod_packed_walk": ("packed", [_VP, _VP, _VP, _I, _VP, _I, _VP, _I,
                                      _VP, _I, _VP, _VP] + [_I] * 5
                           + [_VP, _I, _VP, _VP, _VP], _I),
    "pllmod_packed_config": ("packed", [_I] * 5 + [_VP], _I),
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""          # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str, flags=NVCC_FLAGS) -> str:
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(names=tuple(SOURCES), defines=()) -> dict:
    """Compile every source of ``names`` that has no library yet, one
    ``nvcc`` each, all started together, with ``-D`` of each of
    ``defines`` (a build with defines gets libraries of its own);
    returns {source name: library path}. Raises with nvcc's output when
    a build fails. The output of the default build is kept in
    BUILD_LOG."""
    global BUILD_LOG
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    paths = {name: library_path(name, flags) for name in names}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    failed, log = [], ""
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate(timeout=900)
        log += f"== {name}.cu ==\n{out}"
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode})")
        else:
            os.replace(tmp, path)
    if not defines:
        BUILD_LOG += log
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return paths


def entry_points(paths: dict) -> types.SimpleNamespace:
    """The C entry points of ENTRY_POINTS that the libraries at ``paths``
    ({source name: library path}) define, typed, as attributes."""
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    fns = {}
    for name, (src, argtypes, restype) in ENTRY_POINTS.items():
        if src in libs:
            fn = getattr(libs[src], name)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def load() -> types.SimpleNamespace:
    """The kernels' C entry points as attributes (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = entry_points(build())
        return _lib


@contextlib.contextmanager
def using(lib: types.SimpleNamespace):
    """Launch ``lib``'s entry points (:func:`entry_points` of another
    build of some sources) in place of the default build's inside the
    block, through the same wrappers: ``chip_smoke.py --profile`` runs
    the build with phase marks so."""
    global _lib
    default = load()
    with _lock:
        _lib = types.SimpleNamespace(**{**vars(default), **vars(lib)})
    try:
        yield
    finally:
        with _lock:
            _lib = default


# ---------------------------------------------------------------------------
# Launch checks, the kernels' launch configurations and the row-walk
# launch shared by the two walk wrappers (ops/resident.py, ops/fused.py).
# The numbers below are those of csrc/pruning.cu, csrc/fused.cu,
# csrc/levels.cu and csrc/group_walk.cuh; the card tests hold
# resident_config, fused_config, child_config, level_config and
# group_walk_config against the libraries' own.
# ---------------------------------------------------------------------------
MAX_STATES = 64            # widest register tile the kernels instantiate
MAX_THREADS = 256          # __launch_bounds__ of the kernels
SMEM_PER_BLOCK = 232_448   # H100: shared memory one block may opt into
SMS = 132                  # H100 SXM streaming multiprocessors
SMEM_PER_SM = 233_472      # shared memory of one SM (228 KB)
LEVEL_CTAS = 0.95 * SMS    # a per-level kernel's grid: about one CTA an SM
TILES = (128, 64, 32, 16, 8, 4, 2, 1)


def _ladder(S: int) -> int:
    """The register tile MAXS that holds S states (common::dispatch_states)."""
    for m in (4, 8, 16, 20, 32, 64):
        if S <= m:
            return m
    raise ValueError(f"the kernels take at most {MAX_STATES} states, got {S}")


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def pattern_tile(n_cats: int) -> int:
    """Pattern columns per CTA of the resident walk's global kind and of
    the simple sumtable kernel: C·T threads per CTA, at most 256."""
    for T in (64, 32, 16, 8, 4, 2, 1):
        if n_cats * T <= MAX_THREADS:
            return T
    raise ValueError(f"the pruning kernels take at most {MAX_THREADS} rate "
                     f"categories, got {n_cats}")


RESIDENT_META_ROWS = 16    # the resident walk's ring of idx8 rows
RESIDENT_NB = 4            # its ring entries
RESIDENT_KINDS = ("tile", "global", "thread", "split")
# the thread kind: the most categories a thread holds, its patterns a
# thread, its ring entries and the ints of an entry's idx8 row
RESIDENT_THREAD_MAX_C = 8
RESIDENT_THREAD_RP = 1
RESIDENT_THREAD_NB = 4
RESIDENT_ROW_INTS = 8
WARP = 32
# the split kind: the ladder step it takes, its threads a (category,
# pattern) column and its patterns a thread
RESIDENT_SPLIT_MAXS = 20
RESIDENT_SPLIT_H = 2
RESIDENT_SPLIT_RP = 2


def _thread_config(C: int, S: int, n_codes: int, n_slots: int, T: int):
    """The thread kind's configuration at pattern tile T (csrc/pruning.cu
    thread_config), or None: whole consumer warps of RESIDENT_THREAD_RP
    patterns a thread and one producer warp; a ring of RESIDENT_THREAD_NB
    entries (an idx8 row, the row's two tables, two rows of tip codes)
    after their full and empty mbarriers, then the slots and their scaler
    rows."""
    rp, sp = RESIDENT_THREAD_RP, 4
    threads = T // rp + WARP
    if T % (WARP * rp) or threads > MAX_THREADS:
        return None
    q = C * max(S, n_codes) * sp
    ring = RESIDENT_ROW_INTS + 2 * q + 2 * T
    smem = 4 * (4 * RESIDENT_THREAD_NB + RESIDENT_THREAD_NB * ring
                + n_slots * C * S * T + n_slots * T)
    if smem > SMEM_PER_BLOCK:
        return None
    return dict(kind="thread", RP=rp, SP=sp, threads=threads, Q=q,
                ring=ring, smem=smem)


def resident_config(C: int, S: int, n_codes: int, n_slots: int, T: int):
    """The resident walk's launch configuration at pattern tile T
    (csrc/pruning.cu walk_config), or None where none fits: a dict of
    kind, RP (patterns a thread), SP (a table row's stride), threads, Q
    (floats of one row side's table from the pre-pass), ring (floats of a
    ring entry) and smem (bytes). Up to 4 states and
    RESIDENT_THREAD_MAX_C categories the thread kind (a thread owns every
    category of its patterns, no CTA barrier a row; a producer warp fills
    the ring: :func:`_thread_config`), at the tiles where it fits. Else
    (RP 2 up to 4 states, else 1) the tile kind where a ring of 4 entries
    (a row's two tables and its tip codes) fits beside the live slots,
    ``n_slots × C·S × T`` floats and their scaler rows; else, at the
    widest tile (:func:`pattern_tile`) alone, the global kind (tables
    read from the pre-pass's scratch in device memory, a ring of tip
    codes), which keeps small 64-state trees resident.

    At the ladder's 20-state step (17 to 20 states) the split kind takes
    the tile kind's place wherever its threads fill whole warps (C·T a
    multiple of 32, T even): the same ring, slots and shared memory, and
    C·T consumer threads and a producer warp. A consumer owns 10 of a
    (category, pattern pair) column's 20 output states, its partner (the
    lane 16 away in the same warp) the other 10; two patterns a thread
    halve the shared-memory bytes a product, which bound the tile kind,
    the halves' maxima meet by a shuffle and their stores by a
    ``__syncwarp``, and the producer warp issues the ring's copies off
    the row chain. At the 1KITE supermatrix's shape (144 taxa, 413,568
    patterns, 3–5 live slots, +G4) it runs T = 64, 288 threads, one CTA
    an SM: 12.31 ms a launch against the tile kind's 16.06 (PERF.md §6,
    NVIDIA H100 80GB HBM3)."""
    if (C < 1 or not 1 <= S <= MAX_STATES or n_codes < 1
            or n_slots < 1 or T < 1):
        return None
    maxs = _ladder(S)
    if maxs == 4 and C <= RESIDENT_THREAD_MAX_C:
        return _thread_config(C, S, n_codes, n_slots, T)
    rp = 2 if maxs <= 4 else 1
    if T % rp or C * (T // rp) > MAX_THREADS:
        return None
    sp = maxs
    q = C * max(S, n_codes) * sp
    fixed = (2 * RESIDENT_NB + 8 * RESIDENT_META_ROWS
             + _round_up(2 * C * T, 4) + n_slots * C * S * T + n_slots * T)
    codes = _round_up(2 * T, 4)
    base = dict(RP=rp, SP=sp, threads=C * (T // rp), Q=q)
    smem = 4 * (fixed + RESIDENT_NB * (2 * q + codes))
    if smem <= SMEM_PER_BLOCK:
        srp = RESIDENT_SPLIT_RP
        if maxs == RESIDENT_SPLIT_MAXS and T % srp == 0 and C * T % WARP == 0:
            return dict(base, kind="split", RP=srp,
                        threads=RESIDENT_SPLIT_H * C * (T // srp) + WARP,
                        ring=2 * q + codes, smem=smem)
        return dict(kind="tile", ring=2 * q + codes, smem=smem, **base)
    smem = 4 * (fixed + RESIDENT_NB * codes)
    if T != pattern_tile(C) or smem > SMEM_PER_BLOCK:
        return None
    return dict(kind="global", ring=codes, smem=smem, **base)


def waves(cf: dict, T: int, Ppad: int) -> int:
    """Waves of the grid of a walk at pattern tile T with launch
    configuration ``cf`` over Ppad patterns (:func:`ctas_per_sm` CTAs an
    SM at once)."""
    grid = -(-Ppad // T)
    return -(-grid // (SMS * ctas_per_sm(cf["threads"], cf["smem"])))


def resident_tile(C: int, S: int, n_codes: int, n_slots: int, Ppad: int):
    """The resident walk's pattern tile. The thread kind: among the tiles
    where it fits, those whose grid runs in the fewest waves, and of
    them the largest whose grid gives 95 % of the SMs a CTA, else the
    smallest (10,000 × 100,000 DNA +G4, 7 slots: T = 128, 782 CTAs, 3
    an SM, two waves). The tile kind (or the split kind in its place):
    among the tiles where it fits, the largest whose grid fills the card
    at up to two CTAs an SM (at least 95 % of 132 × min(2, the CTAs an
    SM holds): protein at 4096 patterns takes T = 32, 128 CTAs, one an
    SM), else the smallest; where the tile kind fits at no tile, the
    widest tile if the global kind fits there; None where the live slots
    fit at no tile."""
    threads = [(T, waves(cf, T, Ppad)) for T in TILES
               if (cf := resident_config(C, S, n_codes, n_slots, T))
               and cf["kind"] == "thread"]
    if threads:
        least = min(n for _, n in threads)
        fewest = [T for T, n in threads if n == least]
        return next((T for T in fewest if -(-Ppad // T) >= 0.95 * SMS),
                    fewest[-1])
    staged = [(T, cf) for T in TILES
              if (cf := resident_config(C, S, n_codes, n_slots, T))
              and cf["kind"] in ("tile", "split")]
    for T, cf in staged:
        k = min(2, ctas_per_sm(cf["threads"], cf["smem"]))
        if -(-Ppad // T) >= 0.95 * SMS * k:
            return T
    if staged:
        return staged[-1][0]
    T = pattern_tile(C)
    return T if resident_config(C, S, n_codes, n_slots, T) else None


FUSED_META_BYTES = 128     # the fused walk's ring of 4 idx8 rows
FUSED_KINDS = ("thread", "tile", "fallback")


def fused_config(C: int, S: int, n_codes: int, T: int):
    """The fused walk's launch configuration at pattern tile T
    (csrc/fused.cu walk_config), or None where none fits: a dict of kind,
    RI, RP, IG, SP, NB, threads, Q (floats of one row side's matrix or tip
    table in the pre-pass scratch), smem (bytes), depth (the sides of a
    row fetched before an earlier row ends, which the kernel forwards)
    and lookback (how many rows back such a writer may be). Up to 8
    states the thread walk ("thread": one thread a category and pattern,
    children fetched two rows ahead; NB = 3 row buffers of tables in
    shared memory, or 0 where they do not fit); beyond, the staged tile
    walk ("tile": RI × RP = 8 × 4 register tiles, 4 × 4 at 20 states, a
    ring of NB stage buffers) where its threads and one stage buffer fit,
    else the fallback ("fallback": one thread a category and pattern,
    matrices read from device memory)."""
    if C < 1 or not 1 <= S <= MAX_STATES or n_codes < 1 or T < 1:
        return None
    maxs = _ladder(S)
    rows = max(S, n_codes)
    if maxs <= 8:
        rpt = 2 if maxs <= 4 else 1       # patterns a thread
        if T % rpt or C * (T // rpt) > MAX_THREADS:
            return None
        sp = _round_up(S, 4)
        q, red = C * rows * sp, _round_up(2 * C * T, 4) + 8 * 8  # + idx8
        nb = 3 if 4 * (6 * q + red) <= SMEM_PER_BLOCK else 0
        return dict(kind="thread", RI=maxs, RP=rpt, IG=1, SP=sp, NB=nb,
                    threads=C * (T // rpt), Q=q,
                    smem=4 * (6 * q + red if nb else red), depth=2,
                    lookback=2)
    for kind in ("tile", "fallback"):
        ri, rp = ((4 if maxs == 20 else 8), 4) if kind == "tile" else (maxs, 1)
        ig = -(-S // ri)
        sp = ig * ri
        threads = C * ig * (T // rp)
        if T % rp or threads > MAX_THREADS:
            continue
        q = C * rows * sp
        sb = _round_up((q if kind == "tile" else 0) + C * S * T + 2 * T, 4)
        for nb in (3, 2, 1):
            smem = 4 * (nb * sb + _round_up(C * ig * T, 4)) + FUSED_META_BYTES
            if smem <= SMEM_PER_BLOCK:
                return dict(kind=kind, RI=ri, RP=rp, IG=ig, SP=sp, NB=nb,
                            threads=threads, Q=q, smem=smem, depth=nb - 1,
                            lookback=1)
    return None


def ctas_per_sm(threads: int, smem: int) -> int:
    """CTAs of ``threads`` threads and ``smem`` bytes of shared memory
    that one SM holds at once (threads, shared memory with the 1 KB each
    CTA reserves, and the 32-CTA limit)."""
    return min(32, 2048 // threads, SMEM_PER_SM // (smem + 1024))


def fused_tile(C: int, S: int, n_codes: int, Ppad: int) -> int:
    """The fused walk's pattern tile: the largest tile of TILES (thread or
    staged tile walk) whose grid fills the card at up to two CTAs an SM
    (at least 95 % of 132 × min(2, the CTAs an SM holds): 64 states at
    4096 patterns take T = 32, 128 CTAs of 256 threads, one an SM), else
    the smallest such; where none but the fallback fits, the largest
    fallback tile."""
    staged = [(T, cf) for T in TILES
              if (cf := fused_config(C, S, n_codes, T))
              and cf["kind"] != "fallback"]
    for T, cf in staged:
        k = min(2, ctas_per_sm(cf["threads"], cf["smem"]))
        if -(-Ppad // T) >= 0.95 * SMS * k:
            return T
    if staged:
        return staged[-1][0]
    for T in TILES:
        if fused_config(C, S, n_codes, T):
            return T
    raise ValueError(f"the fused walk takes no tile at {C} categories, "
                     f"{S} states and {n_codes} codes")


GROUP_WALK_THREADS = 512   # __launch_bounds__ of the group-window walks
GROUP_WALK_KINDS = ("thread", "tile", "wide")
GROUP_WALK_LANES = (4, 2, 1)
GROUP_WALK_MAX_LANES = 8   # group_walk.cuh kMaxLanes
GROUP_WALK_ROW = 8         # ints of a row's entry in the row table
GROUP_WALK_RING = 4 * GROUP_WALK_ROW   # ints a lane in the ring of steps
# the tile walk's mbarriers and the slack that aligns its stage buffers
# to 128 bytes
GROUP_WALK_BARS, GROUP_WALK_ALIGN = 16, 128
# registers a thread of each kind, from nvcc's report (ptxas -v) of the
# libraries: the tile walk takes the 128 that 512 threads allow
GROUP_WALK_REGS = {"thread": 64, "tile": 128, "wide": 128}


@functools.lru_cache(maxsize=None)
def group_walk_config(C: int, S: int, n_codes: int, T: int, R: int):
    """The group-window walk's launch configuration (kernels 6 and 7) at
    pattern tile T and R row lanes (csrc/group_walk.cuh walk_config; R at
    most GROUP_WALK_MAX_LANES), or None where none fits: a dict of kind,
    RI, RP, IG, SP, threads, Q (floats of one side's matrix or tip table
    in the pre-pass scratch), smem (bytes) and staged. Up to 8 states the
    thread walk ("thread": a thread a lane, category and RP patterns, 2
    up to 4 states; the category maxima of two steps and the ring of
    step tables in shared memory); beyond, the tile walk ("tile": RI ×
    RP = 8 × 4 register tiles, 4 × 4 at 20 states; two stage buffers of
    R rows' two children, 128-byte aligned, with each side's table where
    that fits a block: staged = 1; its child tiles come by tensor copies
    where C·S ≤ 256, T and Ppad are multiples of 4, else by cp.async;
    the category maxima of two steps) where its threads fit, else the
    wide kind ("wide": RI = MAXS, RP = 1). Cached per shape, as
    :func:`group_walk_tile` is: every evaluation launches the walk."""
    if (C < 1 or not 1 <= S <= MAX_STATES or n_codes < 1 or T < 1
            or not 1 <= R <= GROUP_WALK_MAX_LANES):
        return None
    maxs = _ladder(S)
    rows = max(S, n_codes)
    ring = GROUP_WALK_RING * R         # ints of the ring of step tables
    if maxs <= 8:
        rp = 2 if maxs <= 4 else 1
        threads = R * C * (T // rp)
        smem = 4 * (_round_up(2 * R * C * T, 4) + ring)
        if (T % rp or threads > GROUP_WALK_THREADS
                or smem > SMEM_PER_BLOCK):
            return None
        return dict(kind="thread", RI=maxs, RP=rp, IG=1, SP=maxs,
                    threads=threads, Q=C * rows * maxs, smem=smem, staged=0)
    for kind in ("tile", "wide"):
        ri, rp = ((4 if maxs == 20 else 8), 4) if kind == "tile" \
            else (maxs, 1)
        if T % rp:
            continue
        ig = -(-S // ri)
        threads = R * C * ig * (T // rp)
        if threads > GROUP_WALK_THREADS:
            continue
        q = C * rows * ig * ri
        for staged in (1, 0):
            sb = _round_up(_round_up(q * staged, 32) + C * S * T + 2 * T, 32)
            smem = (4 * (4 * R * sb + _round_up(2 * R * C * ig * T, 4)
                         + ring)
                    + GROUP_WALK_BARS + GROUP_WALK_ALIGN)
            if smem <= SMEM_PER_BLOCK:
                return dict(kind=kind, RI=ri, RP=rp, IG=ig, SP=ig * ri,
                            threads=threads, Q=q, smem=smem, staged=staged)
    return None


@functools.lru_cache(maxsize=None)
def group_walk_tile(C: int, S: int, n_codes: int, Ppad: int):
    """(pattern tile T, row lanes R) of the group-window walk. Among the
    configurations of GROUP_WALK_LANES × TILES that are not the wide
    kind, the one whose grid fills the card (at least 95 % of 132 CTAs),
    then runs in the fewest waves (CTAs an SM by threads, shared memory
    and GROUP_WALK_REGS registers a thread), then has the most lanes,
    then the widest tile; where the register tile fits nowhere, the same
    over the wide kind. Cached per shape, as :func:`group_walk_config`
    is: every evaluation launches the walk. Raises where nothing fits."""
    for kinds in (("thread", "tile"), ("wide",)):
        best, key = None, None
        for R in GROUP_WALK_LANES:
            for T in TILES:
                cf = group_walk_config(C, S, n_codes, T, R)
                if cf is None or cf["kind"] not in kinds:
                    continue
                grid = -(-Ppad // T)
                k = max(1, min(ctas_per_sm(cf["threads"], cf["smem"]),
                               65536 // (cf["threads"]
                                         * GROUP_WALK_REGS[cf["kind"]])))
                cand = (grid >= 0.95 * SMS, -(-grid // (SMS * k)) * -1, R, T)
                if key is None or cand > key:
                    best, key = (T, R), cand
        if best:
            return best
    raise ValueError(f"the group-window walk takes no tile at {C} "
                     f"categories, {S} states and {n_codes} codes")


def launch_group_walk(name: str, device, mats_rows: int, n_rows: int,
                      C: int, S: int, n_codes: int, Ppad: int, tile, lanes,
                      args_before, args_after) -> None:
    """Launch kernel 6 or 7 (``name``) at ``tile`` and ``lanes`` (by
    default :func:`group_walk_tile`'s) with the scratch of its pre-pass
    (``mats_rows`` sides) and of its row table (``n_rows`` rows of
    GROUP_WALK_ROW ints): ``args_before`` are the entry point's
    arguments up to Ppad, C, S, ``args_after`` those between the lanes
    and the scratch. Raises where the configuration does not fit."""
    import torch
    if S > MAX_STATES:
        raise ValueError(f"{name}: at most {MAX_STATES} states, got {S}")
    if tile is None or lanes is None:
        T0, R0 = group_walk_tile(C, S, n_codes, Ppad)
        tile, lanes = tile or T0, lanes or R0
    T, R = tile, lanes
    cf = group_walk_config(C, S, n_codes, T, R)
    if cf is None:
        raise ValueError(f"{name}: no launch configuration at tile {T}, "
                         f"{R} lanes")
    mats = torch.empty((mats_rows, cf["Q"]), dtype=torch.float32,
                       device=device)
    rowtab = torch.empty((n_rows, GROUP_WALK_ROW), dtype=torch.int32,
                         device=device)
    launch(name, device, *args_before, Ppad, C, S, T, R, *args_after,
           mats.data_ptr(), rowtab.data_ptr())


def child_config(C: int, S: int, n_codes: int, T: int):
    """The child pass's launch configuration at pattern tile T
    (csrc/levels.cu child_config), or None: a dict of RI, IG, SP, CB
    (categories a CTA), lookup (tip children from a table, where
    n_codes <= T), threads, mrows (rows of SP floats a category: the
    transposed matrix, and the tip table with the lookup) and smem
    (bytes)."""
    if C < 1 or not 1 <= S <= MAX_STATES or n_codes < 1 or T < 4 or T % 4:
        return None
    ri = 4 if _ladder(S) in (4, 20) else 8
    ig = -(-S // ri)
    sp = ig * ri
    per_c = ig * (T // 4)
    if per_c > MAX_THREADS:
        return None
    for lookup in ((1, 0) if n_codes <= T else (0,)):
        mrows = S + (n_codes if lookup else 0)
        unit = mrows * sp + S * T
        cb = min(MAX_THREADS // per_c, C,
                 (SMEM_PER_BLOCK // 4 - 2 * T) // unit)
        if cb >= 1:
            return dict(RI=ri, IG=ig, SP=sp, CB=cb, lookup=lookup,
                        threads=cb * per_c, mrows=mrows,
                        smem=4 * (cb * unit + 2 * T))
    return None


def child_tile(C: int, S: int, n_codes: int, Ppad: int, W: int) -> int:
    """The child pass's pattern tile for a level of W rows: the largest of
    TILES whose grid (tiles × W × category blocks) has at least
    LEVEL_CTAS CTAs, else the smallest that fits."""
    fits = [(T, cf) for T in TILES if (cf := child_config(C, S, n_codes, T))]
    if not fits:
        raise ValueError(f"the child pass takes no tile at {C} categories, "
                         f"{S} states and {n_codes} codes")
    for T, cf in fits:
        if -(-Ppad // T) * W * -(-C // cf["CB"]) >= LEVEL_CTAS:
            return T
    return fits[-1][0]


LEVEL_MODES = ("child2", "combined")    # kernels 4 and 5: mode + 1 sides
LEVEL_KINDS = ("simple", "tile")
LEVEL_THREADS = 512        # __launch_bounds__ of kernels 4 and 5's tiled one
LEVEL_TILES = (256,) + TILES


@functools.lru_cache(maxsize=None)
def level_config(mode: str, C: int, S: int, n_codes: int, T: int):
    """Kernel 4's (``mode`` "child2") or 5's ("combined") launch
    configuration at pattern tile T (csrc/levels.cu level_config), or
    None: a dict of kind, RI (states a thread), IG, SP, Q (floats of a
    side's table from the pre-pass), threads and smem (bytes). The tiled
    kernel ("tile": thread (c, ig, pg) owns RI × 4 patterns of category
    c, every category in one CTA; each row side's transposed matrix or
    tip table built once by a pre-pass into a scratch of W·sides·Q
    floats) where T is a multiple of 4 and its C·IG·T/4 threads (at most
    LEVEL_THREADS) and shared memory fit: each side's region (a tip's
    table [Q], Q = C·max(S, n_codes)·SP, or an inner child's matrix
    [C·S·SP] and tile [C·S][T]), the maxima [C·IG][T] and the tip codes
    [sides][T]; else the simple kernel ("simple": thread (c, p), RI = the
    register tile MAXS, Q = 0) where its C·T threads fit, its matrices
    and code table staged where they fit a block. Cached per shape: every
    level launches it."""
    if (mode not in LEVEL_MODES or C < 1 or not 1 <= S <= MAX_STATES
            or n_codes < 1 or T < 1):
        return None
    sides = LEVEL_MODES.index(mode) + 1
    maxs = _ladder(S)
    ri = 4 if maxs in (4, 20) else 8
    ig = -(-S // ri)
    sp = ig * ri
    if T % 4 == 0:
        threads = C * ig * (T // 4)
        q = C * max(S, n_codes) * sp
        smem = 4 * (sides * max(q, C * S * (sp + T)) + C * ig * T
                    + sides * T)
        if threads <= LEVEL_THREADS and smem <= SMEM_PER_BLOCK:
            return dict(kind="tile", RI=ri, IG=ig, SP=sp, Q=q,
                        threads=threads, smem=smem)
    if C * T <= MAX_THREADS:
        stage = n_codes * S + sides * C * S * S
        staged = 4 * (C * T + stage) <= SMEM_PER_BLOCK
        return dict(kind="simple", RI=maxs, IG=1, SP=S, Q=0, threads=C * T,
                    smem=4 * (C * T + (stage if staged else 0)))
    return None


@functools.lru_cache(maxsize=None)
def level_tile(mode: str, C: int, S: int, n_codes: int, Ppad: int,
               W: int) -> int:
    """Kernel 4's or 5's pattern tile for a level of W rows: among the
    tiles of LEVEL_TILES where the tiled kernel fits, the largest whose
    grid (tiles × W) has at least LEVEL_CTAS CTAs, else the smallest whose
    CTA has a warp's threads or more (a narrower one copies the row's
    tables with fewer threads), else the largest; where the tiled kernel
    fits at no tile, the same over the simple kernel's tiles. Raises where
    nothing fits."""
    for kind in ("tile", "simple"):
        fits = [(T, cf["threads"]) for T in LEVEL_TILES
                if (cf := level_config(mode, C, S, n_codes, T))
                and cf["kind"] == kind]
        for T, _ in fits:
            if -(-Ppad // T) * W >= LEVEL_CTAS:
                return T
        warps = [T for T, threads in fits if threads >= 32]
        if warps or fits:
            return warps[-1] if warps else fits[0][0]
    raise ValueError(f"kernel {mode!r} takes no tile at {C} categories, "
                     f"{S} states and {n_codes} codes")


SUMTABLE_TILES = (256, 128, 64, 32, 16, 8, 4)
SUMTABLE_BOX_ROWS = 256        # rows of one tensor copy's box
SUMTABLE_MIN_THREADS = 128     # the rule's least CTA (4 warps)


@functools.lru_cache(maxsize=None)
def sumtable_config(C: int, S: int, n_codes: int, Ppad: int, E: int,
                    tile: int | None = None):
    """Kernel 8's tiled launch configuration for E edges (csrc/deriv.cu
    sumtable_config), or None where the tiled kernel takes none and the
    simple kernel runs: a dict of T (pattern tile), RI (states a thread),
    IG, SP (states padded to whole i-groups), threads (C · IG · T / 4)
    and smem (bytes: 128 of alignment slack; the ring's two mbarriers,
    the two bases and the tip tables; two stages of both sides' CLV
    tiles, codes and scalers, each 128-byte aligned). The rule, from
    ``chip_smoke.py``'s kernel-8 sweep: where C·S fits one tensor copy's
    box (SUMTABLE_BOX_ROWS), the widest tile of SUMTABLE_TILES that
    divides Ppad with at most 256 threads and whose stages fit a block's
    shared memory; None instead where that CTA has fewer than
    SUMTABLE_MIN_THREADS threads or the launch fewer items (E · Ppad / T)
    than the card has SMs. ``tile`` forces a tile (then only the fit
    counts). Cached per shape: the BLO launches kernel 8 a hundred times
    a call."""
    if (C < 1 or not 1 <= S <= MAX_STATES or n_codes < 1 or Ppad < 1
            or C * S > SUMTABLE_BOX_ROWS):
        return None
    ri = 4 if _ladder(S) in (4, 20) else 8
    ig = -(-S // ri)
    sp = ig * ri
    fixed = _round_up(32 + 2 * C * S * sp + 2 * C * n_codes * sp, 32)
    for T in SUMTABLE_TILES:
        if tile not in (None, T) or Ppad % T:
            continue
        threads = C * ig * (T // 4)
        stage = _round_up(2 * _round_up(C * S * T, 32) + 4 * T, 32)
        smem = 4 * (fixed + 2 * stage) + 128
        if threads > MAX_THREADS or smem > SMEM_PER_BLOCK:
            continue
        if tile is None and (threads < SUMTABLE_MIN_THREADS
                             or E * (Ppad // T) < SMS):
            return None
        return dict(T=T, RI=ri, IG=ig, SP=sp, threads=threads, smem=smem)
    return None


def check_tensors(name: str, specs) -> None:
    """Raise unless every (tensor, dtype, shape or None) of ``specs`` is a
    contiguous tensor of that dtype and shape on the first one's CUDA
    device."""
    dev = specs[0][0].device
    for t, dt, shape in specs:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor, "
                             f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def launch(name: str, device, *args, key: str | None = None) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream
    (appended as the last argument); raise if the launch failed. Every
    launch of the port is counted here, in ``profile.LAUNCHES`` under
    ``key`` (by default ``name``)."""
    import torch
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[key or name] += 1


@functools.lru_cache(maxsize=None)
def walk_launch_config(name: str, C: int, S: int, n_codes: int,
                       n_slots: int, Ppad: int, tile: int | None = None):
    """(pattern tile, launch configuration) of a row walk at one shape,
    computed once a shape (the bounded sweep issues hundreds of short
    walks a call): the resident walk at :func:`resident_tile`'s tile, the
    fused walk at :func:`fused_tile`'s, or each at ``tile``. Raises where
    the walk takes no configuration."""
    if S > MAX_STATES:
        raise ValueError(f"{name}: at most {MAX_STATES} states, got {S}")
    if name == "pllmod_resident_walk":
        T = resident_tile(C, S, n_codes, n_slots, Ppad) if tile is None \
            else tile
        cf = None if T is None else resident_config(C, S, n_codes, n_slots,
                                                    T)
        if cf is None:
            raise ValueError(
                f"{name}: {n_slots} live slots of {C} categories × {S} "
                f"states fit a block's shared memory at no pattern tile "
                f"(tile {T})")
        return T, cf
    T = fused_tile(C, S, n_codes, Ppad) if tile is None else tile
    cf = fused_config(C, S, n_codes, T)
    if cf is None:
        raise ValueError(f"{name}: no launch configuration at tile {T}")
    return T, cf


def launch_walk(name, idx8, P5, tip_codes, codetab, clv_out, sc_out,
                n_slots: int, tile: int | None = None) -> None:
    """Check the inputs of a row-walk kernel and launch it on the current
    stream at pattern tile ``tile`` (by default the walk's own choice,
    :func:`walk_launch_config`), with the scratch of its pre-pass; a
    resident walk's launch is counted by kind in
    ``profile.RESIDENT_LAUNCHES`` too. Raises on anything the kernel
    does not take."""
    import torch
    nW = idx8.shape[0]
    _, _, C, S, _ = P5.shape
    n_tips, Ppad = tip_codes.shape
    n_codes = codetab.shape[0]
    check_tensors(name, [(idx8, torch.int32, (nW, 8)),
                         (P5, torch.float32, (nW, 2, C, S, S)),
                         (tip_codes, torch.int32, (n_tips, Ppad)),
                         (codetab, torch.float32, (n_codes, S)),
                         (clv_out, torch.float32, None),
                         (sc_out, torch.int32, None)])
    T, cf = walk_launch_config(name, C, S, n_codes, n_slots, Ppad, tile)
    mats = torch.empty((nW, 2, cf["Q"]), dtype=torch.float32,
                       device=P5.device)
    launch(name, P5.device, idx8.data_ptr(), nW, P5.data_ptr(),
           tip_codes.data_ptr(), codetab.data_ptr(), n_codes,
           clv_out.data_ptr(), sc_out.data_ptr(), Ppad, C, S, n_slots, T,
           mats.data_ptr())
    if name == "pllmod_resident_walk":
        RESIDENT_LAUNCHES[cf["kind"]] += 1
