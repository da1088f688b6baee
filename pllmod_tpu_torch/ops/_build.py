"""Build, load and launch the CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into its own shared library with a plain
C interface under ``build/`` at the repository root, named by a hash of
the source, the headers they share (``csrc/configs.h``,
``csrc/common.cuh``, ``csrc/tile.cuh``, ``csrc/tables.cuh``,
``csrc/group_walk.cuh``) and the flags, on first use; the sources that
lack a library are compiled all at once, one ``nvcc`` each. ctypes loads
them. The kernels' launch configurations come from ``csrc/configs.h``
too, built for the host by ``g++`` (:func:`configs`). Nothing here runs
at import time: the CPU-only tests import every module.
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

from pllmod_tpu_torch import native
from pllmod_tpu_torch.profile import LAUNCHES, RESIDENT_LAUNCHES

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("pruning", "fused", "deriv", "levels", "grouped",
                        "packed")}
# the shared headers (configs.h, the launch configurations, and
# common.cuh are included by every source, tile.cuh by pruning.cu,
# fused.cu, levels.cu, deriv.cu and group_walk.cuh, tables.cuh, the
# walks' pre-pass, by pruning.cu, fused.cu, levels.cu and group_walk.cuh,
# and group_walk.cuh, the group-window walk, by packed.cu and grouped.cu);
# every library's hash covers all five
HEADERS = tuple(os.path.join(_PKG, "csrc", h)
                for h in ("configs.h", "common.cuh", "tile.cuh",
                          "tables.cuh", "group_walk.cuh"))
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
    # the fused walk: its arguments, then the scratch of its pre-pass
    "pllmod_fused_walk": ("fused", _WALK_ARGS + [_VP, _VP], _I),
    "pllmod_fused_tables": ("fused", [_VP, _I, _VP, _VP, _I, _VP, _I, _I, _I,
                                      _VP], _I),
    # kernel 8: ..., Ppad, C, S, the forced tile (0: the rule), whether to
    # force the simple kernel
    "pllmod_edge_sumtables": ("deriv", [_VP, _I, _VP, _VP, _I, _VP, _I, _VP,
                                        _VP, _I, _VP, _VP] + [_I] * 5
                              + [_VP], _I),
    # the CTAs an SM the card holds of kernel 8's tiled kernel: C, S,
    # n_codes, Ppad, E, forced tile
    "pllmod_sumtable_occupancy": ("deriv", [_I] * 6, _I),
    "pllmod_edge_derivs": ("deriv", [_VP] * 7 + [_I] * 3 + [_VP], _I),
    # kernel 10: descriptors (device), K, their (C·S, Ppad) on the host,
    # ..., the forced design (0: the rule)
    "pllmod_newton_edges": ("deriv", [_VP, _I, _VP, _VP, _F, _F, _F, _I, _VP,
                                      _VP, _VP, _I, _I, _VP], _I),
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
    # kernels 6 and 7: their tables, ..., the tile T and lanes R, the
    # walk's windows (and kernel 7's member order), the scratch of the
    # pre-pass and of the row table
    "pllmod_grouped_walk": ("grouped", [_VP, _VP, _I, _I, _VP, _VP, _I, _VP,
                                        _I, _VP, _VP] + [_I] * 5
                            + [_VP, _VP, _I, _VP, _VP, _VP], _I),
    "pllmod_packed_walk": ("packed", [_VP, _VP, _VP, _I, _VP, _I, _VP, _I,
                                      _VP, _I, _VP, _VP] + [_I] * 5
                           + [_VP, _I, _VP, _VP, _VP], _I),
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
# The kernels' launch configurations: csrc/configs.h computes them, for
# the kernels (included by every CUDA source) and for the host (built from
# csrc/configs.cpp by g++ into the library that configs() loads). The
# readers below return each as a dict, cached per shape; the tile rules
# and the row-walk launch shared by the two walk wrappers (ops/resident.py,
# ops/fused.py) choose among them.
# ---------------------------------------------------------------------------
CONFIGS_SOURCE = os.path.join(_PKG, "csrc", "configs.cpp")
CONFIGS_HEADER = os.path.join(_PKG, "csrc", "configs.h")
CONFIGS_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
# the host library's entry points: name -> argument types before the
# long long out[] that each fills
_CONFIG_ARGS = {
    "pllmod_resident_config": [_I] * 5,
    "pllmod_fused_config": [_I] * 4,
    "pllmod_child_config": [_I] * 4,
    "pllmod_level_config": [_I] * 5,
    "pllmod_group_walk_config": [_I] * 5,
    "pllmod_sumtable_config": [_I] * 6,
    "pllmod_newton_config": [_I, _VP, _I],
}
_configs = None

MAX_STATES = 64            # widest register tile the kernels instantiate
MAX_THREADS = 256          # __launch_bounds__ of the kernels
SMEM_PER_BLOCK = 232_448   # H100: shared memory one block may opt into
SMS = 132                  # H100 SXM streaming multiprocessors
SMEM_PER_SM = 233_472      # shared memory of one SM (228 KB)
WARP = 32
LEVEL_CTAS = 0.95 * SMS    # a per-level kernel's grid: about one CTA an SM
TILES = (128, 64, 32, 16, 8, 4, 2, 1)


def configs() -> ctypes.CDLL:
    """The host library of the launch configurations, built on first use
    (``native.load_host_library``: ``build/pllmod_configs-<hash>.so``, the
    hash over csrc/configs.cpp, csrc/configs.h and the flags). Raises
    where g++ is missing or the source does not compile."""
    global _configs
    with _lock:
        if _configs is None:
            if shutil.which("g++") is None:
                raise RuntimeError(
                    "g++ not found: the kernels' launch configurations "
                    "(csrc/configs.cpp) are built with g++")
            try:
                lib = native.load_host_library(
                    "pllmod_configs", CONFIGS_SOURCE, CONFIGS_FLAGS,
                    BUILD_DIR, headers=(CONFIGS_HEADER,))
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"g++ failed on csrc/configs.cpp:\n"
                                   f"{e.stderr}") from e
            for name, argtypes in _CONFIG_ARGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes + [_VP]
                fn.restype = _I
            _configs = lib
        return _configs


def query_config(name: str, keys, kinds, *args):
    """The configuration that the host library's ``name`` returns at
    ``args`` as a dict of ``keys`` (its "kind" named by ``kinds``), or
    None where none fits."""
    out = (ctypes.c_longlong * len(keys))()
    if not getattr(configs(), name)(*args, out):
        return None
    cf = dict(zip(keys, out))
    if kinds:
        cf["kind"] = kinds[cf["kind"]]
    return cf


def pattern_tile(n_cats: int) -> int:
    """Pattern columns per CTA of the resident walk's global kind and of
    the simple sumtable kernel: C·T threads per CTA, at most 256."""
    for T in (64, 32, 16, 8, 4, 2, 1):
        if n_cats * T <= MAX_THREADS:
            return T
    raise ValueError(f"the pruning kernels take at most {MAX_THREADS} rate "
                     f"categories, got {n_cats}")


RESIDENT_KINDS = ("tile", "global", "thread", "split")
RESIDENT_THREAD_RP = 1     # the thread kind's patterns a thread


@functools.lru_cache(maxsize=None)
def resident_config(C: int, S: int, n_codes: int, n_slots: int, T: int):
    """The resident walk's launch configuration at pattern tile T
    (csrc/configs.h resident::walk_config), or None where none fits: a
    dict of kind (RESIDENT_KINDS), RP (patterns a thread), SP (a table
    row's stride), threads, Q (floats of one row side's table from the
    pre-pass), ring (floats of a ring entry) and smem (bytes). Up to 4
    states and 8 categories the thread kind, at the tiles where it fits;
    else the tile kind where a ring of 4 entries fits beside the live
    slots, the split kind in its place at 17 to 20 states where its
    threads fill whole warps; else, at the widest tile
    (:func:`pattern_tile`) alone, the global kind."""
    return query_config(
        "pllmod_resident_config",
        ("kind", "RP", "SP", "threads", "Q", "ring", "smem"),
        RESIDENT_KINDS, C, S, n_codes, n_slots, T)


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


FUSED_KINDS = ("thread", "tile", "fallback")


@functools.lru_cache(maxsize=None)
def fused_config(C: int, S: int, n_codes: int, T: int):
    """The fused walk's launch configuration at pattern tile T
    (csrc/configs.h fused::walk_config), or None where none fits: a dict
    of kind (FUSED_KINDS), RI, RP, IG, SP, NB, threads, Q (floats of one
    row side's matrix or tip table in the pre-pass scratch), smem
    (bytes), depth (the sides of a row fetched before an earlier row
    ends, which the kernel forwards) and lookback (how many rows back
    such a writer may be). Up to 8 states the thread walk; beyond, the
    staged tile walk where its threads and one stage buffer fit, else
    the fallback (matrices read from device memory)."""
    return query_config(
        "pllmod_fused_config",
        ("kind", "RI", "RP", "IG", "SP", "NB", "threads", "Q", "smem",
         "depth", "lookback"),
        FUSED_KINDS, C, S, n_codes, T)


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


GROUP_WALK_KINDS = ("thread", "tile", "wide")
GROUP_WALK_LANES = (4, 2, 1)
GROUP_WALK_ROW = 8         # ints of a row's entry in the row table
# registers a thread of each kind, from nvcc's report (ptxas -v) of the
# libraries: the tile walk takes the 128 that 512 threads allow
GROUP_WALK_REGS = {"thread": 64, "tile": 128, "wide": 128}


@functools.lru_cache(maxsize=None)
def group_walk_config(C: int, S: int, n_codes: int, T: int, R: int):
    """The group-window walk's launch configuration (kernels 6 and 7) at
    pattern tile T and R row lanes (csrc/configs.h group_walk::
    walk_config), or None where none fits: a dict of kind
    (GROUP_WALK_KINDS), RI, RP, IG, SP, threads, Q (floats of one side's
    matrix or tip table in the pre-pass scratch), smem (bytes) and staged
    (1 where the tile walk stages each side's table beside its child).
    Up to 8 states the thread walk; beyond, the tile walk where its
    threads fit, else the wide kind. Cached per shape, as
    :func:`group_walk_tile` is: every evaluation launches the walk."""
    return query_config(
        "pllmod_group_walk_config",
        ("kind", "RI", "RP", "IG", "SP", "threads", "Q", "smem",
         "staged"),
        GROUP_WALK_KINDS, C, S, n_codes, T, R)


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


@functools.lru_cache(maxsize=None)
def child_config(C: int, S: int, n_codes: int, T: int):
    """The child pass's launch configuration at pattern tile T
    (csrc/configs.h levels::child_config), or None: a dict of RI, IG, SP,
    CB (categories a CTA), lookup (tip children from a table, where
    n_codes <= T), threads, mrows (rows of SP floats a category: the
    transposed matrix, and the tip table with the lookup) and smem
    (bytes)."""
    return query_config(
        "pllmod_child_config",
        ("RI", "IG", "SP", "CB", "lookup", "threads", "mrows", "smem"),
        None, C, S, n_codes, T)


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
LEVEL_TILES = (256,) + TILES


@functools.lru_cache(maxsize=None)
def level_config(mode: str, C: int, S: int, n_codes: int, T: int):
    """Kernel 4's (``mode`` "child2") or 5's ("combined") launch
    configuration at pattern tile T (csrc/configs.h levels::
    level_config), or None: a dict of kind (LEVEL_KINDS), RI (states a
    thread), IG, SP, Q (floats of a side's table from the pre-pass),
    threads and smem (bytes). The tiled kernel where T is a multiple of 4
    and its threads and shared memory fit, else the simple kernel where
    its C·T threads fit. Cached per shape: every level launches it."""
    if mode not in LEVEL_MODES:
        return None
    return query_config(
        "pllmod_level_config",
        ("kind", "RI", "IG", "SP", "Q", "threads", "smem"),
        LEVEL_KINDS, LEVEL_MODES.index(mode), C, S, n_codes, T)


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


@functools.lru_cache(maxsize=None)
def sumtable_config(C: int, S: int, n_codes: int, Ppad: int, E: int,
                    tile: int | None = None):
    """Kernel 8's tiled launch configuration for E edges (csrc/configs.h
    deriv::sumtable_config), or None where the tiled kernel takes none
    and the simple kernel runs: a dict of T (pattern tile), RI (states a
    thread), IG, SP (states padded to whole i-groups), threads and smem
    (bytes). The rule, from ``chip_smoke.py``'s kernel-8 sweep: where C·S
    fits one tensor copy's box, the widest tile of SUMTABLE_TILES that
    divides Ppad and fits; None instead where that CTA has fewer than 4
    warps or the launch fewer items (E · Ppad / T) than the card has SMs.
    ``tile`` forces a tile (then only the fit counts). Cached per shape:
    the BLO launches kernel 8 a hundred times a call."""
    return query_config(
        "pllmod_sumtable_config",
        ("T", "RI", "IG", "SP", "threads", "smem"),
        None, C, S, n_codes, Ppad, E, tile or 0)


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
