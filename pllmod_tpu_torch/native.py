"""ctypes bindings for the native C++ host-runtime kernels.

The port's own build of ``native/pllmod_native.cpp``, the source the JAX
package compiles too: g++ -O3 -march=native into the gitignored
``build/`` at the repository root, as ``pllmod_native-<hash>.so`` (a
hash of the source and the flags, as ``ops/_build.library_path`` names
the CUDA libraries). The port never writes ``native/libpllmod_native.so``,
the file the JAX package builds and loads. The compiler writes a
temporary file in the same directory, which ``os.replace`` moves into
place, and an ``fcntl.flock`` on ``build/pllmod_native.lock`` is held
from the freshness check to the load: processes that start together
build the library once, and none loads a half-written file
(:func:`load_host_library`, which also builds the kernels' launch
configurations, ``ops/_build.configs``). Entry points
this package uses so far:

- :func:`compress_patterns` — site-pattern dedup (pll_compress_site_patterns)
- :func:`parse_newick` — one-pass Newick -> flat arrays
- :func:`directed_traversal` — the directed-CLV schedule of the
  branch-length optimizer
- :func:`shared_splits` — the shared-split count of the RF distance
- :func:`fitch_score`, :func:`directed_fitch_sets`,
  :func:`parsimony_stepwise` — Fitch parsimony scoring, the directed
  Fitch sets of every edge, and the greedy stepwise-addition tree
  (``tree/starting.py``)
- :func:`transfer_distance_matrix`, :func:`tbe_mindist` — the transfer
  distances of the bootstrap support (``tree/tbe.py``)

Every entry point has a pure-python fallback in the calling module;
callers use :func:`available` to pick the fast path. The fallback is
taken only where there is no source or no ``g++``, or the source does
not compile.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "pllmod_native.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False


def host_library_path(stem: str, files, flags, build_dir: str) -> str:
    """``build_dir/<stem>-<hash>.so``: the hash covers the flags and the
    bytes of ``files`` (the source and the headers it includes)."""
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in files:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir, f"{stem}-{digest.hexdigest()[:12]}.so")


def load_host_library(stem: str, source: str, flags, build_dir: str,
                      headers=()) -> ctypes.CDLL:
    """The library of ``source`` compiled by ``g++ flags`` into
    ``build_dir`` (:func:`host_library_path` of the source, ``headers``
    and the flags), compiled first if it is missing, loaded. The compiler
    writes a temporary file that ``os.replace`` moves into place, under an
    ``fcntl.flock`` on ``build_dir/<stem>.lock`` held from the freshness
    check to the load. Raises OSError where g++ cannot run or the
    library cannot be written or loaded, subprocess.CalledProcessError
    (its ``stderr`` the compiler's) where the source does not compile."""
    os.makedirs(build_dir, exist_ok=True)
    path = host_library_path(stem, (source, *headers), flags, build_dir)
    with open(os.path.join(build_dir, f"{stem}.lock"), "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                try:
                    subprocess.run(["g++", *flags, "-o", tmp, source],
                                   check=True, capture_output=True,
                                   text=True, timeout=120)
                    os.replace(tmp, path)
                finally:
                    with contextlib.suppress(OSError):
                        os.remove(tmp)
            return ctypes.CDLL(path)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library of this source and these flags lives."""
    return host_library_path("pllmod_native", (_SRC,), _FLAGS, build_dir)


def load_library(build_dir: str = BUILD_DIR):
    """The library built into ``build_dir`` (compiled there first if it
    is missing), loaded and typed; None where there is no source or no
    ``g++``, or the source does not compile."""
    if not os.path.exists(_SRC) or shutil.which("g++") is None:
        return None
    try:
        lib = load_host_library("pllmod_native", _SRC, _FLAGS, build_dir)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.pllmod_compress_patterns.restype = ctypes.c_int64
    lib.pllmod_newick_parse.restype = ctypes.c_int
    lib.pllmod_newick_extract.restype = ctypes.c_int
    lib.pllmod_directed_traversal.restype = ctypes.c_int64
    lib.pllmod_shared_splits.restype = ctypes.c_int64
    lib.pllmod_fitch_score.restype = ctypes.c_double
    lib.pllmod_directed_fitch_sets.restype = ctypes.c_int
    lib.pllmod_parsimony_stepwise.restype = ctypes.c_int
    lib.pllmod_transfer_distance_matrix.restype = None
    lib.pllmod_tbe_mindist.restype = None
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            _lib = load_library()
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def compress_patterns(codes: np.ndarray, weights: np.ndarray | None = None):
    """Native site-pattern compression. codes int32 [taxa, sites].
    Returns (codes_out [taxa, n_patterns], weights [n_patterns])."""
    lib = _load()
    codes = np.ascontiguousarray(codes, np.int32)
    T, S = codes.shape
    w_in = (np.ascontiguousarray(weights, np.float64)
            if weights is not None else None)
    out = np.zeros_like(codes)
    w_out = np.zeros(S, np.float64)
    n = lib.pllmod_compress_patterns(
        _ptr(codes, ctypes.c_int32), ctypes.c_int64(T), ctypes.c_int64(S),
        _ptr(w_in, ctypes.c_double) if w_in is not None else None,
        _ptr(out, ctypes.c_int32), _ptr(w_out, ctypes.c_double))
    if n < 0:
        raise RuntimeError("native compress_patterns failed")
    return out[:, :n].copy(), w_out[:n].copy()


def parse_newick(newick: str):
    """Native Newick parse. Returns (n_tips, edges int32 [E,2],
    lengths [E], labels list, root_id, root_children)."""
    lib = _load()
    data = newick.encode()
    n_tips = ctypes.c_int64()
    n_edges = ctypes.c_int64()
    n_nodes = ctypes.c_int64()
    lab_bytes = ctypes.c_int64()
    root_children = ctypes.c_int64()
    rc = lib.pllmod_newick_parse(
        ctypes.c_char_p(data), ctypes.c_int64(len(data)),
        ctypes.byref(n_tips), ctypes.byref(n_edges), ctypes.byref(n_nodes),
        ctypes.byref(lab_bytes), ctypes.byref(root_children))
    if rc != 0:
        raise ValueError(f"newick parse error {rc}")
    E = n_edges.value
    edges = np.zeros((E, 2), np.int32)
    lengths = np.zeros(E, np.float64)
    labels_buf = ctypes.create_string_buffer(lab_bytes.value)
    root = ctypes.c_int64()
    rc = lib.pllmod_newick_extract(
        _ptr(edges, ctypes.c_int32), _ptr(lengths, ctypes.c_double),
        labels_buf, ctypes.c_int64(lab_bytes.value), ctypes.byref(root))
    if rc != 0:
        raise ValueError(f"newick extract error {rc}")
    labels = labels_buf.raw.decode().split("\x00")[:n_tips.value]
    return (int(n_tips.value), edges, lengths, labels, int(root.value),
            int(root_children.value), int(n_nodes.value))


def directed_traversal(edges: np.ndarray, n_tips: int, n_nodes: int,
                       root_tip: int):
    """Directed-CLV schedule build (optimize/blo.DirectedTraversal's
    host hot loop). Returns (ops int32 [n_rows, 5], slot_de int32
    [E, 2]) with slot_de[e][side] = the slot of the CLV at
    ``edges[e][side]`` directed toward the other endpoint (-1 = tip or
    unreachable), or None on multifurcating/malformed trees (python
    fallback)."""
    lib = _load()
    edges = np.ascontiguousarray(edges, np.int32)
    E = edges.shape[0]
    cap = max(3 * (n_tips - 2), 1)
    ops = np.zeros((cap, 5), np.int32)
    slot_de = np.full((E, 2), -1, np.int32)
    n = lib.pllmod_directed_traversal(
        _ptr(edges, ctypes.c_int32), ctypes.c_int64(E),
        ctypes.c_int64(n_tips), ctypes.c_int64(n_nodes),
        ctypes.c_int32(root_tip), _ptr(ops, ctypes.c_int32),
        ctypes.c_int64(cap), _ptr(slot_de, ctypes.c_int32))
    if n < 0:
        return None
    return ops[:n], slot_de


def shared_splits(a: np.ndarray, b: np.ndarray) -> int:
    """The number of splits (rows of uint64 words) that ``a`` and ``b``
    share, each counted once (``tree.splits.rf_distance_splits``)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    return int(lib.pllmod_shared_splits(
        _ptr(a, ctypes.c_uint64), ctypes.c_int64(a.shape[0]),
        _ptr(b, ctypes.c_uint64), ctypes.c_int64(b.shape[0]),
        ctypes.c_int64(a.shape[1] if a.ndim == 2 else 1)))


def fitch_score(tip_masks: np.ndarray, ops: np.ndarray,
                weights: np.ndarray) -> float:
    """Native Fitch scoring. tip_masks uint64 [tips, sites]; ops int32
    [n_ops, 3] postorder (unused, child1, child2): ids below the tip
    count are tips, the others scratch row (id - tips)."""
    lib = _load()
    tip_masks = np.ascontiguousarray(tip_masks, np.uint64)
    ops = np.ascontiguousarray(ops, np.int32)
    w = np.ascontiguousarray(weights, np.float64)
    T, S = tip_masks.shape
    return float(lib.pllmod_fitch_score(
        _ptr(tip_masks, ctypes.c_uint64), ctypes.c_int64(T),
        ctypes.c_int64(S), _ptr(ops, ctypes.c_int32),
        ctypes.c_int64(ops.shape[0]), _ptr(w, ctypes.c_double)))


def directed_fitch_sets(edges: np.ndarray, n_tips: int, n_nodes: int,
                        masks: np.ndarray):
    """Directed Fitch state sets per live edge (the parsimony analog of
    directed CLVs). edges int32 [E, 2] (-1 rows dead), masks uint64
    [n_tips, S]. Returns (A, B) uint64 [E, S]: A[e] = the set of
    ``edges[e, 0]``'s side, B[e] = ``edges[e, 1]``'s side."""
    lib = _load()
    edges = np.ascontiguousarray(edges, np.int32)
    masks = np.ascontiguousarray(masks, np.uint64)
    E = edges.shape[0]
    S = masks.shape[1]
    A = np.zeros((E, S), np.uint64)
    B = np.zeros((E, S), np.uint64)
    rc = lib.pllmod_directed_fitch_sets(
        _ptr(edges, ctypes.c_int32), ctypes.c_int64(E),
        ctypes.c_int64(n_tips), ctypes.c_int64(n_nodes),
        _ptr(masks, ctypes.c_uint64), ctypes.c_int64(S),
        _ptr(A, ctypes.c_uint64), _ptr(B, ctypes.c_uint64))
    if rc != 0:
        raise RuntimeError("native directed_fitch_sets failed")
    return A, B


def parsimony_stepwise(masks: np.ndarray, weights: np.ndarray,
                       order: np.ndarray) -> np.ndarray:
    """Greedy stepwise-addition parsimony topology. masks uint64 [n, S],
    weights float64 [S], order int32 [n] insertion order. Returns edges
    int32 [2n-3, 2] (inner ids from n)."""
    lib = _load()
    masks = np.ascontiguousarray(masks, np.uint64)
    w = np.ascontiguousarray(weights, np.float64)
    order = np.ascontiguousarray(order, np.int32)
    n, S = masks.shape
    out = np.zeros((2 * n - 3, 2), np.int32)
    rc = lib.pllmod_parsimony_stepwise(
        _ptr(masks, ctypes.c_uint64), ctypes.c_int64(n),
        ctypes.c_int64(S), _ptr(w, ctypes.c_double),
        _ptr(order, ctypes.c_int32), _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError("native parsimony_stepwise failed")
    return out


def transfer_distance_matrix(a: np.ndarray, b: np.ndarray,
                             n_tips: int) -> np.ndarray:
    """min(popcount(a ^ b), n_tips - popcount(a ^ b)) of every row pair
    of two split matrices (uint64 [n, words]). Returns int32 [na, nb]."""
    lib = _load()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    na, W = a.shape if a.ndim == 2 else (0, 0)
    nb = b.shape[0]
    out = np.zeros((na, nb), np.int32)
    lib.pllmod_transfer_distance_matrix(
        _ptr(a, ctypes.c_uint64), ctypes.c_int64(na),
        _ptr(b, ctypes.c_uint64), ctypes.c_int64(nb),
        ctypes.c_int64(W), ctypes.c_int64(n_tips),
        _ptr(out, ctypes.c_int32))
    return out


def tbe_mindist(light: np.ndarray, p: np.ndarray, post: np.ndarray,
                n_tips: int, n_nodes: int) -> np.ndarray:
    """Counting-traversal minimum transfer distances: one O(N) pass per
    reference split over the bootstrap tree's postorder. light uint64
    [R, words] light-side masks, p int32 [R], post int32 [n_post, 3]
    rows (node, left, right). Returns int32 [R]."""
    lib = _load()
    light = np.ascontiguousarray(light, np.uint64)
    p = np.ascontiguousarray(p, np.int32)
    post = np.ascontiguousarray(post, np.int32)
    R, W = light.shape
    out = np.zeros(R, np.int32)
    lib.pllmod_tbe_mindist(
        _ptr(light, ctypes.c_uint64), _ptr(p, ctypes.c_int32),
        ctypes.c_int64(R), ctypes.c_int64(W), ctypes.c_int64(n_tips),
        _ptr(post, ctypes.c_int32), ctypes.c_int64(post.shape[0]),
        ctypes.c_int64(n_nodes), _ptr(out, ctypes.c_int32))
    return out
