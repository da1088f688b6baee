"""Build, load and launch the CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into its own shared library with a plain
C interface under ``build/`` at the repository root, named by a hash of
the source, the header they share (``csrc/common.cuh``) and the flags,
on first use; the sources that lack a library are
compiled all at once, one ``nvcc`` each. ctypes loads them. Nothing here
runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("pruning", "deriv", "levels", "grouped", "packed")}
HEADER = os.path.join(_PKG, "csrc", "common.cuh")   # included by every source
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C entry points: name -> (source, argument types, result type); the
# launches return the CUDA error code of their launch
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WALK_ARGS = [_VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _VP]
ENTRY_POINTS = {
    "pllmod_resident_walk": ("pruning", _WALK_ARGS, _I),
    "pllmod_fused_walk": ("pruning", _WALK_ARGS, _I),
    "pllmod_walk_smem_bytes": ("pruning", [_I] * 6, ctypes.c_longlong),
    "pllmod_edge_sumtables": ("deriv", [_VP, _I, _VP, _VP, _I, _VP, _I, _VP,
                                        _VP, _I, _VP, _VP, _I, _I, _I, _I,
                                        _VP], _I),
    "pllmod_edge_derivs": ("deriv", [_VP] * 7 + [_I] * 3 + [_VP], _I),
    "pllmod_newton_edges": ("deriv", [_VP, _I, _I, _VP, _F, _F, _F, _I, _VP,
                                      _VP, _VP, _I, _VP], _I),
    "pllmod_child_pass": ("levels", [_VP, _I, _I, _VP, _VP, _VP, _I, _VP, _I,
                                     _VP, _I, _VP, _VP] + [_I] * 4 + [_VP],
                          _I),
    "pllmod_child2_pass": ("levels", [_VP, _I, _VP, _VP, _VP, _I, _VP, _I,
                                      _VP, _I, _VP, _VP] + [_I] * 5 + [_VP],
                           _I),
    "pllmod_level_combined": ("levels", [_VP, _I] + [_VP] * 4 + [_I, _VP, _I,
                                                                 _VP]
                              + [_I] * 6 + [_VP], _I),
    "pllmod_grouped_walk": ("grouped", [_VP, _VP, _I, _I, _VP, _VP, _I, _VP,
                                        _I, _VP, _VP] + [_I] * 4 + [_VP], _I),
    "pllmod_packed_walk": ("packed", [_VP, _VP, _VP, _I, _VP, _I, _VP, _I,
                                      _VP, _I, _VP, _VP] + [_I] * 4 + [_VP],
                           _I),
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


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build() -> dict:
    """Compile every source that has no library yet, one ``nvcc`` each,
    all started together; returns {source name: library path}. Raises
    with nvcc's output when a build fails."""
    global BUILD_LOG
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate(timeout=900)
        BUILD_LOG += f"== {name}.cu ==\n{out}"
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode})")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{BUILD_LOG}")
    return paths


def load() -> types.SimpleNamespace:
    """The kernels' C entry points as attributes (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            libs = {name: ctypes.CDLL(path) for name, path in build().items()}
            fns = {}
            for name, (src, argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(libs[src], name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


# ---------------------------------------------------------------------------
# Launch checks, and the row-walk launch shared by the two walk wrappers
# (ops/resident.py, ops/fused.py). The numbers below are those of
# csrc/pruning.cu; the card tests hold walk_smem_bytes against the
# library's pllmod_walk_smem_bytes.
# ---------------------------------------------------------------------------
MAX_STATES = 64            # widest register tile the kernels instantiate
MAX_THREADS = 256          # __launch_bounds__ of the kernels
SMEM_PER_BLOCK = 232_448   # H100: shared memory one block may opt into


def pattern_tile(n_cats: int) -> int:
    """Pattern columns per CTA: C·T threads per CTA, at most 256."""
    for T in (64, 32, 16, 8, 4, 2, 1):
        if n_cats * T <= MAX_THREADS:
            return T
    raise ValueError(f"the pruning kernels take at most {MAX_THREADS} rate "
                     f"categories, got {n_cats}")


def walk_smem_bytes(C: int, S: int, n_codes: int, n_slots: int,
                    resident: bool) -> int:
    """Dynamic shared memory of one CTA: the code table, the category
    maxima, (resident) the live slots with their scaler rows and, when
    they fit beside those, one row's two staged child matrices."""
    T = pattern_tile(C)
    floats = n_codes * S + C * T
    if resident:
        floats += n_slots * C * S * T + n_slots * T
    if 4 * (floats + 2 * C * S * S) <= SMEM_PER_BLOCK:
        floats += 2 * C * S * S
    return 4 * floats


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


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream
    (appended as the last argument); raise if the launch failed."""
    import torch
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def launch_walk(name, idx8, P5, tip_codes, codetab, clv_out, sc_out,
                n_slots: int) -> None:
    """Check the inputs of a row-walk kernel and launch it on the current
    stream. Raises on anything the kernel does not take."""
    import torch
    nW = idx8.shape[0]
    _, _, C, S, _ = P5.shape
    n_tips, Ppad = tip_codes.shape
    T = pattern_tile(C)
    check_tensors(name, [(idx8, torch.int32, (nW, 8)),
                         (P5, torch.float32, (nW, 2, C, S, S)),
                         (tip_codes, torch.int32, (n_tips, Ppad)),
                         (codetab, torch.float32, (codetab.shape[0], S)),
                         (clv_out, torch.float32, None),
                         (sc_out, torch.int32, None)])
    if S > MAX_STATES:
        raise ValueError(f"{name}: at most {MAX_STATES} states, got {S}")
    if Ppad % T:
        raise ValueError(f"{name}: patterns ({Ppad}) must be a multiple "
                         f"of the tile ({T})")
    resident = name == "pllmod_resident_walk"
    smem = walk_smem_bytes(C, S, codetab.shape[0], n_slots, resident)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory per "
                         f"block, more than {SMEM_PER_BLOCK}")
    launch(name, P5.device, idx8.data_ptr(), nW, P5.data_ptr(),
           tip_codes.data_ptr(), codetab.data_ptr(), codetab.shape[0],
           clv_out.data_ptr(), sc_out.data_ptr(), Ppad, C, S, n_slots, T)
