"""Build, load and launch the CUDA pruning kernels (``csrc/pruning.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface under ``build/`` at the repository root, named by a hash of
the source and flags, on first use; ctypes loads it. Nothing here runs
at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pruning.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C entry points: name -> (argument types, result type); the walks
# return the CUDA error code of their launch
_VP, _I = ctypes.c_void_p, ctypes.c_int
_WALK_ARGS = [_VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _VP]
ENTRY_POINTS = {"pllmod_resident_walk": (_WALK_ARGS, _I),
                "pllmod_fused_walk": (_WALK_ARGS, _I),
                "pllmod_walk_smem_bytes": ([_I] * 6, ctypes.c_longlong)}

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


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"pruning-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the kernels if this source has no library yet; returns
    the library path. Raises with nvcc's output when the build fails."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# The row-walk launch shared by the two kernel wrappers (ops/resident.py,
# ops/fused.py). The numbers below are those of csrc/pruning.cu; the card
# tests hold walk_smem_bytes against the library's pllmod_walk_smem_bytes.
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


def launch_walk(name, idx8, P5, tip_codes, codetab, clv_out, sc_out,
                n_slots: int) -> None:
    """Check the inputs of a row-walk kernel and launch it on the current
    stream. Raises on anything the kernel does not take."""
    import torch
    nW = idx8.shape[0]
    _, _, C, S, _ = P5.shape
    n_tips, Ppad = tip_codes.shape
    T = pattern_tile(C)
    dev = P5.device
    for t, dt, shape in ((idx8, torch.int32, (nW, 8)),
                         (P5, torch.float32, (nW, 2, C, S, S)),
                         (tip_codes, torch.int32, (n_tips, Ppad)),
                         (codetab, torch.float32, (codetab.shape[0], S)),
                         (clv_out, torch.float32, None),
                         (sc_out, torch.int32, None)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor, "
                             f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
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
    fn = getattr(load(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(idx8.data_ptr(), nW, P5.data_ptr(), tip_codes.data_ptr(),
                 codetab.data_ptr(), codetab.shape[0], clv_out.data_ptr(),
                 sc_out.data_ptr(), Ppad, C, S, n_slots, T, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
