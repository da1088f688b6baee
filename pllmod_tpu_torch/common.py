"""Shared constants + error handling.

PyTorch/CUDA counterpart of the reference's ``src/pllmod_common.{c,h}``:
error state (``pllmod_common.h:43-44``), branch-length linkage constants
(``pllmod_common.h:25-27``) and parallel reduce ops (``pllmod_common.h:29-31``).

Errors here are Python exceptions carrying the reference's numeric error
codes (ranges documented at ``pllmod_common.h:38-41``), so user code that
matched on codes keeps a stable contract.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on (default: the CUDA card).

    The single shared device check of every entry point (the libpll
    ``PLL_ATTRIB_ARCH_*`` dispatch analog). A CUDA device without a
    card raises: nothing falls back to the CPU quietly; callers that
    want the CPU ask for it (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise PllModError(ERROR_UNSUPPORTED,
                          f"device {device!r} requested but CUDA is not "
                          "available; pass device='cpu' to run on the CPU")
    return dev


def host_array(x):
    """A tensor (on any device) or an array-like as a host numpy array —
    what the host-side writers and printers take."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Branch-length linkage across partitions (pllmod_common.h:25-27)
# ---------------------------------------------------------------------------
BRLEN_LINKED = 0
BRLEN_SCALED = 1
BRLEN_UNLINKED = 2

# ---------------------------------------------------------------------------
# Reduce operations for the distributed seam (pllmod_common.h:29-31).
# In the torch build these map onto torch.distributed reduce ops.
# ---------------------------------------------------------------------------
REDUCE_SUM = 0
REDUCE_MAX = 1
REDUCE_MIN = 2

# ---------------------------------------------------------------------------
# Error codes — same numeric ranges as the reference so downstream
# tooling can keep matching on them.
# ---------------------------------------------------------------------------
# common (1001-2000), pllmod_common.h:38-41
ERROR_INVALID_RANGE = 1001
ERROR_INVALID_NODE_TYPE = 1002
ERROR_INVALID_INDEX = 1003
ERROR_INVALID_PARAM = 1004
ERROR_UNSUPPORTED = 1005
ERROR_EINVAL = 1006
ERROR_NOT_IMPLEMENTED = 1990

# optimize (2000-3000), pll_optimize.h:88-99
OPT_ERROR_PARAMETER = 2000
OPT_ERROR_TAXA_MISMATCH = 2010
OPT_ERROR_SEQLEN_MISMATCH = 2020
OPT_ERROR_ALIGN_UNREADABLE = 2030
OPT_ERROR_LBFGSB_UNKNOWN = 2100
OPT_ERROR_NEWTON_DERIV = 2210
OPT_ERROR_NEWTON_LIMIT = 2220
OPT_ERROR_NEWTON_UNKNOWN = 2230
OPT_ERROR_NEWTON_WORSE_LK = 2240
OPT_ERROR_NEWTON_BAD_RADIUS = 2250
OPT_ERROR_BRENT_INIT = 2310

# tree (3000-4000), pll_tree.h:37-60
TREE_ERROR_TBR_LEAF_BISECTION = 3073
TREE_ERROR_TBR_OVERLAPPED_NODES = 3074
TREE_ERROR_TBR_SAME_SUBTREE = 3075
TREE_ERROR_NNI_INVALID_MOVE = 3080
TREE_ERROR_SPR_INVALID_NODE = 3090
TREE_ERROR_INVALID_REARRAGE = 3100
TREE_ERROR_INVALID_TREE_SIZE = 3110
TREE_ERROR_INVALID_TREE = 3120
TREE_ERROR_INVALID_SPLIT = 3130
TREE_ERROR_EMPTY_SPLIT = 3140
TREE_ERROR_INVALID_THRESHOLD = 3150
TREE_ERROR_POLYPHYL_OUTGROUP = 3160

# binary (4000s), pll_binary.h:47-53
BINARY_ERROR_BLOCK_MISMATCH = 4001
BINARY_ERROR_BLOCK_LENGTH = 4002
BINARY_ERROR_INVALID_INDEX = 4003
BINARY_ERROR_INVALID_SIZE = 4004
BINARY_ERROR_IO = 4005
BINARY_ERROR_MISSING_BLOCK = 4006

# util (5001-6000), pllmod_util.h:31-36
UTIL_ERROR_MODEL_UNKNOWN = 5001
UTIL_ERROR_MODEL_INVALID_DEF = 5002
UTIL_ERROR_MODEL_INVALID_MAPSTRING = 5003
UTIL_ERROR_MODEL_INVALID_MAPFILE = 5004
UTIL_ERROR_MIXTURE_INVALID_SIZE = 5011
UTIL_ERROR_MIXTURE_INVALID_COMPONENT = 5012


class PllModError(Exception):
    """Base error. ``code`` follows the reference's numeric ranges."""

    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(f"[{code}] {message}")


class TreeError(PllModError):
    pass


class OptimizeError(PllModError):
    pass


class UtilError(PllModError):
    pass


class BinaryError(PllModError):
    pass


class MsaError(PllModError):
    pass


# ---------------------------------------------------------------------------
# Numerical defaults shared across modules (pll_optimize.h:50-77)
# ---------------------------------------------------------------------------
DEFAULT_PINV = 0.01
DEFAULT_ALPHA = 0.5
DEFAULT_BRANCH_LEN = 0.1

MIN_BRANCH_LEN = 1.0e-4
MAX_BRANCH_LEN = 100.0
TOL_BRANCH_LEN = 1.0e-4
MIN_SUBST_RATE = 1.0e-3
MAX_SUBST_RATE = 1000.0
MIN_FREQ = 1.0e-3
MAX_FREQ = 100.0
MIN_ALPHA = 0.0201
MAX_ALPHA = 100.0
MIN_PINV = 0.0
MAX_PINV = 0.99
MIN_RATE = 0.02
MAX_RATE = 100.0
MIN_RATE_WEIGHT = 1.0e-3
MAX_RATE_WEIGHT = 100.0
LNL_UNLIKELY = -1e80

# Parameter bitmask for params_to_optimize (pll_optimize.h:30-44)
PARAM_ALL = ~0
PARAM_SUBST_RATES = 1 << 0
PARAM_ALPHA = 1 << 1
PARAM_PINV = 1 << 2
PARAM_FREQUENCIES = 1 << 3
PARAM_BRANCHES_SINGLE = 1 << 4
PARAM_BRANCHES_ALL = 1 << 5
PARAM_BRANCHES_ITERATIVE = 1 << 6
PARAM_TOPOLOGY = 1 << 7
PARAM_FREE_RATES = 1 << 8
PARAM_RATE_WEIGHTS = 1 << 9
PARAM_BRANCH_LEN_SCALER = 1 << 10
PARAM_USER = 1 << 16

# Gamma-rates discretization mode (libpll PLL_GAMMA_RATES_MEAN|MEDIAN)
GAMMA_RATES_MEAN = 0
GAMMA_RATES_MEDIAN = 1
