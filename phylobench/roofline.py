"""The least time one full evaluation could take on one NVIDIA H100, from
the tree and the shapes alone (never from a kernel's own tables).

Operations: an unrooted binary tree of n tips evaluated from any root has
n − 2 inner CLVs and one root combination. Of the 2n − 3 edges, n − 3
carry an inner CLV to its parent: each costs C·S·S multiply-adds a
pattern (2 operations each). The n edges to tips cost a lookup a pattern
and one P·(code table) product of n_codes columns in all. Every CLV and
the root row cost 3·C·S a pattern (the children's product, the maximum
and the rescale), and the root's π-weighting C·S. The epilogue (C sums
and a log a pattern) is left out. This is the count of the port's
``chip_smoke.py`` ``walk_flops`` (PERF.md's bound column), taken from
the tree instead of a table, over the unpadded patterns.

Bytes: the alignment read once, one byte a tip and pattern (the
characters as given), the pattern weights (float32) and one P matrix an
edge and category (float32); the output is one number.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W
F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def eval_flops(n_tips: int, n_patterns: int, C: int, S: int,
               n_codes: int) -> int:
    """Operations of one full evaluation (module docstring)."""
    mat = 2 * C * S * S
    per_pattern = (mat * (n_tips - 3) + 3 * C * S * (n_tips - 1) + C * S)
    tables = mat * n_codes * n_tips
    return n_patterns * per_pattern + tables


def eval_bytes(n_tips: int, n_patterns: int, C: int, S: int) -> int:
    """Compulsory bytes of one full evaluation (module docstring)."""
    n_edges = 2 * n_tips - 3
    return n_tips * n_patterns + 4 * n_patterns + 4 * n_edges * C * S * S + 4


def eval_least_s(shape: dict) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two bounds of
    one evaluation of ``shape`` (n_tips, n_patterns, C, S, n_codes)."""
    t_ops = eval_flops(shape["n_tips"], shape["n_patterns"], shape["C"],
                       shape["S"], shape["n_codes"]) / F32_FLOPS
    t_bytes = eval_bytes(shape["n_tips"], shape["n_patterns"], shape["C"],
                         shape["S"]) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def clv_updates(shape: dict) -> int:
    """CLV updates of one evaluation: (n_tips − 2) inner nodes × the
    compressed, unpadded patterns."""
    return (shape["n_tips"] - 2) * shape["n_patterns"]
