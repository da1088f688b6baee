"""The 9 genotype models over 10-state unphased / 16-state phased genotypes.

Counterpart of ``src/util/models_gt.c:36-175``. State orders:
GT10 = AA CC GG TT AC AG AT CG CT GT (models_gt.c:36 comment row),
GT16 adds the phase-swapped heterozygotes CA GA TA GC TC TG.

Rate vectors/symmetries are over the row-major upper triangle of the
state-pair matrix (45 rates for 10 states, 120 for 16).
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import UtilError, UTIL_ERROR_MODEL_UNKNOWN
from pllmod_tpu_torch.utils.models import SubstModel, equal_freqs

# models_gt.c:35-44 — single-mutation JC: rate 1 between genotypes one
# mutation apart, 0 otherwise (upper triangle, 10 states)
_GT_RATES_EQUAL_SM = np.array([
    0, 0, 0, 1, 1, 1, 0, 0, 0,
    0, 0, 1, 0, 0, 1, 1, 0,
    0, 0, 1, 0, 1, 0, 1,
    0, 0, 1, 0, 1, 1,
    1, 1, 1, 1, 0,
    1, 1, 0, 1,
    0, 1, 1,
    1, 1,
    1], dtype=np.float64)

_GT_RATES_EQUAL = np.ones(45)
_GT16_RATES_EQUAL = np.ones(120)
_GT_FREQS_EQUAL = equal_freqs(10)
_GT16_FREQS_EQUAL = equal_freqs(16)

# models_gt.c:90-100 — free rates between single-mutation pairs only
_GT_SYM_RATE_FREE_SM = np.array([
    0, 0, 0, 1, 2, 3, 0, 0, 0,
    0, 0, 4, 0, 0, 5, 6, 0,
    0, 0, 7, 0, 8, 0, 9,
    0, 0, 10, 0, 11, 12,
    13, 14, 15, 16, 0,
    17, 18, 0, 19,
    0, 20, 21,
    22, 23,
    24], dtype=np.int32)

# models_gt.c:102-113 — 6 DNA-GTR-like rate classes (A-C:1 ... G-T:6)
_GT_SYM_RATE_DNA4 = np.array([
    0, 0, 0, 1, 2, 3, 0, 0, 0,
    0, 0, 1, 0, 0, 4, 5, 0,
    0, 0, 2, 0, 4, 0, 6,
    0, 0, 3, 0, 5, 6,
    4, 5, 2, 3, 0,
    6, 1, 0, 3,
    0, 1, 2,
    6, 5,
    4], dtype=np.int32)

# models_gt.c:115-126 — HKY-like ts/tv classes
_GT_SYM_RATE_HKY4 = np.array([
    0, 0, 0, 1, 2, 1, 0, 0, 0,
    0, 0, 1, 0, 0, 1, 2, 0,
    0, 0, 2, 0, 1, 0, 1,
    0, 0, 1, 0, 2, 1,
    1, 2, 2, 1, 0,
    1, 1, 0, 1,
    0, 1, 2,
    1, 2,
    1], dtype=np.int32)

# models_gt.c:129-147 — 16-state, 6 DNA-GTR-like classes
_GT16_SYM_RATE_DNA4 = np.array([
    0, 0, 0, 1, 2, 3, 0, 0, 0, 1, 2, 3, 0, 0, 0,
    0, 0, 1, 0, 0, 4, 5, 0, 1, 0, 0, 4, 5, 0,
    0, 0, 2, 0, 4, 0, 6, 0, 2, 0, 4, 0, 6,
    0, 0, 3, 0, 5, 6, 0, 0, 3, 0, 5, 6,
    4, 5, 2, 3, 0, 0, 0, 0, 2, 3, 0,
    6, 1, 0, 3, 0, 0, 0, 0, 0, 3,
    0, 1, 2, 0, 0, 0, 0, 0, 0,
    6, 5, 2, 0, 0, 0, 0, 5,
    4, 3, 0, 0, 0, 0, 0,
    0, 3, 0, 5, 0, 0,
    4, 5, 0, 0, 0,
    6, 1, 0, 0,
    0, 1, 2,
    6, 0,
    4], dtype=np.int32)

_MODELS = {m.name.upper(): m for m in [
    SubstModel("GT10",       10, None, None, _GT_SYM_RATE_DNA4, None),
    SubstModel("GT10JC-SM",  10, _GT_RATES_EQUAL_SM, _GT_FREQS_EQUAL, None, None),
    SubstModel("GT10JC",     10, _GT_RATES_EQUAL, _GT_FREQS_EQUAL, None, None),
    SubstModel("GT10GTR-SM", 10, None, None, _GT_SYM_RATE_FREE_SM, None),
    SubstModel("GT10HKY",    10, None, None, _GT_SYM_RATE_HKY4, None),
    SubstModel("GT10GTR",    10, None, None, None, None),
    SubstModel("GT16",       16, None, None, _GT16_SYM_RATE_DNA4, None),
    SubstModel("GT16JC",     16, _GT16_RATES_EQUAL, _GT16_FREQS_EQUAL, None, None),
    SubstModel("GT16GTR",    16, None, None, None, None),
]}

# models_gt.c:160-169
_ALIASES = {
    "GTJC": "GT10JC", "GTJC-SM": "GT10JC-SM", "GTGTR4": "GT10",
    "GTGTR": "GT10GTR", "GTGTR-SM": "GT10GTR-SM", "GTHKY4": "GT10HKY",
    "GPGTR4": "GT16",
}


def _resolve(name: str) -> str | None:
    key = name.upper()
    key = _ALIASES.get(key, key)
    return key if key in _MODELS else None


def exists(name: str) -> bool:
    return _resolve(name) is not None


def exists_gt10(name: str) -> bool:
    key = _resolve(name)
    return key is not None and _MODELS[key].states == 10


def exists_gt16(name: str) -> bool:
    key = _resolve(name)
    return key is not None and _MODELS[key].states == 16


def info(name: str) -> SubstModel:
    key = _resolve(name)
    if key is None:
        raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                        f"genotype model not found: {name}")
    return _MODELS[key]


def names() -> list[str]:
    return [m.name for m in _MODELS.values()]


def count() -> int:
    return len(_MODELS)
