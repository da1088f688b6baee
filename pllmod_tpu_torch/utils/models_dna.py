"""The 22 named DNA models + 9 aliases.

Counterpart of ``src/util/models_dna.c:36-119``: every model is a symmetry
class over GTR, expressed as (rate symmetry vector over AC AG AT CG CT GT,
frequency symmetry over A C G T), with fixed values where the model pins
them (JC/F81 equal rates, *ef models equal frequencies).
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import UtilError, UTIL_ERROR_MODEL_UNKNOWN
from pllmod_tpu_torch.utils.models import SubstModel, equal_rates, equal_freqs

_EQ_R = equal_rates(4)
_EQ_F = equal_freqs(4)

# rate symmetry classes over (AC AG AT CG CT GT), models_dna.c:47-59
_SYM_EQUAL = [0, 0, 0, 0, 0, 0]
_SYM_FREE = [0, 1, 2, 3, 4, 5]
_SYM_TVTS = [0, 1, 0, 0, 1, 0]     # transversion/transition (K80/HKY)
_SYM_TN93 = [0, 1, 0, 0, 2, 0]
_SYM_K81 = [0, 1, 2, 2, 1, 0]
_SYM_TPM2 = [0, 1, 0, 2, 1, 2]
_SYM_TPM3 = [0, 1, 2, 0, 1, 2]
_SYM_TIM1 = [0, 1, 2, 2, 3, 0]
_SYM_TIM2 = [0, 1, 0, 2, 3, 2]
_SYM_TIM3 = [0, 1, 2, 0, 3, 2]
_SYM_TVM = [0, 1, 2, 3, 1, 4]

_F_EQUAL = [0, 0, 0, 0]
_F_FREE = None  # all-free identity classes


def _m(name, rates, freqs, rate_sym, freq_sym):
    return SubstModel(name, 4, rates, freqs,
                      np.array(rate_sym, np.int32) if rate_sym is not None else None,
                      np.array(freq_sym, np.int32) if freq_sym is not None else None)


_MODELS = {m.name.upper(): m for m in [
    _m("JC",     _EQ_R, _EQ_F, _SYM_EQUAL, _F_EQUAL),
    _m("K80",    None,  _EQ_F, _SYM_TVTS,  _F_EQUAL),
    _m("F81",    _EQ_R, None,  _SYM_EQUAL, _F_FREE),
    _m("HKY",    None,  None,  _SYM_TVTS,  _F_FREE),
    _m("TN93ef", None,  _EQ_F, _SYM_TN93,  _F_EQUAL),
    _m("TN93",   None,  None,  _SYM_TN93,  _F_FREE),
    _m("K81",    None,  _EQ_F, _SYM_K81,   _F_EQUAL),
    _m("K81uf",  None,  None,  _SYM_K81,   _F_FREE),
    _m("TPM2",   None,  _EQ_F, _SYM_TPM2,  _F_EQUAL),
    _m("TPM2uf", None,  None,  _SYM_TPM2,  _F_FREE),
    _m("TPM3",   None,  _EQ_F, _SYM_TPM3,  _F_EQUAL),
    _m("TPM3uf", None,  None,  _SYM_TPM3,  _F_FREE),
    _m("TIM1",   None,  _EQ_F, _SYM_TIM1,  _F_EQUAL),
    _m("TIM1uf", None,  None,  _SYM_TIM1,  _F_FREE),
    _m("TIM2",   None,  _EQ_F, _SYM_TIM2,  _F_EQUAL),
    _m("TIM2uf", None,  None,  _SYM_TIM2,  _F_FREE),
    _m("TIM3",   None,  _EQ_F, _SYM_TIM3,  _F_EQUAL),
    _m("TIM3uf", None,  None,  _SYM_TIM3,  _F_FREE),
    _m("TVMef",  None,  _EQ_F, _SYM_TVM,   _F_EQUAL),
    _m("TVM",    None,  None,  _SYM_TVM,   _F_FREE),
    _m("SYM",    None,  _EQ_F, _SYM_FREE,  _F_EQUAL),
    _m("GTR",    None,  None,  _SYM_FREE,  _F_FREE),
]}

# aliases, models_dna.c:109-119
_ALIASES = {
    "TRNEF": "TN93EF", "TRN": "TN93",
    "TPM1": "K81", "TPM1UF": "K81UF",
    "TPM2EF": "TPM2", "TPM3EF": "TPM3",
    "TIM1EF": "TIM1", "TIM2EF": "TIM2", "TIM3EF": "TIM3",
}


def _resolve(name: str) -> str | None:
    key = name.upper()
    key = _ALIASES.get(key, key)
    return key if key in _MODELS else None


def exists(name: str) -> bool:
    return _resolve(name) is not None


def info(name: str) -> SubstModel:
    key = _resolve(name)
    if key is None:
        raise UtilError(UTIL_ERROR_MODEL_UNKNOWN, f"DNA model not found: {name}")
    return _MODELS[key]


def names() -> list[str]:
    return [m.name for m in _MODELS.values()]


def count() -> int:
    return len(_MODELS)
