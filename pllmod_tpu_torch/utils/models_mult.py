"""MULTIx multistate models (2..64 states), generated on the fly.

Counterpart of ``src/util/models_mult.c:39-127``: model names are
``MULTI<states>_<GTR|MK|JC|USER...>``; GTR leaves rates/freqs free, MK/JC
pin them equal, USER carries a custom rate-symmetry string.
"""

from __future__ import annotations

import re

from pllmod_tpu_torch.common import (UtilError, UTIL_ERROR_MODEL_UNKNOWN,
                               UTIL_ERROR_MODEL_INVALID_DEF)
from pllmod_tpu_torch.ops.charmap import multistate as multistate_charmap
from pllmod_tpu_torch.utils.models import (SubstModel, create_custom, equal_rates,
                                     equal_freqs)

_NAME_RE = re.compile(r"^MULTI(\d+)(?:_(.+))?$", re.IGNORECASE)
MAX_STATES = 64


def numstates(name: str) -> int:
    """Parse MULTIxx -> xx (0 if not a MULTI model name)."""
    m = _NAME_RE.match(name)
    return int(m.group(1)) if m else 0


def charmap(states: int):
    """Charmap for a MULTI model (models_mult.c mult_statechars)."""
    return multistate_charmap(states)


def exists(name: str) -> bool:
    m = _NAME_RE.match(name)
    if not m:
        return False
    sub = (m.group(2) or "GTR").upper()
    return (sub in ("GTR", "MK", "JC")) or sub.startswith("USER")


def info(name: str) -> SubstModel:
    m = _NAME_RE.match(name)
    if not m:
        raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                        f"not a MULTISTATE model: {name}")
    states = int(m.group(1))
    if not (2 <= states <= MAX_STATES):
        raise UtilError(UTIL_ERROR_MODEL_INVALID_DEF,
                        f"states {states} outside 2..{MAX_STATES}")
    sub = (m.group(2) or "GTR").upper()
    if sub == "GTR":
        return create_custom(name, states)
    if sub in ("MK", "JC"):
        return create_custom(name, states, equal_rates(states),
                             equal_freqs(states))
    if sub.startswith("USER"):
        return create_custom(name, states, rate_sym=sub[4:] or None)
    raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                    f"MULTISTATE model not found: {sub}")


def names() -> list[str]:
    return []  # generated on demand, no fixed list
