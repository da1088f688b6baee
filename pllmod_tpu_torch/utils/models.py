"""Substitution-model descriptors + symmetry-class parameter packing.

Counterpart of the reference's ``src/util/models.c`` (descriptor
struct ``pllmod_subst_model_t`` at ``pllmod_util.h:44-53``, mixture
descriptor at ``pllmod_util.h:56-64``, generic ops at
``models.c:47-423``). Differences by design:

- models are immutable Python dataclasses holding numpy arrays; ``None``
  rates/freqs mean "optimize me" exactly as in the reference,
- symmetry classes (``rate_sym``/``freq_sym``) double as the
  **pack/unpack** maps used by the optimizers: free parameters live in a
  dense ``[n_classes - 1]`` vector (the class of the last rate is pinned to
  1.0, the reference's convention in ``pllmod_algorithm.c:124-232``), and
  expansion back to the full rate vector is a differentiable gather — so
  L-BFGS-B sees exactly the reference's parameterization but with analytic
  gradients.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from pllmod_tpu_torch.common import (
    UtilError,
    UTIL_ERROR_MODEL_UNKNOWN,
    UTIL_ERROR_MODEL_INVALID_DEF,
    UTIL_ERROR_MIXTURE_INVALID_SIZE,
)

# mixture types (pllmod_util.h:39-41)
MIXTYPE_FIXED = 0
MIXTYPE_GAMMA = 1
MIXTYPE_FREE = 2


def subst_rate_count(states: int) -> int:
    """Number of distinct exchangeability rates: s(s-1)/2 (models.c:126)."""
    return states * (states - 1) // 2


def equal_rates(states: int) -> np.ndarray:
    return np.ones(subst_rate_count(states))


def equal_freqs(states: int) -> np.ndarray:
    return np.full(states, 1.0 / states)


def string_to_sym(s: str) -> np.ndarray:
    """Symmetry string like '012345' or '010010' -> int class vector
    (models.c:178 ``pllmod_util_model_string_to_sym``). Characters 0-9."""
    if not re.fullmatch(r"[0-9]+", s):
        raise UtilError(UTIL_ERROR_MODEL_INVALID_DEF,
                        f"invalid symmetry string: {s!r}")
    return np.array([int(c) for c in s], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class SubstModel:
    """A named substitution model.

    ``rates``/``freqs`` of None mean the parameter is free (to optimize);
    ``rate_sym``/``freq_sym`` of None mean all-free (identity classes).
    """
    name: str
    states: int
    rates: np.ndarray | None = None
    freqs: np.ndarray | None = None
    rate_sym: np.ndarray | None = None
    freq_sym: np.ndarray | None = None

    def __post_init__(self):
        nr = subst_rate_count(self.states)
        if self.rates is not None:
            r = np.asarray(self.rates, np.float64)
            if r.shape != (nr,):
                raise UtilError(UTIL_ERROR_MODEL_INVALID_DEF,
                                f"{self.name}: expected {nr} rates, got {r.shape}")
            object.__setattr__(self, "rates", r)
        if self.freqs is not None:
            f = np.asarray(self.freqs, np.float64)
            if f.shape != (self.states,):
                raise UtilError(UTIL_ERROR_MODEL_INVALID_DEF,
                                f"{self.name}: expected {self.states} freqs")
            object.__setattr__(self, "freqs", f / f.sum())
        for attr in ("rate_sym", "freq_sym"):
            v = getattr(self, attr)
            if v is not None:
                v = np.asarray(v, np.int32)
                want = nr if attr == "rate_sym" else self.states
                if v.shape != (want,):
                    raise UtilError(UTIL_ERROR_MODEL_INVALID_DEF,
                                    f"{self.name}: bad {attr} length")
                object.__setattr__(self, attr, v)

    # -- symmetry-class machinery ------------------------------------------
    @property
    def n_rates(self) -> int:
        return subst_rate_count(self.states)

    def rate_classes(self) -> np.ndarray:
        if self.rate_sym is None:
            return np.arange(self.n_rates, dtype=np.int32)
        return self.rate_sym

    def freq_classes(self) -> np.ndarray:
        if self.freq_sym is None:
            return np.arange(self.states, dtype=np.int32)
        return self.freq_sym

    @property
    def n_free_rates(self) -> int:
        """Free exchangeability parameters under the symmetry (one class —
        the one containing the last rate — is pinned to 1)."""
        cls = self.rate_classes()
        return len(np.unique(cls)) - 1

    @property
    def n_free_freqs(self) -> int:
        cls = self.freq_classes()
        return len(np.unique(cls)) - 1

    def rates_opt_classes(self) -> tuple[np.ndarray, int]:
        """(class vector remapped to 0..K-1, index of the pinned class).

        The pinned class is the symmetry class of the LAST rate (GT for
        DNA), fixed at 1.0 — the reference's convention when packing ``x``
        for L-BFGS-B (``pllmod_algorithm.c:1043-1099``).
        """
        cls = self.rate_classes()
        uniq, remap = np.unique(cls, return_inverse=True)
        return remap.astype(np.int32), int(remap[-1])

    def pack_rates(self, full: np.ndarray) -> np.ndarray:
        """Full rate vector -> free parameter vector (normalized so the
        pinned class is 1)."""
        remap, pinned = self.rates_opt_classes()
        k = remap.max() + 1
        first = np.zeros(k, dtype=np.int64)
        seen = np.zeros(k, dtype=bool)
        for i, c in enumerate(remap):
            if not seen[c]:
                first[c] = i
                seen[c] = True
        vals = np.asarray(full)[first]
        vals = vals / vals[pinned]
        return np.delete(vals, pinned)

    def expand_rates(self, free):
        """Free parameter vector -> full rate vector (a differentiable
        gather on tensors; numpy or a list gives a float64 tensor)."""
        remap, pinned = self.rates_opt_classes()
        k = int(remap.max()) + 1
        if not isinstance(free, torch.Tensor):
            free = torch.as_tensor(np.asarray(free, np.float64))
        ones = torch.ones(1, dtype=free.dtype, device=free.device)
        vals = torch.cat([free[:pinned], ones, free[pinned:]]) \
            if k > 1 else ones
        return vals[torch.as_tensor(remap, dtype=torch.int64,
                                    device=free.device)]

    def update_partition(self, partition, matrix_index: int = 0):
        """Push this model's rates/freqs into a Partition (the
        ``pllmod_util_model_set_*`` analog). Unset (None) parameters keep
        the partition's current values."""
        sr, fq = partition.subst_rates, partition.freqs
        if self.rates is not None:
            sr = set_row(sr, matrix_index, self.rates)
        if self.freqs is not None:
            fq = set_row(fq, matrix_index, self.freqs)
        return partition.with_model_params(subst_rates=sr, freqs=fq)


def set_row(t, index: int, values):
    """A copy of tensor ``t`` with row ``index`` set to ``values`` (the
    JAX package's ``t.at[index].set(values)``)."""
    out = t.clone()
    out[index] = torch.as_tensor(np.asarray(values, np.float64),
                                 dtype=t.dtype, device=t.device)
    return out


@dataclasses.dataclass(frozen=True)
class MixtureModel:
    """Mixture of substitution models (pllmod_util.h:56-64): one component
    per rate category, with mixture rates/weights either FIXED, GAMMA-tied
    (LG4M) or FREE (LG4X)."""
    name: str
    components: tuple[SubstModel, ...]
    mix_rates: np.ndarray | None = None
    mix_weights: np.ndarray | None = None
    mix_type: int = MIXTYPE_FIXED

    def __post_init__(self):
        if not self.components:
            raise UtilError(UTIL_ERROR_MIXTURE_INVALID_SIZE, "empty mixture")
        states = {m.states for m in self.components}
        if len(states) != 1:
            raise UtilError(UTIL_ERROR_MIXTURE_INVALID_SIZE,
                            "mixture components must share state count")

    @property
    def states(self) -> int:
        return self.components[0].states

    @property
    def n_components(self) -> int:
        return len(self.components)


def create_custom(name: str, states: int, rates=None, freqs=None,
                  rate_sym: str | np.ndarray | None = None,
                  freq_sym: str | np.ndarray | None = None) -> SubstModel:
    """``pllmod_util_model_create_custom`` analog (models.c:47)."""
    if isinstance(rate_sym, str):
        rate_sym = string_to_sym(rate_sym)
    if isinstance(freq_sym, str):
        freq_sym = string_to_sym(freq_sym)
    return SubstModel(name, states, rates, freqs, rate_sym, freq_sym)


# ---------------------------------------------------------------------------
# Cross-datatype dispatch (model_info over all registries)
# ---------------------------------------------------------------------------
def _registries():
    from pllmod_tpu_torch.utils import models_dna, models_aa, models_gt, models_mult
    return (models_dna, models_aa, models_gt, models_mult)


def model_exists(name: str) -> bool:
    return any(r.exists(name) for r in _registries())


def model_info(name: str) -> SubstModel:
    """Look up a model by name across DNA / protein / genotype / multistate
    registries (case-insensitive, aliases resolved)."""
    for r in _registries():
        if r.exists(name):
            return r.info(name)
    raise UtilError(UTIL_ERROR_MODEL_UNKNOWN, f"model not found: {name}")


def model_names(datatype: str | None = None) -> list[str]:
    from pllmod_tpu_torch.utils import models_dna, models_aa, models_gt
    by_type = {"dna": models_dna, "aa": models_aa, "protein": models_aa,
               "gt": models_gt, "genotype": models_gt}
    if datatype is None:
        return sum((m.names() for m in (models_dna, models_aa, models_gt)), [])
    return by_type[datatype.lower()].names()
