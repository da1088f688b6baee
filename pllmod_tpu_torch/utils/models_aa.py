"""Protein model registry: 37 empirical matrices + LG4M/LG4X mixtures.

Counterpart of ``src/util/models_aa.c``: fixed-rate fixed-freq empirical
models (``models_aa.c:28-55``), the LG4M (Γ-linked) and LG4X (free-rate)
four-matrix mixtures (``models_aa.c:57-75``), and the free PROTGTR model.

The numeric tables live in :mod:`pllmod_tpu_torch.utils.aa_data` (transcribed
published data). The full reference registry lists 37 names; matrices whose
tables are not yet transcribed resolve to a clear ``UtilError`` pointing at
:func:`register_paml_dat`, which loads any standard PAML ``.dat`` file into
the registry at runtime.

Model-name modifiers follow the reference convention used by RAxML-NG: the
registry returns base models; empirical-vs-ML frequency choice is made by
the caller (``model_freqs`` flag of ``pllmod_util_model_set_protein``).
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import UtilError, UTIL_ERROR_MODEL_UNKNOWN
from pllmod_tpu_torch.utils import aa_data
from pllmod_tpu_torch.utils.models import (SubstModel, MixtureModel,
                                           MIXTYPE_GAMMA, MIXTYPE_FREE,
                                           set_row)

# the complete reference name list (models_aa.c:28-55 + PROTGTR)
ALL_NAMES = [
    "DAYHOFF", "LG", "DCMUT", "JTT", "MTREV", "WAG", "RTREV", "CPREV", "VT",
    "BLOSUM62", "MTMAM", "MTART", "MTZOA", "PMB", "HIVB", "HIVW",
    "JTT-DCMUT", "FLU", "STMTREV", "DEN",
    "Q.PFAM", "Q.PFAM_GB", "Q.LG", "Q.BIRD", "Q.INSECT", "Q.MAMMAL",
    "Q.PLANT", "Q.YEAST",
    "LG4M1", "LG4M2", "LG4M3", "LG4M4",
    "LG4X1", "LG4X2", "LG4X3", "LG4X4",
    "PROTGTR",
]

_runtime_matrices: dict[str, tuple[np.ndarray, np.ndarray]] = {}


def register_paml_dat(name: str, dat_text: str) -> SubstModel:
    """Load a PAML ``.dat`` matrix into the registry under ``name``."""
    rates, freqs = aa_data.parse_paml_dat(dat_text)
    _runtime_matrices[name.upper()] = (rates, freqs)
    return info(name)


def _lookup(name: str):
    key = name.upper()
    if key in _runtime_matrices:
        return _runtime_matrices[key]
    return aa_data.MATRICES.get(key)


def exists(name: str) -> bool:
    key = name.upper()
    return key in (n.upper() for n in ALL_NAMES) or key in _runtime_matrices


def info(name: str) -> SubstModel:
    key = name.upper()
    if key == "PROTGTR":
        return SubstModel("PROTGTR", 20, None, None, None, None)
    data = _lookup(key)
    if data is not None:
        rates, freqs = data
        # several published frequency vectors do not sum exactly to 1
        # (e.g. rtREV.dat sums to 0.998); normalize so Q is a proper
        # generator and the stationary distribution is exact.
        freqs = np.asarray(freqs, float)
        freqs = freqs / freqs.sum()
        return SubstModel(name.upper(), 20, rates, freqs, None, None)
    if exists(name):
        raise UtilError(
            UTIL_ERROR_MODEL_UNKNOWN,
            f"protein model {name}: matrix table not yet bundled; load the "
            f"published PAML .dat via pllmod_tpu_torch.utils.models_aa."
            f"register_paml_dat({name!r}, open('matrix.dat').read())")
    raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                    f"protein model not found: {name}")


def names() -> list[str]:
    return list(ALL_NAMES)


def count() -> int:
    return len(ALL_NAMES)


# ---------------------------------------------------------------------------
# Mixtures (models_aa.c:57-75, export :162-280)
# ---------------------------------------------------------------------------
def exists_protmix(name: str) -> bool:
    return name.upper() in ("LG4M", "LG4X")


def info_protmix(name: str) -> MixtureModel:
    """LG4M: 4 matrices, Γ-linked mixture rates; LG4X: free rates+weights."""
    key = name.upper()
    if key == "LG4M":
        comps = tuple(info(f"LG4M{i}") for i in (1, 2, 3, 4))
        return MixtureModel("LG4M", comps, mix_type=MIXTYPE_GAMMA)
    if key == "LG4X":
        comps = tuple(info(f"LG4X{i}") for i in (1, 2, 3, 4))
        return MixtureModel("LG4X", comps, mix_type=MIXTYPE_FREE)
    raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                    f"protein mixture not found: {name}")


def set_protein(partition, name: str, model_freqs: bool = True,
                matrix_index: int = 0):
    """Push a named protein model into a partition
    (``pllmod_util_model_set_protein``, models_aa.c exports). With
    ``model_freqs=False`` only the exchangeabilities are set (caller keeps
    empirical/ML frequencies)."""
    model = info(name)
    sr = set_row(partition.subst_rates, matrix_index, model.rates)
    out = partition.with_model_params(subst_rates=sr)
    if model_freqs and model.freqs is not None:
        out = out.with_model_params(
            freqs=set_row(out.freqs, matrix_index, model.freqs))
    return out


def set_protmix(partition, name: str, model_freqs: bool = True):
    """Push a 4-matrix mixture into a partition (one rate matrix per
    category; ``pllmod_util_model_set_protmix``)."""
    mix = info_protmix(name)
    if partition.n_matrices < mix.n_components:
        raise UtilError(UTIL_ERROR_MODEL_UNKNOWN,
                        f"partition has {partition.n_matrices} rate matrices; "
                        f"{name} needs {mix.n_components}")
    out = partition
    for i, comp in enumerate(mix.components):
        sr = set_row(out.subst_rates, i, comp.rates)
        out = out.with_model_params(subst_rates=sr)
        if model_freqs and comp.freqs is not None:
            out = out.with_model_params(
                freqs=set_row(out.freqs, i, comp.freqs))
    pidx = torch.arange(mix.n_components, dtype=torch.int64,
                        device=out.device)
    return out.replace(param_indices=pidx)
