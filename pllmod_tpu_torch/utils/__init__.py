"""Substitution-model registry (the port's copy of the JAX package's registry;
the reference's ``src/util/``).

- :mod:`pllmod_tpu_torch.utils.models` — model descriptors, symmetry-class
  parameter packing, custom models, mixtures (``models.c``)
- :mod:`pllmod_tpu_torch.utils.models_dna` — 22 named DNA models + aliases
- :mod:`pllmod_tpu_torch.utils.models_aa` — 37 empirical protein matrices +
  LG4M/LG4X mixtures
- :mod:`pllmod_tpu_torch.utils.models_gt` — 9 genotype models (10/16 states)
- :mod:`pllmod_tpu_torch.utils.models_mult` — MULTIx_GTR/MK/JC multistate models
"""

from pllmod_tpu_torch.utils.models import (  # noqa: F401
    SubstModel,
    MixtureModel,
    MIXTYPE_FIXED,
    MIXTYPE_GAMMA,
    MIXTYPE_FREE,
    model_info,
    model_exists,
    model_names,
    create_custom,
    string_to_sym,
    subst_rate_count,
    equal_rates,
    equal_freqs,
)
