"""High-level drivers (the reference's ``src/algorithm/``):

- :mod:`pllmod_tpu_torch.algorithm.opt_model` — model-parameter
  optimization over a TreeInfo (``pllmod_algorithm.c`` +
  ``algo_callback.c``)
- :mod:`pllmod_tpu_torch.algorithm.spr` — SPR-round topology search with
  batched regraft candidate scoring (``algo_search.c``)
- :mod:`pllmod_tpu_torch.algorithm.search` — the complete ML search
  (model optimization interleaved with SPR rounds, checkpoints)
- :mod:`pllmod_tpu_torch.algorithm.ancestral` — marginal ancestral states
"""

from pllmod_tpu_torch.algorithm.spr import SprEntry, spr_round  # noqa: F401
from pllmod_tpu_torch.algorithm.search import (  # noqa: F401
    ml_search,
    SearchResult,
    SearchRound,
)
from pllmod_tpu_torch.algorithm.ancestral import (  # noqa: F401
    ancestral_probabilities,
    ancestral_states,
)
