"""Optimization layer (the reference's ``src/optimize/``).

- :mod:`pllmod_tpu_torch.optimize.newton` — vectorized bracketed
  Newton-Raphson (``pllmod_opt_minimize_newton_multi``)
- :mod:`pllmod_tpu_torch.optimize.blo` — branch-length optimization on
  all edges at once from directed CLVs, and the chunked memory-bounded
  BLO by windows of edge-rooted bounded traversals
- :mod:`pllmod_tpu_torch.optimize.blo_bounded` — memory-bounded whole-tree
  BLO
- :mod:`pllmod_tpu_torch.optimize.brent` — lock-step Brent 1-D
  minimization (opt_algorithms.c:809-1467)
- :mod:`pllmod_tpu_torch.optimize.lbfgsb` — bound-constrained L-BFGS with
  analytic gradients (opt_algorithms.c:418-807)
- :mod:`pllmod_tpu_torch.optimize.em` — EM for rate/weight mixtures
  (opt_algorithms.c:1473-1546)
- :mod:`pllmod_tpu_torch.optimize.edge_grad` — model-parameter
  (value, grad) by edge decomposition over the directed CLVs, and the
  parameter packings
- :mod:`pllmod_tpu_torch.optimize.params` — one L-BFGS/Brent run over any
  PARAM_* combination (``pllmod_opt_optimize_onedim/multidim``)
"""

from pllmod_tpu_torch.optimize.newton import (  # noqa: F401
    minimize_newton_multi,
)
from pllmod_tpu_torch.optimize.blo import (  # noqa: F401
    DirectedTraversal,
    compile_chunked_blo,
    optimize_branch_lengths,
    optimize_branch_lengths_chunked,
)
from pllmod_tpu_torch.optimize.blo_bounded import (  # noqa: F401
    BoundedSweepSchedule,
    optimize_branch_lengths_bounded,
)
from pllmod_tpu_torch.optimize.brent import minimize_brent_multi  # noqa: F401
from pllmod_tpu_torch.optimize.em import em_rates_weights  # noqa: F401
from pllmod_tpu_torch.optimize.lbfgsb import minimize_lbfgsb  # noqa: F401
from pllmod_tpu_torch.optimize.params import (  # noqa: F401
    optimize_multidim,
    optimize_onedim,
)
