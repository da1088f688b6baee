"""High-level drivers (the reference's ``src/algorithm/``):
:mod:`pllmod_tpu_torch.algorithm.opt_model`, model-parameter
optimization over a TreeInfo (``pllmod_algorithm.c`` +
``algo_callback.c``)."""
