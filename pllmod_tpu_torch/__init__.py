"""pllmod_tpu_torch — the PyTorch/CUDA port of pllmod_tpu.

A second package beside the JAX reference (``pllmod_tpu``, which stays
as it is). It imports torch, numpy and scipy, never JAX nor the JAX
package. Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the kernels' plain torch versions on the CPU.

Slice 1 ports the full-tree log-likelihood:
``ops.partition.create_partition`` → ``ops.engine.tree_loglikelihood``,
on two CUDA kernels (``csrc/pruning.cu``): the shared-memory-resident
traversal (``ops.resident``) and the traversal that keeps every CLV in
device memory (``ops.fused``). Later slices add branch-length
optimization (``optimize.blo``), the level, grouped and packed
schedules (``ops.levels``, ``ops.grouped``, ``ops.packed``), the
partitioned layer (``tree.treeinfo``), the model registries
(``utils``), the alignment layer (``msa``), model-parameter
optimization (``algorithm.opt_model``, ``optimize.params``) and the
``eval`` command (``python -m pllmod_tpu_torch eval``, ``cli``).
``ROADMAP.md`` lists what is ported and what is left.
"""

import torch

# a float32 product (the P-matrix build) stays full float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
