"""Device-mesh sharding for site-pattern and partition data parallelism —
the counterpart of ``pllmod_tpu.parallel``.

The reference's abstract allreduce seam (``parallel_reduce_cb``,
``pll_tree.h:275-276``; SURVEY.md §2.10) becomes a single-controller
mesh of torch devices: the pattern axis of every partition is split over
the mesh (:func:`shard_partition`, :func:`shard_treeinfo`), or whole
partitions are (:mod:`~pllmod_tpu_torch.parallel.partition_dp`), each
device evaluates its own block, and the per-device sums meet in one
reduce in a fixed order (``engine.reduce_shards``).
"""

from pllmod_tpu_torch.parallel.sharding import (  # noqa: F401
    SITES_AXIS,
    Mesh,
    ShardedPartition,
    blo_sweep_fast_sharded,
    is_sharded,
    loglikelihood_fused_sharded,
    loglikelihood_resident_sharded,
    make_mesh,
    replicate,
    shard_partition,
    shard_treeinfo,
    shards_of,
)
from pllmod_tpu_torch.parallel.partition_dp import (  # noqa: F401
    PARTS_AXIS,
    PartitionStack,
    make_2d_mesh,
    make_parts_mesh,
    stack_partitions,
    total_loglh_partition_dp,
    total_loglh_partition_dp_2d,
    treeinfo_loglh_partition_dp,
)
