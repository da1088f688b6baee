"""Binary checkpointing (the reference's ``src/binary/``), in the JAX
package's file format."""

from pllmod_tpu_torch.binary.binary import (  # noqa: F401
    BinaryFile,
    attach_skeleton,
    save_treeinfo,
    load_treeinfo,
    ACCESS_SEQUENTIAL,
    ACCESS_RANDOM,
    BLOCK_PARTITION,
    BLOCK_CLV,
    BLOCK_TREE,
    BLOCK_CUSTOM,
)
