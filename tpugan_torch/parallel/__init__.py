"""Data parallelism over processes (counterpart of ``tpugan/parallel``)."""

from tpugan_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    auto_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "auto_mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "DATA_AXIS",
    "SPACE_AXIS",
]
