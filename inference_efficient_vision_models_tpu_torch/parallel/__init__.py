"""Data and model parallelism on ``torch.distributed`` (``mesh.py``)."""

from .mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    param_shardings,
    replicate,
    replicated,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "replicate",
    "param_shardings",
    "shard_batch",
    "initialize_distributed",
]
