"""Data parallelism over several devices: the training mesh over
``torch.distributed`` and the one-process mesh of sharded inference."""

from .mesh import (
    LocalMesh,
    Mesh,
    make_local_mesh,
    make_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
    spawn_ranks,
)

__all__ = [
    "LocalMesh",
    "Mesh",
    "make_local_mesh",
    "make_mesh",
    "pad_batch_to_multiple",
    "replicate",
    "shard_batch",
    "spawn_ranks",
]
