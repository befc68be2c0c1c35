"""Per-rank input pipeline for data-parallel training.

Port of ``treemorph_tpu/data/multihost.py``, with a rank and a world size in
place of JAX's process index and count:

1. :func:`host_shard_paths`: deterministic per-rank file sharding, so the
   ranks' local datasets are disjoint and together cover the corpus.
2. :func:`global_batch_from_local`: this rank's batch on this rank's
   device. JAX wraps each process's rows into global ``jax.Array`` s with
   ``make_array_from_process_local_data``; torch has no global arrays, so a
   rank keeps only its rows and the step's all-reduces join the ranks
   (:mod:`treemorph_tpu_torch.parallel.mesh`).
3. :func:`multihost_batch_iterator`: every rank draws the SAME global
   permutation (seeded identically), loads only its slice of each global
   batch, and pads it to the global batch's bucket, read from the ``.npy``
   headers, so that every rank's batch has the same shape.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np
import torch

from .treeset import (
    PaddedBatch,
    TreeDataset,
    _cloud_stem,
    make_padded_batch,
    pad_to_bucket,
)


def host_shard_paths(paths: Sequence[str], rank: int = 0,
                     world_size: int = 1) -> list[str]:
    """The subset of ``paths`` rank ``rank`` of ``world_size`` owns (round
    robin over the sorted list, so every rank computes the same
    assignment)."""
    return sorted(paths)[rank::world_size]


def global_batch_from_local(local_batch: PaddedBatch, mesh) -> PaddedBatch:
    """This rank's rows of the global batch as tensors on this rank's
    device: its part of the batch a data-parallel step sees."""
    return local_batch.map(lambda a: torch.as_tensor(a).to(mesh.device))


def multihost_batch_iterator(
    dataset: TreeDataset,
    global_batch_size: int,
    mesh=None,
    bucket: int = 1024,
    shuffle: bool | None = None,
    seed: int = 0,
    rank: int | None = None,
    world_size: int | None = None,
) -> Iterator[PaddedBatch]:
    """This rank's iterator over its rows of each global batch.

    Every rank seeds the same permutation; rank ``r`` loads rows
    ``[r*L, (r+1)*L)`` of each global batch (L = global / world) and pads
    them to the global batch's bucket. Trailing partial batches are
    dropped: a global batch must fill every rank. With a ``mesh`` the
    batches are tensors on its device (:func:`global_batch_from_local`) and
    the rank and world default to its own, else numpy, rank 0 of 1."""
    if mesh is not None:
        rank = mesh.rank if rank is None else rank
        world_size = mesh.size if world_size is None else world_size
    rank, world = rank or 0, world_size or 1
    if global_batch_size % world:
        raise ValueError(
            f"global_batch_size {global_batch_size} must divide over "
            f"{world} ranks"
        )
    local = global_batch_size // world
    rng = np.random.default_rng(seed)
    if shuffle is None:
        shuffle = dataset.training

    # Every rank pads its slice to the SAME point dimension: the point
    # counts of every tree (and its noise cloud) come from the .npy headers
    # up front, which reads no data and is the same on every rank.
    sizes = []
    for path in dataset.data_paths:
        n = np.load(path, mmap_mode="r").shape[0]
        base = os.path.basename(path)
        noise_path = dataset.noise_dict.get(
            base, dataset.noise_dict.get(_cloud_stem(base))
        )
        if noise_path is not None:
            n = max(n, np.load(noise_path, mmap_mode="r").shape[0])
        sizes.append(n)
    sizes = np.asarray(sizes)

    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order) - global_batch_size + 1,
                   global_batch_size):
        global_idx = order[i:i + global_batch_size]
        # the pad target of the GLOBAL batch, the same on every rank
        target = pad_to_bucket(int(sizes[global_idx].max()), bucket)
        mine = order[i + rank * local:i + (rank + 1) * local]
        local_batch = make_padded_batch([dataset[j] for j in mine],
                                        bucket=target)
        yield (local_batch if mesh is None
               else global_batch_from_local(local_batch, mesh))
