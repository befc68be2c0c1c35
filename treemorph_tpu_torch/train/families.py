"""Model-family adapters: uniform (forward_fn, loss_fn) pairs for the
harness.

Port of ``treemorph_tpu/train/families.py``. The harness hands over a
:class:`~treemorph_tpu_torch.data.PaddedBatch` of tensors and, in a train
step, the step's ``torch.Generator``. The voxel models consume the flat
layout, so their adapters reshape (views, no copies); PointNet2 takes the
padded batch as it is. TreeLearn draws nothing at random; PTv3 draws its
order shuffles and stochastic-depth masks from the step's generator,
PointNet2 the first centroid of each level's farthest-point sampling.

Each family takes ``group``, the data-parallel
:class:`~treemorph_tpu_torch.parallel.Mesh` its loss reduces over (the JAX
families' ``axis_name``); ``None`` on one device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import ptv3
from ..models.loss import point_wise_loss
from ..models.pointnet2 import PointNet2, pointnet2_loss
from ..models.treelearn import TreeLearn, treelearn_loss


def pointnet2_family(
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    group=None,
) -> tuple[Callable, Callable]:
    """(forward_fn, loss_fn) for the harness, PointNet2 flavor. In train
    mode BatchNorm normalizes with batch statistics and updates its running
    ones, and the step's generator draws each level's first FPS centroid
    (the JAX family hands the step key to the model as ``fps_rng``); eval
    mode starts FPS at the first valid point."""

    def forward_fn(model: PointNet2, batch, train: bool, generator=None):
        return model.train(train)(batch.coords, batch.feats,
                                  batch.mask_valid,
                                  generator if train else None)

    def loss_fn(output, batch):
        return pointnet2_loss(
            output,
            batch,
            loss_multiplier_semantic=loss_multiplier_semantic,
            loss_multiplier_offset=loss_multiplier_offset,
            group=group,
        )

    return forward_fn, loss_fn


def init_pointnet2(model: PointNet2, seed: int = 0) -> PointNet2:
    """``model`` with flax's initializers drawn from ``seed``."""
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def _flatten_padded(batch) -> dict:
    """PaddedBatch -> flat voxel-model tensors."""
    b, n = batch.coords.shape[:2]
    batch_ids = torch.arange(
        b, dtype=torch.int32, device=batch.coords.device
    ).repeat_interleave(n)
    return {
        "coords": batch.coords.reshape(b * n, 3),
        "feats": batch.feats.reshape(b * n, -1),
        "batch_ids": batch_ids,
        "mask_valid": batch.mask_valid.reshape(b * n),
        "offset_labels": batch.offset_labels.reshape(b * n, 3),
        "semantic_labels": batch.semantic_labels.reshape(b * n),
        "mask_off": batch.mask_off.reshape(b * n),
    }


def _flatten_noise(batch) -> dict:
    """PaddedBatch noise quartet -> flat voxel-model tensors."""
    if batch.noise_coords is None:
        raise ValueError(
            "noise-cloud training requested but this batch carries no "
            "noise clouds — every cloud in the dataset needs a matching "
            ".npy under --noise_root (matched by basename or "
            "'{plot}_{tree}' stem)"
        )
    b, m = batch.noise_coords.shape[:2]
    batch_ids = torch.arange(
        b, dtype=torch.int32, device=batch.noise_coords.device
    ).repeat_interleave(m)
    return {
        "coords": batch.noise_coords.reshape(b * m, 3),
        "feats": batch.noise_feats.reshape(b * m, -1),
        "batch_ids": batch_ids,
        "mask_valid": batch.noise_valid.reshape(b * m),
        "semantic_labels": batch.noise_semantic.reshape(b * m),
    }


def treelearn_family(
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    group=None,
) -> tuple[Callable, Callable]:
    """(forward_fn, loss_fn) for the harness, TreeLearn flavor."""

    def forward_fn(model: TreeLearn, batch, train: bool, generator=None):
        flat = _flatten_padded(batch)
        return model.train(train)(
            flat["coords"], flat["feats"], flat["batch_ids"],
            flat["mask_valid"],
        )

    def loss_fn(output, batch):
        return treelearn_loss(
            output,
            _flatten_padded(batch),
            loss_multiplier_semantic=loss_multiplier_semantic,
            loss_multiplier_offset=loss_multiplier_offset,
            group=group,
        )

    return forward_fn, loss_fn


def treelearn_noise_family(
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    group=None,
) -> tuple[Callable, Callable]:
    """TreeLearn with the separate noise-cloud semantic pass (reference
    ``TreeLearn.py:98-105``, ``137-141``): the backbone runs a second,
    weight-shared pass over the synthetic noise cloud, the semantic head
    reads that pass, and the semantic CE is taken against the noise
    cloud's labels. The offset loss stays on the main cloud."""

    def forward_fn(model: TreeLearn, batch, train: bool, generator=None):
        flat = _flatten_padded(batch)
        nflat = _flatten_noise(batch)
        return model.train(train)(
            flat["coords"], flat["feats"], flat["batch_ids"],
            flat["mask_valid"],
            noise_coords=nflat["coords"],
            noise_feats=nflat["feats"],
            noise_batch_ids=nflat["batch_ids"],
            noise_valid=nflat["mask_valid"],
        )

    def loss_fn(output, batch):
        flat = _flatten_padded(batch)
        nflat = _flatten_noise(batch)
        sem_loss, off_loss = point_wise_loss(
            output["semantic_prediction_logits"],
            output["offset_predictions"],
            nflat["semantic_labels"],
            flat["offset_labels"],
            semantic_mask=nflat["mask_valid"],
            offset_mask=flat["mask_valid"] & flat["mask_off"],
            group=group,
        )
        loss_dict = {
            "semantic_loss": sem_loss * loss_multiplier_semantic,
            "offset_loss": off_loss * loss_multiplier_offset,
        }
        return sum(loss_dict.values()), loss_dict

    return forward_fn, loss_fn


def init_treelearn(model: TreeLearn, seed: int = 0) -> TreeLearn:
    """``model`` with flax's initializers drawn from ``seed`` (the weights
    do not depend on the batch, so no example batch is needed)."""
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def split_step_generator(generator: torch.Generator, device):
    """The step's generator split in two, as the JAX family splits the step
    key: a CPU generator for the order shuffles and one on ``device`` for
    the stochastic-depth masks, each seeded from ``generator``."""
    seeds = torch.randint(0, 2**62, (2,), generator=generator)
    shuffle = torch.Generator().manual_seed(int(seeds[0]))
    drop = torch.Generator(device=device).manual_seed(int(seeds[1]))
    return shuffle, drop


def ptv3_family(
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    group=None,
) -> tuple[Callable, Callable]:
    """(forward_fn, loss_fn) for the harness, PTv3 flavor. In train mode
    the step's generator feeds order shuffling and stochastic depth (the
    reference's shuffle_orders and DropPath, ``PointTransformerV3.py:299``,
    ``blocks.py:599-601``); eval mode draws nothing."""

    def forward_fn(model: ptv3.PointTransformerWithHeads, batch, train: bool,
                   generator=None):
        flat = _flatten_padded(batch)
        args = (flat["coords"], flat["feats"], flat["batch_ids"],
                flat["mask_valid"])
        if not train:
            return model.train(False)(*args)
        if generator is None:
            raise ValueError("a PTv3 train step draws its order shuffles and "
                             "drop-path masks from the step's generator")
        shuffle, drop = split_step_generator(generator, args[0].device)
        perms = ptv3.draw_order_perms(shuffle, len(model.backbone.enc_depths))
        return model.train(True)(*args, order_perms=perms, generator=drop)

    def loss_fn(output, batch):
        return ptv3.ptv3_loss(
            output,
            _flatten_padded(batch),
            loss_multiplier_semantic=loss_multiplier_semantic,
            loss_multiplier_offset=loss_multiplier_offset,
            group=group,
        )

    return forward_fn, loss_fn


def init_ptv3(model: ptv3.PointTransformerWithHeads,
              seed: int = 0) -> ptv3.PointTransformerWithHeads:
    """``model`` with flax's initializers drawn from ``seed``."""
    return model.reset_parameters(torch.Generator().manual_seed(seed))
