"""Rasterized datasets: spatial crops of big clouds as training samples.

Port of ``treemorph_tpu/data/rasterized.py`` (host numpy; reference
``Modules/DataLoading/RasterizedTreeSet.py``):

- :class:`RasterDataset`, the "flattened" view (:11-148): each per-raster
  ``.npy`` (trailing point-index column) is an independent sample;
- :class:`HierarchicalRasterDataset`, the hierarchical view (:152-268):
  one sample is one tree cut into rasters by the rasterizer's AABB
  metadata JSON, with per-raster ``point_ids`` into the tree cloud.

The reference streams raster minibatches through the model with a backward
per minibatch (``collate_fn_streaming``). Here every raster minibatch is an
ordinary :class:`~treemorph_tpu_torch.data.treeset.PaddedBatch`, and
:func:`hierarchical_group_iterator` groups a tree batch's minibatches for
one optimizer step over their accumulated gradient
(:func:`treemorph_tpu_torch.train.harness.make_accum_steps`). Batches,
their padding buckets and their order under a numpy seed are the JAX
package's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..utils.io import load_cloud
from .treeset import PaddedBatch, TreeSample, make_padded_batch


class RasterDataset:
    """Flattened raster dataset: every raster file is its own sample."""

    def __init__(
        self,
        data_paths: Sequence[str],
        training: bool,
        noise_distance: float = 0.05,
        augment=None,
    ):
        self.data_paths = list(data_paths)
        self.training = training
        self.noise_distance = noise_distance
        self.augment = augment

    def __len__(self):
        return len(self.data_paths)

    def __getitem__(self, idx: int) -> TreeSample:
        data = load_cloud(self.data_paths[idx], all_columns=True)
        points = data[:, :3]
        offsets = data[:, 3:6]
        feats = data[:, 7:11]
        # the trailing column is the point index into the source cloud
        # (reference RasterizedTreeSet.py:50-55); the path keeps it
        off_norm = np.linalg.norm(offsets, axis=1)
        if self.augment is not None and self.training:
            points, offsets = self.augment(points, offsets)
        return TreeSample(
            points=points.astype(np.float32),
            feats=feats.astype(np.float32),
            offsets=offsets.astype(np.float32),
            semantic_label=(off_norm > self.noise_distance).astype(np.int32),
            offset_mask=off_norm <= self.noise_distance,
            path=self.data_paths[idx],
        )


@dataclass
class TreeRasters:
    """One tree expanded into rasters (hierarchical sample)."""

    points: np.ndarray  # (N, 3) full tree
    feats: np.ndarray  # (N, F)
    offsets: np.ndarray  # (N, 3)
    semantic_label: np.ndarray  # (N,)
    offset_mask: np.ndarray  # (N,)
    raster_point_ids: list[np.ndarray]  # per raster, indices into the tree
    path: str

    @property
    def cloud_length(self) -> int:
        return len(self.points)


class HierarchicalRasterDataset:
    """Tree-level dataset cut into rasters by AABB metadata JSON, the
    layout :func:`treemorph_tpu_torch.preprocess.rasterize_clouds` writes
    (reference ``RasterizeClouds.py:88-118``): ``{tree_id: {rasters:
    [{raster_id, bounds: {min, max}}], path}}``. Several JSONs merge, a
    tree's rasters concatenated in file order."""

    def __init__(
        self,
        paths: str | Sequence[str],
        training: bool = True,
        noise_distance: float = 0.05,
        minibatch_size: int = 20,
        single_sample: bool = False,
        augment=None,
    ):
        if isinstance(paths, str):
            paths = [paths]
        self.data: dict = {}
        for json_path in paths:
            with open(json_path) as f:
                new_data = json.load(f)
            for key, value in new_data.items():
                if key in self.data:
                    self.data[key]["rasters"].extend(value["rasters"])
                else:
                    self.data[key] = value
        self.tree_keys = list(self.data)
        if single_sample and self.tree_keys:
            self.tree_keys = self.tree_keys[:1]
        self.training = training
        self.noise_distance = noise_distance
        self.minibatch_size = minibatch_size
        self.augment = augment

    def __len__(self):
        return len(self.tree_keys)

    def __getitem__(self, idx: int) -> TreeRasters:
        info = self.data[self.tree_keys[idx]]
        data = load_cloud(info["path"], all_columns=True)
        if data.shape[1] == 3:
            data = np.concatenate(
                [data, np.zeros((len(data), 8), data.dtype)], axis=1
            )
        points = data[:, :3].astype(np.float32)
        offsets = data[:, 3:6].astype(np.float32)
        feats = data[:, 7:11].astype(np.float32)
        off_norm = np.linalg.norm(offsets, axis=1)
        if self.augment is not None and self.training:
            points, offsets = self.augment(points, offsets)

        raster_point_ids = []
        for raster in info["rasters"]:
            lo = np.asarray(raster["bounds"]["min"], np.float32)
            hi = np.asarray(raster["bounds"]["max"], np.float32)
            mask = np.all((points >= lo) & (points < hi), axis=1)
            idxs = np.nonzero(mask)[0]
            if len(idxs):
                raster_point_ids.append(idxs)

        return TreeRasters(
            points=points,
            feats=feats,
            offsets=offsets,
            semantic_label=(off_norm > self.noise_distance).astype(np.int32),
            offset_mask=off_norm <= self.noise_distance,
            raster_point_ids=raster_point_ids,
            path=info["path"],
        )

    def minibatches(
        self, tree: TreeRasters, bucket: int = 512
    ) -> Iterator[tuple[PaddedBatch, list[np.ndarray]]]:
        """(PaddedBatch of ``minibatch_size`` rasters, their point ids)
        pairs, the counterpart of the reference's streaming collate
        (RasterizedTreeSet.py:390-459)."""
        rasters = tree.raster_point_ids
        for start in range(0, len(rasters), self.minibatch_size):
            chunk = rasters[start:start + self.minibatch_size]
            samples = [
                TreeSample(
                    points=tree.points[idx],
                    feats=tree.feats[idx],
                    offsets=tree.offsets[idx],
                    semantic_label=tree.semantic_label[idx],
                    offset_mask=tree.offset_mask[idx],
                    path=tree.path,
                )
                for idx in chunk
            ]
            yield make_padded_batch(samples, bucket), list(chunk)


def raster_dataset_from_dir(
    raster_dir: str, training: bool, noise_distance: float = 0.05
) -> RasterDataset:
    """Flattened dataset over a rasterizer output directory."""
    paths = sorted(
        os.path.join(raster_dir, f)
        for f in os.listdir(raster_dir)
        if f.endswith(".npy")
    )
    return RasterDataset(paths, training, noise_distance)


def _tree_order(dataset: HierarchicalRasterDataset, rng) -> np.ndarray:
    """The trees' order: shuffled by ``rng`` (default seed 0) when
    training."""
    rng = rng if rng is not None else np.random.default_rng(0)
    order = np.arange(len(dataset))
    if dataset.training:
        rng.shuffle(order)
    return order


def _tree_minibatches(dataset, tree_idxs, bucket) -> Iterator[PaddedBatch]:
    for t in tree_idxs:
        tree = dataset[int(t)]
        for batch, _point_ids in dataset.minibatches(tree, bucket):
            yield batch


def hierarchical_batch_iterator(
    dataset: HierarchicalRasterDataset,
    bucket: int = 512,
    rng: np.random.Generator | None = None,
) -> Iterator[PaddedBatch]:
    """Every tree's raster minibatches as ordinary train batches, one
    optimizer step each (the CLI's ``--per_minibatch_steps``). The
    reference accumulates a tree batch's minibatches into one step
    (``train_utils.py:46-62``): :func:`hierarchical_group_iterator`."""
    yield from _tree_minibatches(dataset, _tree_order(dataset, rng), bucket)


def hierarchical_group_iterator(
    dataset: HierarchicalRasterDataset,
    bucket: int = 512,
    rng: np.random.Generator | None = None,
    trees_per_step: int = 1,
) -> Iterator[Iterator[PaddedBatch]]:
    """One group of raster minibatches per optimizer step: the minibatches
    of ``trees_per_step`` trees, whose gradients accumulate into one step
    (``train_utils.py:46-62``, ``PointNet2.py:296``). Feed the groups to
    ``run_training(..., accum_steps=make_accum_steps(...))``."""
    order = _tree_order(dataset, rng)
    for start in range(0, len(order), trees_per_step):
        yield _tree_minibatches(dataset, order[start:start + trees_per_step],
                                bucket)
