"""Padded, static-shape dataset + batching for labeled tree clouds.

Port of ``treemorph_tpu/data/treeset.py`` (host numpy, copied; reference
``Modules/DataLoading/TreeSet.py``): per-tree datasets built from JSON path
manifests, on-the-fly label derivation (semantic label = 1 for noise where
``|offset| > noise_distance``, offset-regression mask where
``|offset| <= noise_distance``; ``TreeSet.py:107-122``), optional separate
noise clouds keyed by filename (``:44-49, 111-121``), and random / per-plot
split factories (``:337-386``).

There is one batch layout, the padded ``(B, N, ...)`` :class:`PaddedBatch`
with validity masks, where N is bucketed (rounded up to a configurable
multiple). Voxel models consume it flattened to ``(B*N, ...)`` with derived
``batch_ids`` (:meth:`PaddedBatch.flatten`), the reference's flat layout.
The training harness moves each batch to the device once.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from ..utils.io import load_cloud


class PaddedBatch(NamedTuple):
    """Canonical static-shape batch. All arrays padded to (B, N, ...).

    The optional ``noise_*`` quartet carries the separate synthetic
    noise clouds (reference ``TreeSet.py:111-121`` + ``collate_fn_voxel``
    noise keys): padded to their own (B, M) — M is independent of N
    because noise clouds have different point counts than the main
    clouds. The semantic head trains on these via a second backbone pass
    (:func:`treemorph_tpu_torch.train.families.treelearn_noise_family`).
    All four are ``None`` unless every sample in the batch has a noise
    cloud.
    """

    coords: np.ndarray  # (B, N, 3) float32
    feats: np.ndarray  # (B, N, F) float32
    offset_labels: np.ndarray  # (B, N, 3) float32
    semantic_labels: np.ndarray  # (B, N) int32: 1 = noise, 0 = keep
    mask_valid: np.ndarray  # (B, N) bool: real (non-pad) points
    mask_off: np.ndarray  # (B, N) bool: points with offset supervision
    noise_coords: np.ndarray | None = None  # (B, M, 3) float32
    noise_feats: np.ndarray | None = None  # (B, M, F) float32
    noise_semantic: np.ndarray | None = None  # (B, M) int32
    noise_valid: np.ndarray | None = None  # (B, M) bool

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def num_points(self) -> int:
        return self.coords.shape[1]

    def map(self, fn) -> "PaddedBatch":
        """The batch with ``fn`` applied to every array present (e.g.
        ``torch.as_tensor``)."""
        return PaddedBatch(*(None if a is None else fn(a) for a in self))

    def flatten(self):
        """Flat-concat view: (B*N, ...) plus batch_ids — the voxel-model
        layout (reference ``collate_fn_voxel``, TreeSet.py:139-214)."""
        b, n = self.coords.shape[:2]
        batch_ids = np.repeat(np.arange(b, dtype=np.int32), n)
        return {
            "coords": self.coords.reshape(b * n, 3),
            "feats": self.feats.reshape(b * n, -1),
            "offset_labels": self.offset_labels.reshape(b * n, 3),
            "semantic_labels": self.semantic_labels.reshape(b * n),
            "mask_valid": self.mask_valid.reshape(b * n),
            "mask_off": self.mask_off.reshape(b * n),
            "batch_ids": batch_ids,
        }


def _cloud_stem(name: str) -> str:
    """``3_1_labeled.npy`` / ``3_1.npy`` -> ``3_1``."""
    stem = os.path.splitext(name)[0]
    if stem.endswith("_labeled"):
        stem = stem[: -len("_labeled")]
    return stem


def pad_to_bucket(n: int, bucket: int = 1024) -> int:
    """Round n up to a multiple of ``bucket`` (recompile containment)."""
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


@dataclass
class TreeSample:
    points: np.ndarray  # (N, 3)
    feats: np.ndarray  # (N, F)
    offsets: np.ndarray  # (N, 3)
    semantic_label: np.ndarray  # (N,) int32
    offset_mask: np.ndarray  # (N,) bool
    path: str
    # Separate synthetic noise cloud (reference TreeSet.py:111-121);
    # its length M is generally different from N.
    noise_points: np.ndarray | None = None  # (M, 3)
    noise_feats: np.ndarray | None = None  # (M, F)
    noise_semantic: np.ndarray | None = None  # (M,) int32


class TreeDataset:
    """Host-side labeled-cloud dataset.

    Args:
        paths: JSON manifest path(s) listing .npy labeled clouds, or (with
            ``process_json=False``) the cloud paths themselves.
        training: shuffling flag for iteration.
        noise_distance: offset-norm threshold splitting surface/noise points.
        noise_root: optional directory of synthetic noise clouds; when a file
            with the same basename exists there, its offsets define the
            semantic labels (reference TreeSet.py:111-121).
        augment: optional callable (points, offsets, rng) -> (points, offsets).
    """

    def __init__(
        self,
        paths: str | Sequence[str],
        training: bool,
        noise_distance: float = 0.05,
        noise_root: str | None = None,
        process_json: bool = True,
        augment=None,
    ):
        if isinstance(paths, str):
            paths = [paths]
        self.data_paths: list[str] = []
        if process_json:
            for manifest in paths:
                with open(manifest) as f:
                    self.data_paths.extend(json.load(f))
        else:
            self.data_paths = list(paths)

        # Keyed by exact basename (reference TreeSet.py:44-49) and by the
        # ``{plot}_{tree}`` stem, so noise clouds written as ``3_1.npy``
        # match labeled clouds named ``3_1_labeled.npy``.
        self.noise_dict: dict[str, str] = {}
        if noise_root:
            for name in os.listdir(noise_root):
                if name.endswith(".npy"):
                    path_ = os.path.join(noise_root, name)
                    self.noise_dict[name] = path_
                    self.noise_dict.setdefault(_cloud_stem(name), path_)

        self.training = training
        self.noise_distance = noise_distance
        self.augment = augment

    def __len__(self) -> int:
        return len(self.data_paths)

    def __getitem__(self, idx: int) -> TreeSample:
        path = self.data_paths[idx]
        data = load_cloud(path, all_columns=True)
        if data is None:
            raise FileNotFoundError(path)
        if data.shape[1] == 3:  # plain XYZ: zero labels/features
            data = np.concatenate(
                [data, np.zeros((len(data), 8), data.dtype)], axis=1
            )

        points = data[:, :3].astype(np.float32)
        offsets = data[:, 3:6].astype(np.float32)
        feats = data[:, 7:].astype(np.float32)

        off_norm = np.linalg.norm(offsets, axis=1)
        offset_mask = off_norm <= self.noise_distance

        # Main-cloud semantic labels (reference TreeSet.py:122); when a
        # separate noise cloud exists, the noise labels below supersede
        # these for the semantic head (the reference replaces the label
        # array outright, :111-121 — here both are carried so the offset
        # path stays aligned with the main cloud).
        semantic = (off_norm > self.noise_distance).astype(np.int32)

        noise_points = noise_feats = noise_semantic = None
        name = os.path.basename(path)
        noise_path = self.noise_dict.get(name) or self.noise_dict.get(
            _cloud_stem(name)
        )
        if noise_path is not None:
            noise = np.load(noise_path).astype(np.float32)
            noise_points = noise[:, :3]
            noise_feats = noise[:, 7:]
            noise_norm = np.linalg.norm(noise[:, 3:6], axis=1)
            noise_semantic = (noise_norm > self.noise_distance).astype(
                np.int32
            )

        if self.augment is not None and self.training:
            points, offsets = self.augment(points, offsets)

        return TreeSample(
            points=points,
            feats=feats,
            offsets=offsets,
            semantic_label=semantic,
            offset_mask=offset_mask,
            path=path,
            noise_points=noise_points,
            noise_feats=noise_feats,
            noise_semantic=noise_semantic,
        )


def make_padded_batch(
    samples: Sequence[TreeSample], bucket: int = 1024
) -> PaddedBatch:
    """Pad a list of samples to a common bucketed length."""
    max_n = pad_to_bucket(max(len(s.points) for s in samples), bucket)
    b = len(samples)
    f = samples[0].feats.shape[1]

    coords = np.zeros((b, max_n, 3), np.float32)
    feats = np.zeros((b, max_n, f), np.float32)
    offs = np.zeros((b, max_n, 3), np.float32)
    sem = np.zeros((b, max_n), np.int32)
    valid = np.zeros((b, max_n), bool)
    moff = np.zeros((b, max_n), bool)

    for i, s in enumerate(samples):
        n = len(s.points)
        coords[i, :n] = s.points
        feats[i, :n] = s.feats
        offs[i, :n] = s.offsets
        sem[i, :n] = s.semantic_label
        valid[i, :n] = True
        moff[i, :n] = s.offset_mask

    has_noise = [s.noise_points is not None for s in samples]
    if not any(has_noise):
        return PaddedBatch(coords, feats, offs, sem, valid, moff)
    if not all(has_noise):
        # The reference's forward would shape-mismatch on a mixed batch
        # (noise logits vs mixed-length labels); fail loudly instead.
        raise ValueError(
            "mixed batch: some samples have a noise cloud, some do not "
            f"({[s.path for s, h in zip(samples, has_noise) if not h]})"
        )

    max_m = pad_to_bucket(max(len(s.noise_points) for s in samples), bucket)
    n_coords = np.zeros((b, max_m, 3), np.float32)
    n_feats = np.zeros((b, max_m, f), np.float32)
    n_sem = np.zeros((b, max_m), np.int32)
    n_valid = np.zeros((b, max_m), bool)
    for i, s in enumerate(samples):
        m = len(s.noise_points)
        n_coords[i, :m] = s.noise_points
        n_feats[i, :m] = s.noise_feats
        n_sem[i, :m] = s.noise_semantic
        n_valid[i, :m] = True
    return PaddedBatch(
        coords, feats, offs, sem, valid, moff,
        noise_coords=n_coords,
        noise_feats=n_feats,
        noise_semantic=n_sem,
        noise_valid=n_valid,
    )


def batch_iterator(
    dataset: TreeDataset,
    batch_size: int,
    bucket: int = 1024,
    shuffle: bool | None = None,
    rng: np.random.Generator | None = None,
    drop_last: bool = False,
) -> Iterator[PaddedBatch]:
    """Yield PaddedBatches; shuffles when training."""
    rng = rng or np.random.default_rng(0)
    if shuffle is None:
        shuffle = dataset.training
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        yield make_padded_batch([dataset[j] for j in idx], bucket)


def get_random_split(
    data_root: str, noise_distance: float = 0.05, noise_root=None, augment=None
):
    """trainset.json / testset.json split (reference TreeSet.py:337-354)."""
    return (
        TreeDataset(
            os.path.join(data_root, "trainset.json"),
            training=True,
            noise_distance=noise_distance,
            noise_root=noise_root,
            augment=augment,
        ),
        TreeDataset(
            os.path.join(data_root, "testset.json"),
            training=False,
            noise_distance=noise_distance,
            noise_root=noise_root,
        ),
    )


def get_plot_split(
    data_root: str,
    test_plot: int | str,
    noise_distance: float = 0.05,
    noise_root=None,
    augment=None,
):
    """Leave-one-plot-out split over plot_{n}.json manifests
    (reference TreeSet.py:357-386)."""
    train_manifests, test_manifests = [], []
    for name in os.listdir(data_root):
        if name.startswith("plot_") and name.endswith(".json"):
            plot_number = name.split("_")[1].split(".")[0]
            full = os.path.join(data_root, name)
            if plot_number == str(test_plot):
                test_manifests.append(full)
            else:
                train_manifests.append(full)
    return (
        TreeDataset(
            train_manifests,
            training=True,
            noise_distance=noise_distance,
            noise_root=noise_root,
            augment=augment,
        ),
        TreeDataset(
            test_manifests,
            training=False,
            noise_distance=noise_distance,
            noise_root=noise_root,
        ),
    )
