"""The one generator every traffic mix is read by.

A mix is a JSON file under ``benchmark/traffic/`` whose ``kind`` names the
loop that drives it (``train``) and whose other keys are its parameters.
Tree skeletons (stem, branches) come from the mix's fixed ``shape_seed``,
so every seed gets the same trees, and with them the same voxel counts and
work. A run's ``--seed`` draws the rest: each scan's points and noise, its
outliers, its turn about the vertical, its features, and the order of the
batches.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import trees

#: the labeled cloud layout the port's data files use: x, y, z, the offset
#: back to the surface (3), a cylinder id (unused), then the features
LABELED_COLUMNS = 11


def stream(seed: int, name: int) -> np.random.Generator:
    """The run's generator for one purpose, ``name``."""
    return np.random.default_rng([seed % (1 << 63), name])


def skeletons(spec: dict) -> list[dict]:
    rng = np.random.default_rng(spec["shape_seed"])
    lo, hi = spec["n_branches"]
    return [trees.skeleton(rng, n_branches=int(rng.integers(lo, hi + 1)))
            for _ in range(spec["trees"])]


def labeled_tree(sk: dict, rng: np.random.Generator, spec: dict):
    """One tree's ``(points_per_tree, 11)`` float32 labeled cloud. With
    ``points_per_m2`` the scan is laid out cylinder by cylinder at that
    density and its first ``points_per_tree`` points are kept, as
    ``scripts/bench_training.py:35-63`` shapes its trees (the stem's lower
    metres); without, the points spread over the whole tree by area.
    Radial noise is clipped to ``0.8 * noise_distance``, so that a point
    is noise (its offset longer than ``noise_distance``) exactly when it
    is one of the scan's outliers."""
    n = spec["points_per_tree"]
    if "points_per_m2" in spec:
        pts, back, outlier = trees.scan_in_order(
            sk, rng, spec["points_per_m2"], spec["noise_scale"],
            spec["outlier_fraction"])
        if len(pts) < n:
            raise ValueError(f"a scan of {len(pts)} points, under {n}")
        pts, back, outlier = pts[:n], back[:n], outlier[:n]
    else:
        pts, back, outlier = trees.scan(
            sk, rng, n, spec["noise_scale"], spec["outlier_fraction"])
    limit = 0.8 * spec["noise_distance"]
    length = np.linalg.norm(back, axis=1, keepdims=True)
    back = np.where(outlier[:, None] | (length <= limit), back,
                    back * (limit / np.maximum(length, 1e-12)))
    angle = rng.uniform(0.0, 2 * np.pi)
    pts, back = trees.rotate_z(pts, angle), trees.rotate_z(back, angle)
    feats = rng.normal(0.0, spec["feature_sigma"],
                       (n, spec["dim_feat"])).astype(np.float32)
    cloud = np.zeros((n, LABELED_COLUMNS), np.float32)
    cloud[:, 0:3] = pts
    cloud[:, 3:6] = back
    cloud[:, 7:7 + spec["dim_feat"]] = feats
    return cloud, outlier


def write_training_set(spec: dict, seed: int, root: str) -> tuple[str, list]:
    """The mix's trees as the training CLI's data files under ``root``:
    ``{i}_labeled.npy`` and a ``plot_1.json`` manifest listing them.
    Returns the manifest's path and the cloud paths in its order."""
    rng = stream(seed, 1)
    paths = []
    for i, sk in enumerate(skeletons(spec)):
        cloud, _ = labeled_tree(sk, rng, spec)
        path = os.path.join(root, f"1_{i}_labeled.npy")
        np.save(path, cloud)
        paths.append(path)
    manifest = os.path.join(root, "plot_1.json")
    with open(manifest, "w") as f:
        json.dump(paths, f)
    return manifest, paths


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The trees' order in ``epoch``: ``np.arange(n)`` shuffled in place
    by the epoch's generator, as the data loader shuffles it when handed
    that generator."""
    order = np.arange(n)
    epoch_rng(seed, epoch).shuffle(order)
    return order


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), 2, epoch])


def serving_pool(spec: dict, seed: int) -> list:
    """The ``serve`` mix's pool of single-tree clouds: sizes log-uniform in
    ``[points_min, points_max]`` and skeletons from the mix's
    ``shape_seed`` (the same for every seed), the scans and features from
    ``seed``. Each cloud is ``(n, 11)`` float32 in the labeled layout, its
    offsets zero, as the pipeline reads a raw cloud with features."""
    shapes = np.random.default_rng(spec["shape_seed"])
    lo, hi = spec["n_branches"]
    sizes = np.exp(shapes.uniform(np.log(spec["points_min"]),
                                  np.log(spec["points_max"]),
                                  spec["pool"])).astype(int)
    sks = [trees.skeleton(shapes, n_branches=int(shapes.integers(lo, hi + 1)))
           for _ in range(spec["pool"])]
    rng = stream(seed, 5)
    pool = []
    for sk, n in zip(sks, sizes):
        pts, _, _ = trees.scan(sk, rng, int(n), spec["noise_scale"],
                               spec["outlier_fraction"])
        cloud = np.zeros((int(n), LABELED_COLUMNS), np.float32)
        cloud[:, :3] = pts
        cloud[:, 7:7 + spec["dim_feat"]] = rng.normal(
            0.0, spec["feature_sigma"], (int(n), spec["dim_feat"]))
        pool.append(cloud)
    return pool


def request(pool: list, i: int, rng: np.random.Generator) -> np.ndarray:
    """Request ``i``: the pool's next cloud turned about the vertical by a
    fresh angle and moved by a fresh offset of up to 50 m."""
    cloud = pool[i % len(pool)].copy()
    cloud[:, :3] = trees.rotate_z(cloud[:, :3], rng.uniform(0.0, 2 * np.pi))
    cloud[:, :3] += rng.uniform(-50.0, 50.0, 3).astype(np.float32)
    return cloud
