"""Cloud rasterization: cut labeled clouds into overlapping cubes.

Port of ``treemorph_tpu/preprocess/rasterize.py`` (reference
``PreProcessing/RasterizeClouds.py``), host numpy: a cube grid of
``raster_size`` with ``stride`` (default size/2) over each labeled cloud;
per-raster ``.npy`` files with a trailing point-index column (:80-86) or an
AABB metadata JSON ``{tree_id: {rasters: [{raster_id, bounds}], path}}``
(:88-118), in an output directory named ``rasterized_R{size}_S{stride}``
(:139-141). The grid scan is
:func:`treemorph_tpu_torch.pipeline.predict.raster_assignments`, the one
the serving path cuts plots with.
"""

from __future__ import annotations

import json
import logging
import os
import re

import numpy as np

from ..pipeline.predict import raster_assignments
from ..utils.io import load_cloud

logger = logging.getLogger("treemorph_tpu_torch.preprocess")


def clean_stem(filename: str) -> str:
    """'33_22_labeled.npy' / '33_22_000000.csv' -> '33_22' (the JAX
    package's ``preprocess/label_generation.py::clean_stem``)."""
    base = os.path.splitext(os.path.basename(filename))[0]
    match = re.match(r"^(\d+_\d+)", base)
    return match.group(1) if match else base


def rasterize_clouds(
    data_paths: list[str],
    output_dir: str | None = None,
    json_path: str | None = None,
    raster_size: float = 1.0,
    stride: float | None = None,
    store_metadata: bool = False,
    min_points: int = 1,
) -> dict:
    """Rasterize clouds to files or to an AABB metadata JSON.

    Returns the metadata dict (also written to ``json_path`` when
    ``store_metadata``).
    """
    stride = stride if stride is not None else raster_size / 2
    if output_dir is not None:
        output_dir = os.path.join(
            output_dir, f"rasterized_R{raster_size}_S{stride}"
        )
        os.makedirs(output_dir, exist_ok=True)

    metadata: dict = {}
    total = 0
    for cloud_path in data_paths:
        tree_id = clean_stem(cloud_path)
        cloud = load_cloud(cloud_path, all_columns=True)
        if cloud is None or len(cloud) == 0:
            logger.warning("failed to load %s", cloud_path)
            continue
        points = cloud[:, :3]
        mins = points.min(axis=0)
        if store_metadata:
            metadata[tree_id] = {"rasters": [], "path": cloud_path}

        raster_id = 0
        for key, idx in raster_assignments(points, raster_size, stride):
            if len(idx) < min_points:
                continue
            origin = mins + np.asarray(key) * stride
            if store_metadata:
                metadata[tree_id]["rasters"].append(
                    {
                        "raster_id": raster_id,
                        "bounds": {
                            "min": [float(v) for v in origin],
                            "max": [
                                float(v + raster_size) for v in origin
                            ],
                        },
                    }
                )
            if output_dir is not None:
                # raster rows carry the original point index as the last
                # column for later reassembly (reference :80-86)
                raster = np.concatenate(
                    [cloud[idx], idx[:, None].astype(cloud.dtype)], axis=1
                )
                np.save(
                    os.path.join(
                        output_dir, f"{tree_id}_raster{raster_id}.npy"
                    ),
                    raster,
                )
            raster_id += 1
            total += 1

    if store_metadata and json_path is not None:
        with open(json_path, "w") as f:
            json.dump(metadata, f, indent=4)
    logger.info("rasterization created %d rasters", total)
    return metadata
