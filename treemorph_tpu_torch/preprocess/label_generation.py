"""Supervision generation: project raw clouds onto reference QSMs.

Port of ``treemorph_tpu/preprocess/label_generation.py`` (reference
``PreProcessing/LabelGenerationCuda.py``): pair each cloud with its QSM
``.csv`` by the ``plot_tree`` filename prefix (:145-167), project it onto
the cylinders for offset labels (:113-135), append normals (k = 15) and
relative height (:194-200), and save ``*_labeled.npy`` in the (N, 11)
layout (:203-205). The projection and the KNN features run on the device
(:func:`~treemorph_tpu_torch.ops.projection.generate_offset_cloud`,
:func:`~treemorph_tpu_torch.ops.features.add_features`); the QSM tables are
read without pandas (:meth:`~treemorph_tpu_torch.utils.table.Table.
read_csv`).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..ops.features import add_features
from ..ops.projection import generate_offset_cloud
from ..utils.device import resolve_device
from ..utils.io import load_cloud
from ..utils.table import Table
from .rasterize import clean_stem

logger = logging.getLogger("treemorph_tpu_torch.preprocess")


def label_clouds(
    cloud_dir: str,
    cylinder_dir: str,
    label_dir: str,
    tile: int = 4096,
    use_features: bool = True,
    device=None,
) -> list[str]:
    """Label every cloud in ``cloud_dir`` against its matching QSM, on
    ``device`` (the CUDA device unless named; raises without one).
    Without ``use_features`` the four feature columns are ones. Returns
    the written ``*_labeled.npy`` paths."""
    device = resolve_device(device)
    os.makedirs(label_dir, exist_ok=True)
    clouds = {
        clean_stem(f): os.path.join(cloud_dir, f)
        for f in os.listdir(cloud_dir)
        if f.endswith((".npy", ".txt", ".las", ".laz"))
    }
    qsms = {
        clean_stem(f): os.path.join(cylinder_dir, f)
        for f in os.listdir(cylinder_dir)
        if f.endswith(".csv")
    }

    written = []
    for stem, cloud_path in sorted(clouds.items()):
        qsm_path = qsms.get(stem)
        if qsm_path is None:
            logger.warning("no QSM match for cloud %s", stem)
            continue
        cloud = load_cloud(cloud_path)
        if cloud is None or len(cloud) == 0:
            logger.warning("failed to load %s", cloud_path)
            continue
        qsm = Table.read_csv(qsm_path)
        labeled = generate_offset_cloud(cloud, qsm, tile=tile,
                                        device=device)  # (N, 7)
        if use_features:
            labeled = add_features(labeled, use_normals=True,
                                   use_heights=True, device=device)  # (N, 11)
        else:
            labeled = np.concatenate(
                [labeled, np.ones((len(labeled), 4), labeled.dtype)], axis=1)

        out_path = os.path.join(label_dir, f"{stem}_labeled.npy")
        np.save(out_path, labeled)
        written.append(out_path)
        logger.info("labeled %s -> %s (%d pts)", stem, out_path, len(labeled))
    return written
