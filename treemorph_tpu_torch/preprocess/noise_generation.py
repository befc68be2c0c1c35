"""Synthetic noise-cloud generation from QSMs.

Port of ``treemorph_tpu/preprocess/noise_generation.py`` (reference
``PreProcessing/NoiseDataGeneration.py``): points sampled on each QSM's
cylinder mantles with area- and height-dependent density and
lognormal(-3, 0.85) radial noise
(:func:`treemorph_tpu_torch.fixtures.synthetic.qsm_noise_cloud`, one numpy
generator of ``seed`` across the QSMs in name order), then labeled by
projecting them back onto the QSM on the device.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..fixtures.synthetic import qsm_noise_cloud
from ..ops.projection import generate_offset_cloud
from ..utils.device import resolve_device
from ..utils.table import Table
from .rasterize import clean_stem

logger = logging.getLogger("treemorph_tpu_torch.preprocess")


def noise_generation(
    cylinder_dir: str,
    output_dir: str,
    density: float = 50.0,
    with_labels: bool = True,
    seed: int = 0,
    device=None,
) -> list[str]:
    """A noise cloud per QSM csv in ``cylinder_dir``: with ``with_labels``
    the labeled (N, 11) layout (offsets to the QSM, ones as features), the
    ``noise_root`` a training set reads; else raw (N, 3) points like the
    reference (:103-106). Labels are computed on ``device`` (the CUDA
    device unless named; raises without one)."""
    if with_labels:
        device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for name in sorted(os.listdir(cylinder_dir)):
        if not name.endswith(".csv"):
            continue
        qsm = Table.read_csv(os.path.join(cylinder_dir, name))
        points = qsm_noise_cloud(qsm, density=density, rng=rng)
        if len(points) == 0:
            logger.warning("no noise points generated for %s", name)
            continue
        if with_labels:
            labeled = generate_offset_cloud(points, qsm, device=device)
            data = np.concatenate(
                [labeled, np.ones((len(labeled), 4), np.float32)], axis=1)
        else:
            data = points
        out_path = os.path.join(output_dir, f"{clean_stem(name)}.npy")
        np.save(out_path, data)
        written.append(out_path)
    return written
