"""Dataset splitting: random train/test sets and per-plot CV manifests.

Port of ``treemorph_tpu/preprocess/splitting.py`` (reference
``PreProcessing/DataSplitting.py``: a random 85/15 split into
``trainset.json`` / ``testset.json`` and ``plot_{n}.json`` manifests per
plot for leave-one-plot-out CV, :21-71, and the raster-metadata variant,
:73-110; ``PreProcessing/CreateQSMTestData.py``: ``n_per_plot`` trees per
plot into ``qsm_set_{n}.json``; ``PreProcessing/SelectTestData.py``). Host
numpy, the same manifests and the same file choices for a seed.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from collections import defaultdict

import numpy as np

logger = logging.getLogger("treemorph_tpu_torch.preprocess")


def _plot_of(filename: str) -> str:
    """Plot id = leading digits before the first underscore.

    The reference uses only the first character (DataSplitting.py:61);
    using the full leading number is strictly more correct for >9 plots
    while identical for the reference's single-digit plots.
    """
    base = os.path.basename(filename)
    m = re.match(r"^(\d+)_", base)
    return m.group(1) if m else base[:1]


def split_dataset(
    data_dir: str,
    eval_dir: str,
    test_size: float = 0.15,
    random_state: int = 42,
    raster_metadata: bool = False,
) -> dict:
    """Write trainset/testset JSONs + per-plot manifests.

    With ``raster_metadata``, ``data_dir`` is the metadata JSON path and
    the split operates on tree keys (reference :73-110).
    """
    os.makedirs(eval_dir, exist_ok=True)
    rng = np.random.default_rng(random_state)

    if not raster_metadata:
        files = sorted(
            os.path.join(data_dir, f)
            for f in os.listdir(data_dir)
            if f.endswith("labeled.npy")
        )
        perm = rng.permutation(len(files))
        n_test = max(int(round(len(files) * test_size)), 1) if files else 0
        test_idx = set(perm[:n_test].tolist())
        train = [f for i, f in enumerate(files) if i not in test_idx]
        test = [f for i, f in enumerate(files) if i in test_idx]

        with open(os.path.join(eval_dir, "trainset.json"), "w") as f:
            json.dump(train, f, indent=4)
        with open(os.path.join(eval_dir, "testset.json"), "w") as f:
            json.dump(test, f, indent=4)

        by_plot = defaultdict(list)
        for path in files:
            by_plot[_plot_of(path)].append(path)
        for plot, paths in by_plot.items():
            with open(
                os.path.join(eval_dir, f"plot_{plot}.json"), "w"
            ) as f:
                json.dump(paths, f, indent=4)
        return {"train": train, "test": test, "plots": dict(by_plot)}

    with open(data_dir) as f:
        metadata = json.load(f)
    keys = sorted(metadata)
    perm = rng.permutation(len(keys))
    n_test = max(int(round(len(keys) * test_size)), 1) if keys else 0
    test_keys = {keys[i] for i in perm[:n_test]}
    train_md = {k: metadata[k] for k in keys if k not in test_keys}
    test_md = {k: metadata[k] for k in keys if k in test_keys}
    with open(
        os.path.join(eval_dir, "rasters_metadata_trainset.json"), "w"
    ) as f:
        json.dump(train_md, f, indent=4)
    with open(
        os.path.join(eval_dir, "rasters_metadata_testset.json"), "w"
    ) as f:
        json.dump(test_md, f, indent=4)

    by_plot = defaultdict(dict)
    for k in keys:
        by_plot[_plot_of(k)][k] = metadata[k]
    for plot, md in by_plot.items():
        with open(
            os.path.join(eval_dir, f"rasters_metadata_plot_{plot}.json"),
            "w",
        ) as f:
            json.dump(md, f, indent=4)
    return {"train": train_md, "test": test_md, "plots": dict(by_plot)}


def create_qsm_test_sets(
    data_dir: str,
    output_dir: str,
    n_per_plot: int = 10,
    random_state: int = 42,
) -> dict:
    """Sample n trees per plot into ``qsm_set_{plot}.json``
    (reference CreateQSMTestData.py:16-54)."""
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(random_state)
    files = sorted(
        os.path.join(data_dir, f)
        for f in os.listdir(data_dir)
        if f.endswith(".npy")
    )
    by_plot = defaultdict(list)
    for path in files:
        by_plot[_plot_of(path)].append(path)

    sets = {}
    for plot, paths in by_plot.items():
        chosen = (
            list(rng.choice(paths, n_per_plot, replace=False))
            if len(paths) > n_per_plot
            else list(paths)
        )
        with open(
            os.path.join(output_dir, f"qsm_set_{plot}.json"), "w"
        ) as f:
            json.dump(chosen, f, indent=4)
        sets[plot] = chosen
    return sets


def select_test_subset(
    cloud_dir: str,
    qsm_dir: str,
    out_cloud_dir: str,
    out_qsm_dir: str,
    n: int = 40,
    seed: int = 0,
    cloud_suffix: str = ".laz",
):
    """Copy a random subset of external test clouds with their matching
    QSM CSVs (reference ``PreProcessing/SelectTestData.py``): clouds and
    QSMs pair on the first three underscore-separated name tokens.

    Returns the list of (cloud, qsm) basename pairs copied.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_cloud_dir, exist_ok=True)
    os.makedirs(out_qsm_dir, exist_ok=True)

    def prefix(name):
        return "_".join(name.split("_")[:3])

    clouds = sorted(
        f for f in os.listdir(cloud_dir) if f.endswith(cloud_suffix)
    )
    rng.shuffle(clouds)
    copied = []
    for cloud in clouds:  # walk past unmatched clouds until n pairs
        if len(copied) >= n:
            break
        p = prefix(cloud)
        qsms = sorted(
            f
            for f in os.listdir(qsm_dir)
            if f.startswith(p) and f.endswith(".csv")
        )
        if not qsms:
            logger.warning("no QSM found for %s", cloud)
            continue
        shutil.copy(
            os.path.join(cloud_dir, cloud),
            os.path.join(out_cloud_dir, cloud),
        )
        shutil.copy(
            os.path.join(qsm_dir, qsms[0]),
            os.path.join(out_qsm_dir, qsms[0]),
        )
        copied.append((cloud, qsms[0]))
    return copied
