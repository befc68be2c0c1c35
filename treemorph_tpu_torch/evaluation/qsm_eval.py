"""QSM-projection evaluation: distance of clouds to fitted QSMs.

Port of ``treemorph_tpu/evaluation/qsm_eval.py``, the reference eval
scripts ``ModelTestingScripts/project_preds_on_qsm.py`` (project refined
clouds onto fitted QSM cylinders, :26-75) and
``ModelTestingScripts/Evaluate_preds_on_qsm.py`` (compare the
|offset-to-QSM| distance distributions of original and refined clouds
with log-binned proportions and a power-law fit, :54-151). QSM tables are
:class:`~treemorph_tpu_torch.utils.table.Table` objects, where the JAX
package takes data frames; the projection runs on the device through
:func:`treemorph_tpu_torch.ops.projection.closest_cylinder`.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..ops.projection import closest_cylinder, cylinders_from_table
from ..utils.device import resolve_device
from ..utils.fitting import fit_circle_2d, fit_power_law, generate_log_bins
from ..utils.table import Table

logger = logging.getLogger("treemorph_tpu_torch.eval")


def _numeric(column) -> np.ndarray:
    """A column as float64, with NaN for entries that are not numbers (the
    JAX package's ``to_numeric(errors="coerce")``)."""
    out = np.empty(len(column), np.float64)
    for i, v in enumerate(column):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            out[i] = np.nan
    return out


def point_cloud_stem_base_center(
    cloud_xyz: np.ndarray,
    slice_height: float = 0.10,
    num_ransac_fits: int = 5,
    subset_ratio: float = 0.7,
    rng: np.random.Generator | None = None,
) -> np.ndarray | None:
    """RANSAC-averaged circle-fit center of the cloud's base slice
    (reference Modules/Projection.py:165-211)."""
    rng = rng or np.random.default_rng(0)
    if len(cloud_xyz) < 10:
        return None
    min_z = cloud_xyz[:, 2].min()
    base = cloud_xyz[
        (cloud_xyz[:, 2] >= min_z) & (cloud_xyz[:, 2] < min_z + slice_height)
    ]
    if len(base) < 10:
        base = cloud_xyz[cloud_xyz[:, 2] < min_z + 0.5]
        if len(base) < 10:
            centroid = cloud_xyz[:, :2].mean(axis=0)
            return np.array([centroid[0], centroid[1], min_z])

    pts2d = base[:, :2]
    subset = min(max(3, int(len(pts2d) * subset_ratio)), len(pts2d))
    centers = []
    for _ in range(num_ransac_fits if len(pts2d) >= 3 else 1):
        idx = rng.choice(len(pts2d), subset, replace=False)
        c, _ = fit_circle_2d(pts2d[idx])
        if np.isfinite(c).all():
            centers.append(c)
    if centers:
        center_xy = np.mean(centers, axis=0)
    else:
        center_xy, _ = fit_circle_2d(pts2d)
        if not np.isfinite(center_xy).all():
            center_xy = pts2d.mean(axis=0)
    return np.array([center_xy[0], center_xy[1], min_z])


def qsm_stem_base_center(qsm) -> np.ndarray | None:
    """Start point of the QSM's lowest main-stem cylinder (reference
    Modules/Projection.py:213-258); prefers BranchOrder == 0."""
    needed = ["startX", "startY", "startZ"]
    if not all(c in qsm.columns for c in needed) or len(qsm) == 0:
        return None
    xyz = np.stack([_numeric(qsm[c]) for c in needed], axis=1)
    rows = ~np.isnan(xyz).any(axis=1)
    if not rows.any():
        return None
    candidates = rows
    if "BranchOrder" in qsm.columns:
        stem = rows & (np.asarray(qsm["BranchOrder"]) == 0)
        if stem.any():
            candidates = stem
    idx = np.nonzero(candidates)[0]
    return xyz[idx[np.argmin(xyz[idx, 2])]]


def align_qsm_to_cloud(qsm, cloud_xyz: np.ndarray):
    """Translate the QSM so its stem base matches the cloud's
    (reference Modules/Projection.py:382-412). Returns a new table."""
    pc_ref = point_cloud_stem_base_center(cloud_xyz)
    qsm_ref = qsm_stem_base_center(qsm)
    if pc_ref is None or qsm_ref is None:
        logger.warning("alignment references unavailable; skipping")
        return qsm
    shift = qsm_ref - pc_ref
    cols = {name: qsm[name] for name in qsm.columns}
    for i, axis in enumerate(["X", "Y", "Z"]):
        for end in ("start", "end"):
            cols[f"{end}{axis}"] = np.asarray(cols[f"{end}{axis}"]) - shift[i]
    return Table(cols)


def project_clouds(
    cloud_list: list[str],
    cylinder_list: list[str],
    label_dir: str,
    denoised: bool = False,
    align: bool = False,
    device=None,
) -> list[str]:
    """Project refined clouds onto fitted QSMs and save the labeled result
    (reference Modules/Projection.py:264-444): clouds are matched to the
    QSM csv whose basename extends theirs with the shortest suffix; output
    is ``*_labeled_pred[_denoised]_projected.npy`` in the (N, 11) layout
    with ones features. The projection runs on ``device`` (the CUDA device
    unless named; raises without one)."""
    from ..ops.projection import generate_offset_cloud
    from ..utils.io import load_cloud

    device = resolve_device(device)
    suffix = (
        "_labeled_pred_denoised_projected.npy"
        if denoised
        else "_labeled_pred_projected.npy"
    )
    qsm_names = [
        (os.path.splitext(os.path.basename(p))[0], p) for p in cylinder_list
    ]
    os.makedirs(label_dir, exist_ok=True)
    written = []
    for cloud_path in cloud_list:
        base = os.path.splitext(os.path.basename(cloud_path))[0]
        matches = [
            (len(name) - len(base), path)
            for name, path in qsm_names
            if name.startswith(base)
        ]
        if not matches:
            logger.warning("no QSM match for %s", base)
            continue
        qsm_path = min(matches)[1]
        cloud = load_cloud(cloud_path)
        if cloud is None or len(cloud) == 0:
            continue
        qsm = Table.read_csv(qsm_path)
        if align:
            qsm = align_qsm_to_cloud(qsm, cloud[:, :3])
        labeled = generate_offset_cloud(cloud, qsm, device=device)
        labeled = np.concatenate(
            [labeled, np.ones((len(labeled), 4), np.float32)], axis=1
        )
        out_path = os.path.join(label_dir, base + suffix)
        np.save(out_path, labeled)
        written.append(out_path)
    return written


def project_on_qsm(cloud: np.ndarray, qsm, device=None) -> np.ndarray:
    """Distance of every point to the nearest QSM cylinder surface,
    computed on ``device`` (the CUDA device unless named; raises without
    one)."""
    device = resolve_device(device)
    cyl = cylinders_from_table(qsm, device=device)
    pts = np.ascontiguousarray(np.asarray(cloud, np.float32)[:, :3])
    _, dists, _ = closest_cylinder(torch.from_numpy(pts).to(device), cyl)
    return dists.cpu().numpy()


def compare_distance_distributions(
    dists_orig: np.ndarray, dists_pred: np.ndarray
) -> dict:
    """Summary stats of original vs refined QSM distances
    (Evaluate_preds_on_qsm.py semantics)."""
    return {
        "mean_orig": float(np.mean(dists_orig)),
        "mean_pred": float(np.mean(dists_pred)),
        "median_orig": float(np.median(dists_orig)),
        "median_pred": float(np.median(dists_pred)),
        "q95_orig": float(np.quantile(dists_orig, 0.95)),
        "q95_pred": float(np.quantile(dists_pred, 0.95)),
        "improvement": float(
            1.0 - np.mean(dists_pred) / max(np.mean(dists_orig), 1e-12)
        ),
    }


def log_binned_proportions(dists: np.ndarray, eps: float = 1e-8):
    """Histogram proportions over 1-2-...-9 log-decade bins + power fit."""
    d = np.clip(dists, eps, None)
    bins = generate_log_bins(d.min(), d.max())
    counts, edges = np.histogram(d, bins=bins)
    proportions = counts / max(counts.sum(), 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    keep = proportions > 0
    try:
        _, _, a, b, _, _ = fit_power_law(centers[keep], proportions[keep])
    except Exception:
        a, b = np.nan, np.nan
    return centers, proportions, (a, b)


def plot_qsm_distance_comparison(
    dists_orig, dists_pred, output_path: str, title: str = "QSM distances"
):
    from ..plotting.figures import _plt

    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    for dists, label, color in (
        (dists_orig, "original", "tab:gray"),
        (dists_pred, "refined", "tab:green"),
    ):
        centers, props, (a, b) = log_binned_proportions(dists)
        ax.plot(centers, props, "o-", color=color, ms=4, label=label)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("distance to QSM surface (m)")
    ax.set_ylabel("proportion of points")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path
