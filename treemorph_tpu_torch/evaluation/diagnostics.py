"""Single-tree visual diagnostics.

Port of ``treemorph_tpu/evaluation/diagnostics.py``, the reference's
``Modules/Testing.py`` (:20-107 ``testModel``,
:124-146 ``nearestNeighbourDistances``, :175-216 ``makeNoisePrediction``,
:262-354 ``plot_log_nn_distances_with_histograms``, :355-483 ``slice``,
:484-572 ``slice_noise``): run a model on one labeled tree and produce

- log-log 1-NN / 5-NN distance comparisons with a power-law fit and a
  dodged original-vs-transformed histogram pair,
- per-slice 2x2 quiver/scatter figures (GT offsets, predicted offsets,
  original points, transformed points) with GT-magnitude noise coloring,
- per-slice 2x2 noise-mask figures (noise highlighted / removed, before
  and after applying the predicted offsets).

Golden-image review by eye, industrialized as artifact files. All
plotting is host-side numpy/matplotlib (imported only by the figure
functions); model forwards go through :class:`Predictor` on the device,
where TreeLearn's launch the band conv kernel, so these diagnostics impose
no constraints on the compute path.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree

from ..evaluation.model_loaders import Predictor
from ..evaluation.nn_eval import nearest_neighbour_distances
from ..pipeline.predict import predict_single
from ..plotting.figures import _plt, plot_offset_slices
from ..utils.device import resolve_device
from ..utils.fitting import fit_power_law


def nearest_neighbour_distances_k(points: np.ndarray, k: int):
    """Mean distance to the k nearest neighbors, per point and overall
    (reference Testing.py:124-146)."""
    tree = cKDTree(points)
    distances, _ = tree.query(points, k=k + 1, workers=-1)
    per_point = distances[:, 1:].mean(axis=1)
    return float(per_point.mean()), per_point


def make_noise_prediction(
    noise_predictor: Predictor,
    cloud: np.ndarray,
    pred_offsets: np.ndarray,
    threshold: float = 0.5,
    device=None,
):
    """Noise masks before/after applying predicted offsets (reference
    Testing.py:175-216): sigmoid of the last semantic logit > threshold.

    Two forwards of the noise model through :meth:`Predictor.predict_flat`
    — one on the original coordinates, one on the offset-translated cloud
    — exactly the reference's ``batch_orig`` / ``batch_trans`` pair, on
    ``device`` (the CUDA device unless named; raises without one), where
    the model must live.
    """
    from scipy.special import expit

    from ..pipeline.predict import _pad_flat

    device = resolve_device(device)
    pts = np.asarray(cloud, np.float32)[:, :3]
    feats = (
        np.asarray(cloud, np.float32)[:, 7:11]
        if cloud.shape[1] >= 11
        else np.zeros((len(pts), 4), np.float32)
    )

    def run(points_in):
        coords, f, batch_ids, valid, n = _pad_flat(
            points_in.astype(np.float32), feats, device=device
        )
        res = noise_predictor.predict_flat(coords, f, batch_ids, valid)
        logits = res["semantic_prediction_logits"][:n].float().cpu().numpy()
        return expit(logits[:, -1]) > threshold

    return run(pts), run(pts + pred_offsets)


def plot_loglog_nn_comparison(
    nn_orig: np.ndarray,
    nn_trans: np.ndarray,
    mean_orig: float,
    mean_trans: float,
    k: int,
    save_path: str,
    max_distance: float = 0.2,
    bins: int = 20,
) -> str:
    """Log-log NN scatter + power-law fit, and a dodged density
    histogram of original vs transformed distances (reference
    Testing.py:262-354; the seaborn dodge is reproduced with two offset
    matplotlib bar sets)."""
    plt = _plt()
    x_fit, y_fit, a, b, a_err, b_err = fit_power_law(nn_orig, nn_trans)

    fig, axs = plt.subplots(1, 2, figsize=(14, 6))
    axs[0].loglog(
        nn_orig, nn_trans, "bo", alpha=0.1, markersize=2, label="Data"
    )
    lo = min(nn_orig.min(), nn_trans.min())
    hi = max(nn_orig.max(), nn_trans.max())
    axs[0].plot([lo, hi], [lo, hi], "k--", label="y = x")
    axs[0].loglog(
        x_fit, y_fit, "r-", linewidth=2,
        label=(
            r"$y = ax^b$"
            + f"\n$a = {a:.3f} \\pm {a_err:.3f}$"
            + f"\n$b = {b:.3f} \\pm {b_err:.3f}$"
        ),
    )
    axs[0].set_xlabel("Original Nearest Neighbor Distance [m]")
    axs[0].set_ylabel("Transformed Nearest Neighbor Distance [m]")
    axs[0].set_title("Log-Log NN Distance Comparison")
    axs[0].legend()
    axs[0].grid(True, which="both", linestyle="--", linewidth=0.5)

    d_orig = nn_orig[nn_orig <= max_distance]
    d_trans = nn_trans[nn_trans <= max_distance]
    edges = np.linspace(0, max_distance, bins + 1)
    h_orig, _ = np.histogram(d_orig, bins=edges, density=True)
    h_trans, _ = np.histogram(d_trans, bins=edges, density=True)
    width = (edges[1] - edges[0]) * 0.45
    centers = (edges[:-1] + edges[1:]) / 2
    axs[1].bar(
        centers - width / 2, h_orig, width=width * 0.9, color="blue",
        edgecolor="black", label="Original",
    )
    axs[1].bar(
        centers + width / 2, h_trans, width=width * 0.9, color="red",
        edgecolor="black", label="Transformed",
    )
    axs[1].set_xlabel("Nearest Neighbor Distance (m)")
    axs[1].set_ylabel("Density")
    axs[1].set_title("Histogram of NN Distances (Original vs Transformed)")
    axs[1].grid(True)
    axs[1].legend()

    fig.suptitle(
        f"{k} Nearest Neighbor Distance Analysis\n"
        f"Mean {k}-NN Distance (Original): {mean_orig:.4f} | "
        f"Mean {k}-NN Distance (Transformed): {mean_trans:.4f}",
        fontsize=14,
    )
    fig.tight_layout()
    fig.savefig(save_path, dpi=130)
    plt.close(fig)
    return save_path


def _slice_mask(points: np.ndarray, slice_bounds) -> np.ndarray:
    x_min, x_max, y_min, y_max, z_min, z_max = slice_bounds
    return (
        (points[:, 0] >= x_min) & (points[:, 0] <= x_max)
        & (points[:, 1] >= y_min) & (points[:, 1] <= y_max)
        & (points[:, 2] >= z_min) & (points[:, 2] <= z_max)
    )


def _rotate_45(points_slice, offset_slice, labels_slice, slice_bounds):
    """In-plane 45-degree rotation for the 'y' view (reference
    Testing.py:399-420)."""
    x_min, x_max, y_min, y_max, _, _ = slice_bounds
    center = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2])
    theta = np.radians(45)
    rot = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    points_slice = points_slice.copy()
    offset_slice = offset_slice.copy()
    points_slice[:, :2] = (points_slice[:, :2] - center) @ rot.T + center
    offset_slice[:, :2] = offset_slice[:, :2] @ rot.T
    if labels_slice is not None:
        labels_slice = labels_slice.copy()
        labels_slice[:, :2] = labels_slice[:, :2] @ rot.T
    return points_slice, offset_slice, labels_slice


def _proj(points, view_from):
    if view_from == "z":
        return points[:, 0], points[:, 1], ("X [m]", "Y [m]")
    return points[:, 0], points[:, 2], ("X [m]", "Z [m]")


def plot_slice_quadrant(
    points: np.ndarray,
    labels: np.ndarray,
    offset_predictions: np.ndarray,
    noise_threshold: float,
    slice_bounds,
    nn_distances_orig: np.ndarray,
    nn_distances_trans: np.ndarray,
    view_from: str = "z",
    save_path: str = "slice.png",
    name: str = "tree",
) -> str:
    """2x2 figure: GT offset quiver, predicted offset quiver, original
    scatter, transformed scatter — noise colored red by GT offset
    magnitude (reference Testing.py:355-483)."""
    from matplotlib.patches import Patch

    plt = _plt()
    mask = _slice_mask(points, slice_bounds)
    p = points[mask].copy()
    off = offset_predictions[mask].copy()
    lab = labels[mask].copy()
    colors = np.where(
        np.linalg.norm(lab, axis=1) > noise_threshold, "red", "blue"
    )
    if view_from == "y":
        p, off, lab = _rotate_45(p, off, lab, slice_bounds)
    trans = p + off

    fig, axs = plt.subplots(
        2, 2, figsize=(12, 12), sharex=True, sharey=True
    )
    x, y, (xl, yl) = _proj(p, view_from)
    xt, yt, _ = _proj(trans, view_from)
    fig.suptitle(
        f"Sample: {name} | {view_from}-range: "
        f"{slice_bounds[4]:.2f}-{slice_bounds[5]:.2f}\n"
        f"Mean NN Distance (Original): "
        f"{float(np.mean(nn_distances_orig)):.4f} | "
        f"Mean NN Distance (Transformed): "
        f"{float(np.mean(nn_distances_trans)):.4f}",
        fontsize=14,
    )
    axs[0, 0].quiver(
        x, y, lab[:, 0], lab[:, 1], color=colors, angles="xy",
        scale_units="xy", scale=1, width=0.005,
    )
    axs[0, 0].set_title("Offset Vectors from Data")
    axs[0, 1].quiver(
        x, y, off[:, 0], off[:, 1], color=colors, angles="xy",
        scale_units="xy", scale=1, width=0.005,
    )
    axs[0, 1].set_title("Offset Predictions")
    axs[1, 0].scatter(x, y, c=colors, s=5)
    axs[1, 0].set_title("Original Points")
    axs[1, 1].scatter(xt, yt, c=colors, s=5)
    axs[1, 1].set_title("Transformed Points (Points + Offset Predictions)")
    axs[0, 1].legend(
        handles=[
            Patch(facecolor="blue", edgecolor="black", label="Non-Noise"),
            Patch(facecolor="red", edgecolor="black", label="Noise"),
        ],
        loc="upper right", fontsize=12,
    )
    for ax in axs.flatten():
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(save_path, dpi=130)
    plt.close(fig)
    return save_path


def plot_noise_mask_slice(
    points: np.ndarray,
    offset_predictions: np.ndarray,
    noise_mask_orig: np.ndarray,
    noise_mask_trans: np.ndarray,
    slice_bounds,
    view_from: str = "z",
    save_path: str = "slice_noise.png",
) -> str:
    """2x2 figure: original/transformed with noise highlighted, then
    both with noise removed (reference Testing.py:484-572)."""
    from matplotlib.patches import Patch

    plt = _plt()
    mask = _slice_mask(points, slice_bounds)
    p = points[mask]
    off = offset_predictions[mask]
    m_orig = noise_mask_orig[mask]
    m_trans = noise_mask_trans[mask]
    trans = p + off

    fig, axs = plt.subplots(
        2, 2, figsize=(12, 12), sharex=True, sharey=True
    )
    x, y, (xl, yl) = _proj(p, view_from)
    xt, yt, _ = _proj(trans, view_from)
    xf, yf, _ = _proj(p[~m_orig], view_from)
    xft, yft, _ = _proj(trans[~m_trans], view_from)
    axs[0, 0].scatter(x, y, c=np.where(m_orig, "red", "blue"), s=5)
    axs[0, 0].set_title("Original Points (Noise in Red)")
    axs[0, 1].scatter(xt, yt, c=np.where(m_trans, "red", "blue"), s=5)
    axs[0, 1].set_title("Transformed Points (Noise in Red)")
    axs[1, 0].scatter(xf, yf, c="blue", s=5)
    axs[1, 0].set_title("Filtered Original Points (Noise Removed)")
    axs[1, 1].scatter(xft, yft, c="blue", s=5)
    axs[1, 1].set_title("Filtered Transformed Points (Noise Removed)")
    axs[0, 0].legend(
        handles=[
            Patch(facecolor="blue", edgecolor="black", label="Non-Noise"),
            Patch(facecolor="red", edgecolor="black", label="Noise"),
        ],
        loc="upper right", fontsize=12,
    )
    for ax in axs.flatten():
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(save_path, dpi=130)
    plt.close(fig)
    return save_path


def default_slice_bounds(points: np.ndarray, n_slices: int = 5):
    """Slice bounds spanning the tree's height.

    The reference hardcodes five plot-specific bounds for its sample
    42_3 (Testing.py:51-58); for arbitrary clouds we span the z-extent
    with ``n_slices`` thin horizontal slabs over the full xy bounding
    box, the last viewed from 'y' like the reference's fifth slice.
    """
    p = np.asarray(points)
    x0, y0, z0 = p.min(axis=0)
    x1, y1, z1 = p.max(axis=0)
    zs = np.linspace(z0, z1, n_slices + 1)
    bounds = [
        [x0, x1, y0, y1, zs[i], zs[i] + min(0.5, zs[i + 1] - zs[i])]
        for i in range(n_slices)
    ]
    views = ["z"] * (n_slices - 1) + ["y"]
    return bounds, views


def model_diagnostics(
    predictor: Predictor,
    labeled_cloud: np.ndarray,
    noise_predictor: Predictor | None = None,
    device=None,
) -> dict:
    """The device work and the numbers of :func:`test_model`, without its
    figures: the refined cloud and predicted offsets of one
    ``predict_single`` forward, the noise masks of
    :func:`make_noise_prediction` (two forwards of ``noise_predictor``,
    or None), the 1-NN and 5-NN distances before and after, and the
    metrics ``nn_before_mean``, ``nn_after_mean``, ``nn_gt_mean`` and
    ``offset_mae``. The forwards run on ``device`` (the CUDA device unless
    named; raises without one), where the predictors must live."""
    device = resolve_device(device)
    points = labeled_cloud[:, :3].astype(np.float32)
    gt_offsets = labeled_cloud[:, 3:6].astype(np.float32)
    refined = predict_single(
        labeled_cloud, predictor, None, predict_offset=True, denoise=False,
        device=device,
    )
    pred_offsets = refined - points
    noise_masks = None
    if noise_predictor is not None:
        noise_masks = make_noise_prediction(
            noise_predictor, labeled_cloud, pred_offsets, device=device
        )
    knn = {k: (nearest_neighbour_distances_k(points, k),
               nearest_neighbour_distances_k(refined, k)) for k in (1, 5)}
    nn_gt = nearest_neighbour_distances(points + gt_offsets)
    return {
        "points": points,
        "gt_offsets": gt_offsets,
        "refined": refined,
        "pred_offsets": pred_offsets,
        "noise_masks": noise_masks,
        "knn": knn,
        "nn_before_mean": knn[1][0][0],
        "nn_after_mean": knn[1][1][0],
        "nn_gt_mean": float(nn_gt.mean()),
        "offset_mae": float(np.abs(pred_offsets - gt_offsets).mean()),
    }


#: the metrics :func:`test_model` returns beside its figures' paths
METRICS = ("nn_before_mean", "nn_after_mean", "nn_gt_mean", "offset_mae")


def test_model(
    predictor: Predictor,
    labeled_cloud: np.ndarray,
    output_dir: str,
    name: str = "tree",
    slices=((0.0, 0.5), (2.0, 2.5), (4.0, 4.5), (6.0, 6.5), (7.5, 8.0)),
    noise_predictor: Predictor | None = None,
    noise_threshold: float = 0.1,
    device=None,
) -> dict:
    """Diagnose one labeled (N, 11) cloud; writes plots, returns metrics.

    The full reference ``testModel`` artifact set (Testing.py:20-107):
    knn_1/knn_5 log-log+histogram figures, five slice_{i} quadrant
    figures, and — when ``noise_predictor`` is given (the reference's
    ``test_noise=True``) — five slice_{i}_N noise-mask figures. The
    forwards (:func:`model_diagnostics`) run on ``device`` (the CUDA device
    unless named; raises without one), where the predictors must live.
    """
    diag = model_diagnostics(predictor, labeled_cloud, noise_predictor,
                             device)
    os.makedirs(output_dir, exist_ok=True)
    points, gt_offsets = diag["points"], diag["gt_offsets"]
    refined, pred_offsets = diag["refined"], diag["pred_offsets"]
    noise_masks = diag["noise_masks"]

    slice_path = os.path.join(output_dir, f"{name}_offset_slices.png")
    plot_offset_slices(points, gt_offsets, pred_offsets, slice_path,
                       slices=slices)
    knn_plots = [
        plot_loglog_nn_comparison(
            orig[1], trans[1], orig[0], trans[0], k,
            os.path.join(output_dir, f"{name}_knn_{k}.png"),
        )
        for k, (orig, trans) in diag["knn"].items()
    ]

    bounds, views = default_slice_bounds(points)
    slice_plots, noise_plots = [], []
    for i, (bound, view) in enumerate(zip(bounds, views)):
        mask = _slice_mask(points, bound)
        if mask.sum() < 3:
            continue
        nn_o = nearest_neighbour_distances(points[mask])
        nn_t = nearest_neighbour_distances(refined[mask])
        slice_plots.append(plot_slice_quadrant(
            points, gt_offsets, pred_offsets, noise_threshold, bound,
            nn_o, nn_t, view,
            os.path.join(output_dir, f"{name}_slice_{i}.png"), name,
        ))
        if noise_masks is not None:
            noise_plots.append(plot_noise_mask_slice(
                points, pred_offsets, noise_masks[0], noise_masks[1],
                bound, view,
                os.path.join(output_dir, f"{name}_slice_{i}_N.png"),
            ))

    return {
        "slice_plot": slice_path,
        "hist_plot": knn_plots[0],
        "knn_plots": knn_plots,
        "slice_plots": slice_plots,
        "noise_plots": noise_plots,
        **{k: diag[k] for k in METRICS},
    }
