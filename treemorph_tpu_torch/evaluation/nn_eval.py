"""NN-distance evaluation: does applying predicted offsets shrink the cloud?

Port of ``treemorph_tpu/evaluation/nn_eval.py`` (reference
``Modules/Evaluation/NN_eval.py``): the metric is each point's
1-nearest-neighbour distance before and after applying the predicted
offsets (``nearestNeighbourDistances``, :229-246). Refined clouds collapse
onto cylinder surfaces, so the distribution shifts down. Predictions run
per CV plot on whole trees (:75-122, the port's ``predict_single``, whose
TreeLearn and PTv3 forwards launch the band conv and window-attention
kernels on the card) or through the rasterized scatter-mean path
(:124-225, ``predict_rasterized``); the plots (:297-688) show binned means
with a power-law fit. Distances are host work (scipy's ``cKDTree``, as in
the JAX package); matplotlib is imported only by the figure functions.
"""

from __future__ import annotations

import logging
import os

import numpy as np
from scipy.spatial import cKDTree

from ..data.treeset import TreeDataset
from ..pipeline.predict import predict_rasterized, predict_single
from ..utils.device import resolve_device
from ..utils.fitting import fit_power_law, generate_log_bins

logger = logging.getLogger("treemorph_tpu_torch.eval")


def nearest_neighbour_distances(points: np.ndarray) -> np.ndarray:
    """1-NN distance per point (reference NN_eval.py:229-246)."""
    tree = cKDTree(points)
    dists, _ = tree.query(points, k=2)
    return dists[:, 1]


def _plt():
    from ..plotting.figures import _plt as plt

    return plt()


def plot_of_path(path: str) -> str:
    base = os.path.basename(path)
    return base.split("_")[0]


def nn_eval(
    models: dict,
    dataset: TreeDataset,
    model_type: str = "treelearn",
    rasterized: bool = False,
    max_trees: int | None = None,
    device=None,
):
    """Evaluate NN-distance shrinkage over a dataset.

    ``models``: the per-plot predictor dict of
    :func:`treemorph_tpu_torch.evaluation.model_loaders.load_model`; each
    tree is evaluated with its plot's offset model ("O_P{plot}", else the
    first offset model), mirroring the reference's CV-model routing
    (NN_eval.py:75-122). The forwards run on ``device`` (the CUDA device
    unless named; raises without one), where the models must live.

    Returns a list of records: {path, nn_before, nn_after} with the raw
    distance arrays.
    """
    device = resolve_device(device)
    records = []
    for i in range(len(dataset)):
        if max_trees is not None and i >= max_trees:
            break
        sample = dataset[i]
        plot = plot_of_path(sample.path)
        offset_model = models.get(f"O_P{plot}") or next(
            (models[k] for k in sorted(models) if k.startswith("O")), None
        )
        if offset_model is None:
            logger.warning("no offset model for plot %s", plot)
            continue

        cloud = np.concatenate(
            [
                sample.points,
                sample.offsets,
                np.zeros((len(sample.points), 1), np.float32),
                sample.feats,
            ],
            axis=1,
        )
        if rasterized:
            refined = predict_rasterized(
                cloud, offset_model, None, True, False, device=device
            )
        else:
            refined = predict_single(cloud, offset_model, None, True, False,
                                     device=device)

        records.append(
            {
                "path": sample.path,
                "nn_before": nearest_neighbour_distances(sample.points),
                "nn_after": nearest_neighbour_distances(refined),
            }
        )
    return records


def summarize_nn_records(records) -> dict:
    """Aggregate statistics of an nn_eval run."""
    before = np.concatenate([r["nn_before"] for r in records])
    after = np.concatenate([r["nn_after"] for r in records])
    return {
        "n_points": int(len(before)),
        "mean_before": float(before.mean()),
        "mean_after": float(after.mean()),
        "median_before": float(np.median(before)),
        "median_after": float(np.median(after)),
        "shrinkage": float(1.0 - after.mean() / max(before.mean(), 1e-12)),
    }


def binned_mean_transform(
    nn_before: np.ndarray, nn_after: np.ndarray, n_bins: int = 50
):
    """Mean transformed distance per original-distance bin + power-law fit
    (the data behind the reference's diagnostic plot, NN_eval.py:297-688).

    Returns (bin_centers, bin_means, (a, b) power-law coefficients).
    """
    eps = 1e-8
    before = np.clip(nn_before, eps, None)
    bins = generate_log_bins(before.min(), before.max())
    if len(bins) < 3:
        bins = np.linspace(before.min(), before.max(), n_bins)
    idx = np.clip(np.digitize(before, bins) - 1, 0, len(bins) - 2)
    centers, means = [], []
    for b in range(len(bins) - 1):
        mask = idx == b
        if mask.sum() == 0:
            continue
        centers.append(np.sqrt(bins[b] * bins[b + 1]))
        means.append(nn_after[mask].mean())
    centers = np.asarray(centers)
    means = np.asarray(means)
    try:
        _, _, a, b, _, _ = fit_power_law(centers, means)
    except Exception:
        a, b = np.nan, np.nan
    return centers, means, (a, b)


#: reference per-plot scatter colors (NN_eval.py:404)
PLOT_COLORS = {"3": "red", "4": "green", "6": "blue", "8": "yellow"}


def plot_nn_distances_scaled(
    nnd_orig: np.ndarray,
    nnd_pred: np.ndarray,
    output_path: str,
    title: str = "NND Comparison",
    tree_plots=None,
    color_by_plot: bool = False,
    show_scatter: bool = False,
    show_fit: bool = False,
):
    """The reference's piecewise-scaled NND comparison plot
    (NN_eval.py:297-688): binned means on the custom 0-10 cm / 10-100 cm /
    >1 m axis transform, with optional raw scatter (colored per CV plot),
    a power-law fit over the 1 cm-1 m range, the y=x diagonal, and 10 cm
    separator guides."""
    plt = _plt()
    from ..plotting.qsm_comparison import (
        COMPARISON_BINS, _binned_mean_std, custom_label, custom_scale,
    )

    nnd_orig = np.asarray(nnd_orig, float)
    nnd_pred = np.asarray(nnd_pred, float)

    centers, means, stds = _binned_mean_std(
        nnd_orig, nnd_pred, COMPARISON_BINS
    )
    x_t = custom_scale(centers)
    y_t = custom_scale(means)
    # first bin (0-1 cm) and the inf bin plot at their visual midpoints
    # (NN_eval.py:369-373 / :515-528)
    x_t[0] = custom_scale([0.005])[0]
    x_t[-1] = custom_scale([1.05])[0]
    lo = custom_scale(np.clip(means - stds, 1e-6, None))
    hi = custom_scale(np.clip(means + stds, 1e-6, None))
    yerr = [np.maximum(y_t - lo, 0), np.maximum(hi - y_t, 0)]

    fig, ax = plt.subplots(figsize=(8, 8))
    if show_scatter:
        if tree_plots is not None and color_by_plot:
            for p in sorted(set(tree_plots)):
                sel = np.asarray(
                    [tp == p for tp in tree_plots], bool
                )
                ax.scatter(
                    custom_scale(nnd_orig[sel]),
                    custom_scale(nnd_pred[sel]),
                    color=PLOT_COLORS.get(str(p), "gray"),
                    label=f"Plot {p}", alpha=0.1, s=5,
                )
        else:
            ax.scatter(
                custom_scale(nnd_orig), custom_scale(nnd_pred),
                alpha=0.1, s=5, color="gray", label="Data",
            )

    ok = ~np.isnan(y_t)
    ax.errorbar(
        x_t[ok], y_t[ok], yerr=[yerr[0][ok], yerr[1][ok]], fmt="o",
        color="red", label="Binned Mean",
    )
    diag = np.linspace(0.0, 1.1, 100)
    ax.plot(custom_scale(diag), custom_scale(diag), "k--", label="y = x")

    if show_fit:
        fit_mask = (
            (nnd_orig >= 0.01)
            & (nnd_orig <= 1.0)
            & np.isfinite(nnd_orig)
            & np.isfinite(nnd_pred)
        )
        try:
            x_fit, _, a, b, a_err, b_err = fit_power_law(
                nnd_orig[fit_mask], nnd_pred[fit_mask]
            )
            ax.plot(
                custom_scale(x_fit), custom_scale(a * x_fit**b), "blue",
                label=(
                    r"$y = ax^b$"
                    + f"\n$a = {a:.3f} \\pm {a_err:.3f}$"
                    + f"\n$b = {b:.3f} \\pm {b_err:.3f}$"
                ),
            )
        except Exception:
            logger.warning("power-law fit failed; omitting overlay")

    tick_vals = (
        [0.0, 0.01]
        + [i / 100 for i in range(2, 10)]
        + [i / 100 for i in range(10, 100, 10)]
        + [1.0, 1.1]
    )
    pos = custom_scale(np.array(tick_vals))
    labels = [
        "0cm" if v < 0.01
        else ("1m" if v == 1.0 else (">1m" if v > 1.0 else
                                     custom_label(v) + "cm"))
        for v in tick_vals
    ]
    ax.set_xticks(pos)
    ax.set_xticklabels(labels, rotation=45)
    ax.set_yticks(pos)
    ax.set_yticklabels(labels)
    sep = custom_scale(np.array([0.1]))[0]
    ax.axhline(sep, color="gray", linewidth=1.0)
    ax.axvline(sep, color="gray", linewidth=1.0)
    ax.grid(True, linestyle="--", linewidth=0.5)
    ax.set_xlabel("Original NN Distance")
    ax.set_ylabel("Transformed NN Distance")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def plot_nn_distances_subplots(
    nnd_orig: np.ndarray,
    nnd_pred: np.ndarray,
    tree_plots,
    output_path: str,
):
    """2x2 per-CV-plot grid of the piecewise-scaled NND comparison
    (NN_eval.py:691-...): each panel shows one plot's binned means."""
    plt = _plt()
    from ..plotting.qsm_comparison import (
        COMPARISON_BINS, _binned_mean_std, custom_label, custom_scale,
    )

    nnd_orig = np.asarray(nnd_orig, float)
    nnd_pred = np.asarray(nnd_pred, float)
    plots = sorted(set(tree_plots))
    n = len(plots)
    rows = cols = int(np.ceil(np.sqrt(max(n, 1))))
    fig, axes = plt.subplots(
        rows, cols, figsize=(5 * cols, 5 * rows), squeeze=False
    )
    tick_vals = [0.0, 0.05, 0.1, 0.5, 1.0]
    pos = custom_scale(np.array(tick_vals))
    labels = [custom_label(v) for v in tick_vals]
    for i, p in enumerate(plots):
        ax = axes[i // cols][i % cols]
        sel = np.asarray([tp == p for tp in tree_plots], bool)
        centers, means, stds = _binned_mean_std(
            nnd_orig[sel], nnd_pred[sel], COMPARISON_BINS
        )
        x_t, y_t = custom_scale(centers), custom_scale(means)
        ok = ~np.isnan(y_t)
        # error bars transform as scale(mean±std)-scale(mean): the std is
        # an interval, not a coordinate on the piecewise axis
        lo = custom_scale(np.clip(means - stds, 1e-6, None))
        hi = custom_scale(np.clip(means + stds, 1e-6, None))
        yerr = [
            np.maximum(y_t - lo, 0)[ok],
            np.maximum(hi - y_t, 0)[ok],
        ]
        ax.errorbar(
            x_t[ok], y_t[ok], yerr=yerr, fmt="o",
            color=PLOT_COLORS.get(str(p), "red"), capsize=3,
        )
        diag = np.linspace(0.0, 1.1, 50)
        ax.plot(custom_scale(diag), custom_scale(diag), "k--")
        ax.set_xticks(pos)
        ax.set_xticklabels(labels)
        ax.set_yticks(pos)
        ax.set_yticklabels(labels)
        ax.set_title(f"Plot {p}")
        ax.grid(True, linestyle="--", linewidth=0.5)
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def plot_nn_distances(records, output_path: str, title: str = "NN eval"):
    """Binned-mean diagnostic plot with power-law fit (matplotlib)."""
    plt = _plt()
    before = np.concatenate([r["nn_before"] for r in records])
    after = np.concatenate([r["nn_after"] for r in records])
    centers, means, (a, b) = binned_mean_transform(before, after)

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.scatter(centers, means, s=18, label="binned mean after offsets")
    if np.isfinite(a):
        xs = np.logspace(
            np.log10(max(centers.min(), 1e-5)), np.log10(centers.max()), 100
        )
        ax.plot(xs, a * xs**b, "r--", label=f"fit a={a:.3g}, b={b:.3g}")
    ax.plot(centers, centers, "k:", alpha=0.5, label="identity")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("1-NN distance before (m)")
    ax.set_ylabel("1-NN distance after (m)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path
