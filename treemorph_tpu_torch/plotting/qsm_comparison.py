"""QSM-comparison figure suite (the ``qsm_comp_new*`` long tail of C24).

Port of ``treemorph_tpu/plotting/qsm_comparison.py``, the reference
scripts:

- :func:`offset_norms_from_file` / :func:`load_pointwise_distance_pairs` —
  paired offset-norm loading for projected clouds
  (``Plotting/qsm_comp_new.py:10-88``);
- :func:`custom_scale` / :func:`custom_label` — the piecewise cm-axis
  transform (0-10 cm stretched, 10-100 cm compressed, +inf bin)
  (``qsm_comp_new.py:157-186``);
- :func:`plot_qsm_comparison` — the 3-panel distribution figure: binned
  original-vs-new distance scatter on the piecewise scale, plus per-model
  mean-distance and improvement bars (``qsm_comp_new.py:195-372``);
- :func:`per_tree_mean_distances` / :func:`plot_per_tree_mean_distances` —
  the per-tree dot-pair comparison capped at 15 cm
  (``qsm_comp_new_testset_proportion.py:26-232``);
- :func:`plot_qsm_comparison_slices` — cylinders-over-cloud slice overlay,
  original vs pipeline QSM (``qsm_comp_new_visual.py:7-156``);
- :func:`plot_transformation_slices` — original/transformed slice grid with
  'z' (XY) and 'y' (45deg-rotated XZ) views
  (``Plotting/slice_plotting.py:120-328``).

All figures render headless (Agg); the numeric helpers need no
matplotlib. QSM tables are :class:`~treemorph_tpu_torch.utils.table.Table`
objects (or any mapping with ``columns``).
"""

from __future__ import annotations

import os

import numpy as np

from .figures import _plt

#: bins of the original-vs-new distance scatter (qsm_comp_new.py:224)
COMPARISON_BINS = (
    [0.0]
    + list(np.linspace(0.01, 0.09, 9))
    + list(np.linspace(0.1, 1.0, 10))
    + [np.inf]
)


def offset_norms_from_file(path: str) -> np.ndarray | None:
    """NaN-filtered norms of the offset columns 3:6 of a projected cloud
    (.npy, (N, >=6)); None when missing/malformed
    (qsm_comp_new.py:10-26)."""
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path)
    except Exception:
        return None
    if data.ndim != 2 or data.shape[1] < 6:
        return None
    norms = np.linalg.norm(data[:, 3:6], axis=1)
    return norms[~np.isnan(norms)]


def load_pointwise_distance_pairs(
    orig_dir: str,
    model_dir: str,
    suffix: str = "_projected.npy",
    orig_suffix: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate paired per-point distances between two directories;
    pairs with length mismatches are skipped.

    Default (testset mode, qsm_comp_new.py:29-88): files pair by
    identical names. With ``orig_suffix`` (trainset/old-dataset mode,
    qsm_comp_new.py:91-152): a model file pairs with
    ``{first_two_name_tokens}{orig_suffix}`` in ``orig_dir``.
    """
    dist_orig, dist_model = [], []
    if not (os.path.isdir(orig_dir) and os.path.isdir(model_dir)):
        return np.array([]), np.array([])
    for name in sorted(os.listdir(model_dir)):
        if not name.endswith(suffix):
            continue
        if orig_suffix is None:
            orig_name = name
        else:
            parts = name.split("_")
            if len(parts) < 2:
                continue
            orig_name = f"{parts[0]}_{parts[1]}{orig_suffix}"
        d_o = offset_norms_from_file(os.path.join(orig_dir, orig_name))
        d_m = offset_norms_from_file(os.path.join(model_dir, name))
        if d_o is None or d_m is None or len(d_o) != len(d_m):
            continue
        if len(d_o):
            dist_orig.extend(d_o)
            dist_model.extend(d_m)
    return np.array(dist_orig), np.array(dist_model)


def mean_distance_and_error(d: np.ndarray):
    """(mean, standard error, std); NaNs for empty input
    (qsm_comp_new.py:375-378)."""
    if d is None or len(d) == 0:
        return np.nan, np.nan, np.nan
    return (
        float(np.mean(d)),
        float(np.std(d) / np.sqrt(len(d))),
        float(np.std(d)),
    )


def custom_scale(val) -> np.ndarray:
    """Piecewise axis transform: [0, 0.1) m -> [0, 10), [0.1, 1] m ->
    [10, 20], (1, 1.1] -> (20, 21], beyond/inf -> 21
    (qsm_comp_new.py:157-173)."""
    val = np.asarray(val, dtype=float)
    scaled = np.zeros_like(val)
    if val.size == 0:
        return scaled
    pos_inf = np.isposinf(val)
    scaled[pos_inf] = 21.0
    v = val[~pos_inf]
    s = np.zeros_like(v)
    m1 = v < 0.1
    s[m1] = v[m1] / 0.1 * 10
    m2 = (v >= 0.1) & (v <= 1.0)
    s[m2] = (v[m2] - 0.1) / 0.9 * 10 + 10
    m3 = (v > 1.0) & (v <= 1.1)
    s[m3] = (v[m3] - 1.0) / 0.1 + 20
    s[v > 1.1] = 21.0
    scaled[~pos_inf] = s
    return scaled


def custom_label(val) -> str:
    """Tick label in cm for a distance in m (qsm_comp_new.py:175-186)."""
    if np.isposinf(val):
        return r"$\infty$"
    if val < 0.01:
        return "0"
    return f"{val * 100:.0f}"


def _binned_mean_std(x: np.ndarray, y: np.ndarray, bins):
    """Per-bin mean/std of y grouped by x (scipy.binned_statistic
    equivalent, kept dependency-free)."""
    edges = np.asarray(bins, dtype=float)
    idx = np.digitize(x, edges) - 1  # bin i covers [edges[i], edges[i+1])
    nb = len(edges) - 1
    means = np.full(nb, np.nan)
    stds = np.full(nb, np.nan)
    for i in range(nb):
        sel = y[idx == i]
        if len(sel):
            means[i] = sel.mean()
            stds[i] = sel.std()
    centers = (edges[:-1] + edges[1:]) / 2
    return centers, means, stds


def plot_qsm_comparison(
    dist_orig: np.ndarray,
    dist_pred: np.ndarray,
    mean_dists,
    errors,
    improvements,
    imp_errors,
    model_labels,
    output_path: str,
    title: str = "Comparison of Pipeline QSM to TreeQSM",
):
    """Three-panel QSM comparison (qsm_comp_new.py:195-372): left, the
    binned original-vs-new per-point distance means on the piecewise cm
    scale with a y=x diagonal and 10 cm guides; right, per-model mean
    distance and improvement bars (values in m, plotted in cm)."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6.5))
    gs = fig.add_gridspec(2, 3)
    ax_left = fig.add_subplot(gs[:, 0:2])
    ax_tr = fig.add_subplot(gs[0, 2])
    ax_br = fig.add_subplot(gs[1, 2])

    n = min(len(dist_orig), len(dist_pred))
    if n:
        centers, means, stds = _binned_mean_std(
            np.asarray(dist_orig[:n]), np.asarray(dist_pred[:n]),
            COMPARISON_BINS,
        )
        x_t = custom_scale(centers)
        y_t = custom_scale(means)
        if len(centers) and np.isposinf(centers[-1]):
            # place the inf-bin marker between the 100 cm tick and the edge
            x_t[-1] = 20.5
        ok = ~np.isnan(x_t) & ~np.isnan(y_t)
        lo = custom_scale(np.clip(means - stds, 1e-6, None))
        hi = custom_scale(means + stds)
        yerr = [
            np.maximum(y_t - lo, 0)[ok],
            np.maximum(hi - y_t, 0)[ok],
        ]
        ax_left.errorbar(
            x_t[ok], y_t[ok], yerr=yerr, fmt="o", color="red",
            label="Binned Mean", capsize=3, elinewidth=1, zorder=10,
        )

    diag = np.linspace(0, 21.5, 50)
    ax_left.plot(diag, diag, "k--", label="y = x")
    tick_vals = (
        [0.0, 0.01]
        + [i / 100 for i in range(2, 10)]
        + [i / 100 for i in range(10, 101, 10)]
        + [np.inf]
    )
    tick_pos = custom_scale(np.array(tick_vals))
    ax_left.set_xticks(tick_pos)
    ax_left.set_xticklabels(
        [custom_label(v) for v in tick_vals], rotation=45, ha="right"
    )
    ax_left.set_yticks(tick_pos)
    ax_left.set_yticklabels([custom_label(v) for v in tick_vals])
    ten_cm = custom_scale([0.1])[0]
    ax_left.axhline(ten_cm, color="gray", linewidth=0.8)
    ax_left.axvline(ten_cm, color="gray", linewidth=0.8)
    ax_left.grid(True, linestyle=":", linewidth=0.5, alpha=0.7)
    ax_left.set_xlabel("Original Point to QSM Distance (cm)")
    ax_left.set_ylabel("New Point to QSM Distance (cm)")
    ax_left.set_title("Point to QSM Distance Comparison")
    ax_left.legend()
    ax_left.set_xlim(-0.5, 21.5)
    ax_left.set_ylim(-0.5, 21.5)

    md = np.nan_to_num(np.asarray(mean_dists, float))
    er = np.nan_to_num(np.asarray(errors, float))
    im = np.nan_to_num(np.asarray(improvements, float))
    ie = np.nan_to_num(np.asarray(imp_errors, float))
    ax_tr.bar(
        model_labels, md * 100, yerr=er * 100, color="red", alpha=0.7,
        capsize=5,
    )
    ax_tr.set_ylabel("Mean Dist. to\nEnhanced QSM (cm)")
    ax_tr.set_title("Mean Distance Evaluation")
    ax_tr.tick_params(axis="x", rotation=15)
    ax_br.bar(
        model_labels, im * 100, yerr=ie * 100, color="red", alpha=0.7,
        capsize=5,
    )
    ax_br.set_ylabel("Dist. Improvement over\nOriginal (cm)")
    ax_br.tick_params(axis="x", rotation=15)

    fig.suptitle(title)
    fig.tight_layout(rect=[0, 0.03, 1, 0.93])
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def per_tree_mean_distances(
    orig_dir: str, new_dir: str, suffix: str = "_projected.npy"
):
    """Per-tree (mean original, mean new, tree id) triples for identically
    named projected clouds (qsm_comp_new_testset_proportion.py:26-88)."""
    means_orig, means_new, ids = [], [], []
    if not (os.path.isdir(orig_dir) and os.path.isdir(new_dir)):
        return means_orig, means_new, ids
    for name in sorted(os.listdir(new_dir)):
        if not name.endswith(suffix):
            continue
        d_o = offset_norms_from_file(os.path.join(orig_dir, name))
        d_n = offset_norms_from_file(os.path.join(new_dir, name))
        if d_o is None or d_n is None or not len(d_o) or not len(d_n):
            continue
        means_orig.append(float(np.mean(d_o)))
        means_new.append(float(np.mean(d_n)))
        ids.append(name[: -len(suffix)])
    return means_orig, means_new, ids


def plot_per_tree_mean_distances(
    means_orig_m,
    means_new_m,
    output_path: str,
    title: str = "Comparison of Mean Point-to-QSM Distances per Tree",
    y_limit_cm: float = 15.0,
):
    """Per-tree paired dot plot: original vs new mean distance joined by a
    segment, values beyond the 15 cm cap annotated above the axis
    (qsm_comp_new_testset_proportion.py:90-232)."""
    plt = _plt()
    n = len(means_orig_m)
    if n == 0 or n != len(means_new_m):
        raise ValueError("need equal, non-empty mean-distance lists")
    orig_cm = np.asarray(means_orig_m, float) * 100
    new_cm = np.asarray(means_new_m, float) * 100
    x = np.arange(n)

    fig, ax = plt.subplots(
        figsize=(min(20.0, max(5.0, 4.0 + n * 0.38)), 6.0)
    )
    o_y = np.minimum(orig_cm, y_limit_cm)
    n_y = np.minimum(new_cm, y_limit_cm)
    for i in range(n):
        ax.plot([x[i], x[i]], [o_y[i], n_y[i]], color="darkgray",
                linewidth=1.5, zorder=1)
    ax.scatter(x, o_y, color="royalblue", label="Original QSM", s=70,
               edgecolors="black", linewidth=0.75, zorder=2)
    ax.scatter(x, n_y, color="orangered", label="New QSM", s=70,
               edgecolors="black", linewidth=0.75, zorder=2)
    for i in range(n):
        for val, color in ((orig_cm[i], "royalblue"),
                           (new_cm[i], "orangered")):
            if val > y_limit_cm:
                ax.text(
                    x[i], y_limit_cm * 1.015, f"{val:.1f}", color=color,
                    ha="center", va="bottom", fontsize=11,
                    bbox=dict(facecolor="white", alpha=0.6, pad=0.1,
                              edgecolor="none"),
                )
    ax.set_xticks([])
    ax.set_xlim(-0.5, n - 0.5)
    ax.set_ylim(0, y_limit_cm)
    ax.set_yticks(np.arange(0, y_limit_cm + 1, 2.5))
    ax.set_ylabel("Mean Point to QSM Distance (cm)")
    ax.set_title(title, pad=25)
    ax.grid(True, axis="y", alpha=1.0)
    ax.legend(loc="upper right")
    for side in ("top", "right", "bottom"):
        ax.spines[side].set_visible(False)
    fig.tight_layout(rect=[0.05, 0.05, 0.98, 0.90])
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


#: the reference's fixed slice AABBs of the 42_3 tree and their view
#: directions (slice_plotting.py:156-164)
REFERENCE_SLICE_BOUNDS = (
    (21.9, 22.25, -20.9, -20.5, -2.8, -2.6),
    (21.0, 23.0, -23.0, -21.3, 8.3, 8.95),
    (19.55, 21.1, -19.8, -17.51, 13.12, 13.6),
    (18.2, 20.7, -25.4, -22.8, 16.5, 17.47),
    (20.5, 22.4, -21.0, -19.9, 22.15, 24.7),
)
REFERENCE_SLICE_VIEWS = ("z", "z", "z", "z", "y")


def _project_slice(points: np.ndarray, bound, view: str) -> np.ndarray:
    """2D projection of the points inside an AABB slice. 'z' projects to
    XY; 'y' rotates XY 45 deg about the slice center then takes
    (rotated x, z) (slice_plotting.py:196-226)."""
    xmin, xmax, ymin, ymax, zmin, zmax = bound
    mask = (
        (points[:, 0] >= xmin) & (points[:, 0] <= xmax)
        & (points[:, 1] >= ymin) & (points[:, 1] <= ymax)
        & (points[:, 2] >= zmin) & (points[:, 2] <= zmax)
    )
    pts = points[mask]
    if view == "y":
        theta = np.radians(45)
        rot = np.array(
            [[np.cos(theta), -np.sin(theta)],
             [np.sin(theta), np.cos(theta)]]
        )
        centered = pts[:, :2] - [(xmin + xmax) / 2, (ymin + ymax) / 2]
        return np.column_stack([(centered @ rot.T)[:, 0], pts[:, 2]])
    return pts[:, :2]


def plot_transformation_slices(
    points: np.ndarray,
    offsets: np.ndarray,
    output_path: str,
    bounds=REFERENCE_SLICE_BOUNDS,
    views=REFERENCE_SLICE_VIEWS,
):
    """Two-row slice grid: original points on top, offset-transformed
    points below, one column per slice AABB
    (slice_plotting.py:120-328)."""
    plt = _plt()
    transformed = points[:, :3] + offsets[:, :3]
    k = len(bounds)
    fig, axes = plt.subplots(
        2, k, figsize=(3 * k, 6), constrained_layout=True, squeeze=False
    )
    for i, (bound, view) in enumerate(zip(bounds, views)):
        for row, (cloud, label) in enumerate(
            ((points, "Original"), (transformed, "Result"))
        ):
            proj = _project_slice(cloud, bound, view)
            ax = axes[row][i]
            if len(proj):
                ax.scatter(proj[:, 0], proj[:, 1], s=1, color="black")
            ax.set_xticks([])
            ax.set_yticks([])
            for side in ("top", "right"):
                ax.spines[side].set_visible(False)
            if i == 0:
                ax.set_ylabel(label, fontsize=14)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def _cylinder_columns(df):
    """Resolve the QSM table's column-name variants to the internal names
    (same mapping as ops.projection.QSM_COLUMN_MAPPINGS)."""
    from ..ops.projection import QSM_COLUMN_MAPPINGS

    out = {}
    for internal, candidates in QSM_COLUMN_MAPPINGS.items():
        found = next((c for c in candidates if c in df.columns), None)
        if found is None and internal != "ID":
            raise KeyError(f"QSM table missing {internal}")
        out[internal] = found
    return out


def plot_qsm_comparison_slices(
    cloud: np.ndarray,
    original_cylinders,
    enhanced_cylinders,
    output_path: str,
    bounds=REFERENCE_SLICE_BOUNDS,
    views=REFERENCE_SLICE_VIEWS,
    title=(
        "Visual Comparison of Original and Pipeline QSMs "
        "Across Tree Slices"
    ),
):
    """Two-row slice grid overlaying QSM cylinders on the point cloud:
    original QSM on top, pipeline ('enhanced') QSM below
    (``Plotting/qsm_comp_new_visual.py:7-156``). Cylinders intersecting a
    slice render as 2D rectangles along their projected axis — or circles
    in the first top-down slice — over the slice's point scatter."""
    plt = _plt()
    from matplotlib.patches import Polygon

    k = len(bounds)
    fig, axes = plt.subplots(
        2, k, figsize=(3 * k, 6), constrained_layout=True, squeeze=False
    )

    def draw_cylinders(ax, df, bound, view, slice_index):
        cols = _cylinder_columns(df)
        xmin, xmax, ymin, ymax, zmin, zmax = bound
        theta = np.radians(45)
        rot = np.array(
            [[np.cos(theta), -np.sin(theta)],
             [np.sin(theta), np.cos(theta)]]
        )

        def column(name):
            return np.asarray(df[cols[name]], float)

        starts = np.stack(
            [column(c) for c in ("startX", "startY", "startZ")], 1)
        ends = np.stack([column(c) for c in ("endX", "endY", "endZ")], 1)
        for s, e, r in zip(starts, ends, column("radius")):
            inside = any(
                xmin <= p[0] <= xmax and ymin <= p[1] <= ymax
                and zmin <= p[2] <= zmax
                for p in (s, e)
            )
            if not inside:
                continue
            r = float(r)
            if view == "z" and slice_index == 0:
                c = (s + e) / 2
                ax.add_patch(
                    plt.Circle((c[0], c[1]), r, color="grey", alpha=0.5)
                )
                continue
            if view == "z":
                p0, p1 = s[:2], e[:2]
            else:  # 'y'
                center = np.array(
                    [(xmin + xmax) / 2, (ymin + ymax) / 2]
                )
                p0 = np.array(
                    [((s[:2] - center) @ rot.T)[0], s[2]]
                )
                p1 = np.array(
                    [((e[:2] - center) @ rot.T)[0], e[2]]
                )
            vec = p1 - p0
            norm = np.linalg.norm(vec)
            if norm == 0:
                continue
            d = vec / norm
            perp = np.array([-d[1], d[0]])
            ax.add_patch(
                Polygon(
                    [p0 + perp * r, p0 - perp * r, p1 - perp * r,
                     p1 + perp * r],
                    edgecolor="black", facecolor="gray", alpha=0.5,
                )
            )

    for i, (bound, view) in enumerate(zip(bounds, views)):
        proj = _project_slice(cloud[:, :3], bound, view)
        xmin, xmax, ymin, ymax, zmin, zmax = bound
        for row_i, (df, label) in enumerate(
            ((original_cylinders, "Original QSM"),
             (enhanced_cylinders, "Enhanced QSM"))
        ):
            ax = axes[row_i][i]
            if len(proj):
                ax.scatter(proj[:, 0], proj[:, 1], s=1, c="black")
            draw_cylinders(ax, df, bound, view, i)
            if row_i == 0:
                ax.set_title(f"Slice {i + 1}")
            for side in ("top", "right", "bottom", "left"):
                ax.spines[side].set_visible(False)
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_ylabel(label, fontsize=14)
            if view == "z":
                ax.set_xlim(xmin, xmax)
                ax.set_ylim(ymin, ymax)
            else:
                ax.set_xlim(-1.5, 1.5)
                ax.set_ylim(zmin, zmax)

    fig.suptitle(title, fontsize=16)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path
