"""Figure generation suite.

Port of ``treemorph_tpu/plotting/figures.py``, the reference ``Plotting/``
scripts (C24):
- :func:`plot_epoch_time_comparison` — per-model training-cost bars
  (``computational_expenses.py``);
- :func:`plot_distance_heatmap` — height vs distance-to-QSM heatmap
  (``distance_distribution_heatmap.py``);
- :func:`plot_offset_slices` — GT vs predicted offset quivers in fixed
  slice AABBs, the single-tree visual diagnostic of ``Modules/Testing.py``
  (:20-107, 355-573) and ``slice_plotting.py``;
- :func:`plot_upsampling_visual` — before/after upsampling scatter
  (``upsampling_visual.py``);
- :func:`qsm_csv_to_ply` — QSM CSV -> cylinder mesh PLY (``csv_to_ply.py``)
  using the numpy mesh builders instead of open3d.

All figures are written headless (Agg backend); matplotlib is imported
only when a figure is drawn, so computing metrics never needs it. Figures
are host work: they touch no device.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.mesh import combine_meshes, cylinder_mesh, write_ply


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_epoch_time_comparison(
    timings: dict[str, list[float]], output_path: str
):
    """Bar chart of per-model epoch times with run scatter.

    ``timings``: model name -> list of per-epoch seconds (the reference
    hardcodes its measurements, computational_expenses.py:6-12; here they
    come from the harness history records).
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    names = list(timings)
    means = [float(np.mean(timings[n])) for n in names]
    ax.bar(names, means, color="tab:blue", alpha=0.7)
    for i, n in enumerate(names):
        ys = timings[n]
        ax.scatter([i] * len(ys), ys, color="k", s=12, zorder=3)
    ax.set_ylabel("epoch time (s)")
    ax.set_yscale("log")
    ax.set_title("Training cost per epoch")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path


def plot_distance_heatmap(
    points: np.ndarray,
    distances: np.ndarray,
    output_path: str,
    n_height_bins: int = 40,
    n_dist_bins: int = 40,
):
    """Height-vs-distance density heatmap
    (reference distance_distribution_heatmap.py)."""
    plt = _plt()
    z = points[:, 2] - points[:, 2].min()
    d = np.clip(distances, 1e-5, None)
    fig, ax = plt.subplots(figsize=(7, 5))
    h, xe, ye = np.histogram2d(
        np.log10(d), z, bins=(n_dist_bins, n_height_bins)
    )
    im = ax.imshow(
        h.T,
        origin="lower",
        aspect="auto",
        extent=(xe[0], xe[-1], ye[0], ye[-1]),
        cmap="viridis",
    )
    fig.colorbar(im, label="points")
    ax.set_xlabel("log10 distance to QSM (m)")
    ax.set_ylabel("height above base (m)")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path


DEFAULT_SLICES = (
    # z ranges relative to the cloud base (the reference uses 5 fixed
    # AABBs of the 42_3 tree, Testing.py:60-107)
    (0.0, 0.5),
    (2.0, 2.5),
    (5.0, 5.5),
    (8.0, 8.5),
    (12.0, 12.5),
)


def plot_offset_slices(
    points: np.ndarray,
    gt_offsets: np.ndarray,
    pred_offsets: np.ndarray,
    output_path: str,
    slices=DEFAULT_SLICES,
    max_arrows: int = 400,
    rng: np.random.Generator | None = None,
):
    """GT vs predicted offset quivers in horizontal slices (XY projection)."""
    plt = _plt()
    rng = rng or np.random.default_rng(0)
    z0 = points[:, 2].min()
    n = len(slices)
    fig, axes = plt.subplots(2, n, figsize=(3.2 * n, 6.5), squeeze=False)
    for col, (lo, hi) in enumerate(slices):
        mask = (points[:, 2] >= z0 + lo) & (points[:, 2] < z0 + hi)
        idx = np.nonzero(mask)[0]
        if len(idx) > max_arrows:
            idx = rng.choice(idx, max_arrows, replace=False)
        for row, (offs, title) in enumerate(
            ((gt_offsets, "ground truth"), (pred_offsets, "predicted"))
        ):
            ax = axes[row][col]
            if len(idx):
                ax.quiver(
                    points[idx, 0],
                    points[idx, 1],
                    offs[idx, 0],
                    offs[idx, 1],
                    angles="xy",
                    scale_units="xy",
                    scale=1.0,
                    width=0.004,
                    color="tab:green" if row == 0 else "tab:red",
                )
                ax.scatter(points[idx, 0], points[idx, 1], s=2, c="k",
                           alpha=0.4)
            ax.set_title(f"{title} z=[{lo},{hi})m")
            ax.set_aspect("equal")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path


def plot_upsampling_visual(
    original: np.ndarray, upsampled: np.ndarray, output_path: str
):
    """Side-by-side XZ scatter before/after upsampling."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 6), sharex=True,
                             sharey=True)
    for ax, pts, title in (
        (axes[0], original, f"original ({len(original)} pts)"),
        (axes[1], upsampled, f"upsampled ({len(upsampled)} pts)"),
    ):
        ax.scatter(pts[:, 0], pts[:, 2], s=0.5, alpha=0.5)
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path


def qsm_csv_to_ply(
    csv_path: str, ply_path: str, resolution: int = 10
) -> str:
    """QSM cylinder CSV -> triangle-mesh PLY (reference csv_to_ply.py),
    accepting the same column-name variants as the projection op."""
    from ..ops.projection import QSM_COLUMN_MAPPINGS
    from ..utils.table import Table

    df = Table.read_csv(csv_path)
    cols = {}
    for internal, candidates in QSM_COLUMN_MAPPINGS.items():
        found = next((c for c in candidates if c in df.columns), None)
        if found is None and internal != "ID":
            raise KeyError(f"column {internal} missing in {csv_path}")
        cols[internal] = found

    def column(name):
        return np.asarray(df[cols[name]], float)

    starts = np.stack([column(c) for c in ("startX", "startY", "startZ")], 1)
    ends = np.stack([column(c) for c in ("endX", "endY", "endZ")], 1)
    radii = column("radius")
    r_min, r_max = radii.min(), radii.max()
    meshes = []
    for start, end, radius in zip(starts, ends, radii):
        t = (radius - r_min) / (r_max - r_min + 1e-9)
        v, f = cylinder_mesh(start, end, float(radius), resolution)
        meshes.append((v, f, [t, 1 - t, 0.2]))
    verts, faces, colors = combine_meshes(meshes)
    write_ply(ply_path, verts, faces, colors)
    return ply_path
