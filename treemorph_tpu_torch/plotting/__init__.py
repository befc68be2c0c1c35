"""Figures of the evaluation suite (port of ``treemorph_tpu/plotting``)."""

from .figures import (
    plot_epoch_time_comparison,
    plot_distance_heatmap,
    plot_offset_slices,
    plot_upsampling_visual,
    qsm_csv_to_ply,
)
from .qsm_comparison import (
    load_pointwise_distance_pairs,
    mean_distance_and_error,
    offset_norms_from_file,
    per_tree_mean_distances,
    plot_per_tree_mean_distances,
    plot_qsm_comparison,
    plot_qsm_comparison_slices,
    plot_transformation_slices,
)

__all__ = [
    "plot_epoch_time_comparison",
    "plot_distance_heatmap",
    "plot_offset_slices",
    "plot_upsampling_visual",
    "qsm_csv_to_ply",
    "load_pointwise_distance_pairs",
    "mean_distance_and_error",
    "offset_norms_from_file",
    "per_tree_mean_distances",
    "plot_per_tree_mean_distances",
    "plot_qsm_comparison",
    "plot_qsm_comparison_slices",
    "plot_transformation_slices",
]
