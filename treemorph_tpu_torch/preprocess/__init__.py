"""Preprocessing: labeling clouds against their QSMs
(:mod:`.label_generation`), noise clouds (:mod:`.noise_generation`, whose
function keeps to its module: the package exports no name of a
submodule), cutting labeled clouds into rasters (:mod:`.rasterize`) and
the dataset splits (:mod:`.splitting`)."""

from .label_generation import label_clouds
from .rasterize import clean_stem, rasterize_clouds
from .splitting import create_qsm_test_sets, select_test_subset, split_dataset

__all__ = [
    "clean_stem",
    "create_qsm_test_sets",
    "label_clouds",
    "rasterize_clouds",
    "select_test_subset",
    "split_dataset",
]
