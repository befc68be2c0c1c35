from .treeset import (
    PaddedBatch,
    TreeDataset,
    pad_to_bucket,
    make_padded_batch,
    batch_iterator,
    get_plot_split,
    get_random_split,
)
from .rasterized import (
    HierarchicalRasterDataset,
    RasterDataset,
    TreeRasters,
    hierarchical_batch_iterator,
    hierarchical_group_iterator,
    raster_dataset_from_dir,
)

__all__ = [
    "PaddedBatch",
    "TreeDataset",
    "pad_to_bucket",
    "make_padded_batch",
    "batch_iterator",
    "get_plot_split",
    "get_random_split",
    "RasterDataset",
    "TreeRasters",
    "HierarchicalRasterDataset",
    "raster_dataset_from_dir",
    "hierarchical_batch_iterator",
    "hierarchical_group_iterator",
]
