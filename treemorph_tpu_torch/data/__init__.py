from .treeset import (
    PaddedBatch,
    TreeDataset,
    pad_to_bucket,
    make_padded_batch,
    batch_iterator,
    get_plot_split,
    get_random_split,
)

__all__ = [
    "PaddedBatch",
    "TreeDataset",
    "pad_to_bucket",
    "make_padded_batch",
    "batch_iterator",
    "get_plot_split",
    "get_random_split",
]
