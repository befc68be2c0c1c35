from .synthetic import (
    synthetic_cylinder_cloud,
    synthetic_qsm,
    synthetic_tree_cloud,
    qsm_noise_cloud,
)

__all__ = [
    "synthetic_cylinder_cloud",
    "synthetic_qsm",
    "synthetic_tree_cloud",
    "qsm_noise_cloud",
]
