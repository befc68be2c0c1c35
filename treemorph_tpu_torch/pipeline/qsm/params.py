"""QSM fitting parameters.

One structured dataclass replacing the reference's 23-key ``qsm_params``
YAML block (``PipelineExecution/pipeline_config.yaml:29-57``, consumed at
``QSMFittingDepthFirst.py:1787-1793``). Defaults match the shipped pipeline
config; ``eps`` is the angular-DBSCAN threshold in radians (converted from
``eps_deg`` exactly like the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np


@dataclass
class QSMParams:
    eps_deg: float = 20.0
    min_samples: int = 5
    sphere_factor: float = 2.0
    radius_min: float = 0.15
    radius_max: float = 0.4
    min_growth_points: int = 10
    min_points_threshold: int = 4
    max_spread_growth: float = 1.05
    min_spread_growth: float = 0.33
    smallest_search_radius: float = 0.1
    search_radius_step: float = 0.1
    max_search_radius: float = 0.3
    max_dist: float = 0.4
    max_angle: float = 30.0
    distance_type: str = "center"  # or "effective"
    sphere_radius: float = 0.15
    sphere_thickness: float = 0.1
    sphere_thickness_type: str = "absolute"  # or "relative"
    clustering_algorithm: str = "agglomerative"
    merging_procedure: str = "none"  # none | weighted | enclosed | subset
    merging_eps_factor: float = 1.0
    clustering_linkage: str = "single"
    clustering_type: str = "angular"  # or "euclidian"
    eps_cylinder: float = 0.1
    segmentation_type: str = "cylinder"  # or "sphere"
    only_correct_connections: bool = True
    priority_alpha: float = 0.5
    ransac_iterations: int = 10
    ransac_subset_percentage: float = 0.8
    min_points_absolute_stop: int = 0
    seed: int | None = 0  # RNG seed for reproducible fits (net-new)

    @property
    def eps(self) -> float:
        return float(np.radians(self.eps_deg))

    @classmethod
    def from_dict(cls, raw: dict) -> "QSMParams":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})
