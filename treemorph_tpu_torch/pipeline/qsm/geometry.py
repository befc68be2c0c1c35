"""Geometric primitives of the QSM sphere-following algorithm.

Behavioral parity with reference ``QSMFittingDepthFirst.py``: candidate
branch detection on a sphere's outer shell (:80-264), base-slice seed-sphere
initialization (:665-764), point-spread estimation (:651-662), and the
clustering label helpers (:827-886).

The shell clustering pipeline per sphere: cluster shell points (angular
DBSCAN over unit directions by default), fit a PCA plane per cluster,
RANSAC-average algebraic circle fits in the plane, and return (3D center,
spread) candidates filtered by distance from the parent sphere.
"""

from __future__ import annotations

import numpy as np

from ...utils.fitting import fit_circle_2d
from .structures import Sphere


def compute_spread_of_points(points: np.ndarray) -> float:
    """Mean distance to centroid (reference :651-662)."""
    if len(points) < 2:
        return 0.01
    centroid = points.mean(axis=0)
    return float(np.linalg.norm(points - centroid, axis=1).mean())


def cluster_labels_agglomerative(
    points, eps=0.2, min_cluster_size=5, linkage="average"
):
    """Agglomerative clustering with DBSCAN-style labels (reference
    :827-857). It needs scikit-learn, which the port does not use; the
    default angular clustering never reaches it."""
    raise NotImplementedError(
        "agglomerative shell clustering (clustering_type='euclidian', "
        "clustering_algorithm='agglomerative') is not ported"
    )


def cluster_labels_euclidian(points, eps=0.03, min_cluster_size=5):
    """Flood-fill euclidean clustering (reference :859-886)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    labels = -np.ones(len(points), dtype=int)
    cluster_id = 0
    for idx in range(len(points)):
        if labels[idx] != -1:
            continue
        neighbors = tree.query_ball_point(points[idx], eps)
        if len(neighbors) < min_cluster_size:
            continue
        queue = set(neighbors)
        labels[list(queue)] = cluster_id
        while queue:
            current = queue.pop()
            for nb in tree.query_ball_point(points[current], eps):
                if labels[nb] == -1:
                    labels[nb] = cluster_id
                    queue.add(nb)
        cluster_id += 1
    return labels


def _ransac_circle(
    projected_2d: np.ndarray,
    iterations: int,
    subset_percentage: float,
    rng: np.random.Generator,
):
    """RANSAC-averaged algebraic circle fit; returns (center2d, radius) or
    None (reference :195-241)."""
    n = len(projected_2d)
    if n < 3:
        return None
    subset = max(3, int(n * subset_percentage))
    subset = min(subset, n)
    centers, radii = [], []
    for _ in range(iterations):
        idx = rng.choice(n, subset, replace=False)
        center, radius = fit_circle_2d(projected_2d[idx])
        if np.isfinite(center).all() and np.isfinite(radius) and radius >= 0:
            centers.append(center)
            radii.append(radius)
    if centers:
        return np.mean(centers, axis=0), float(np.mean(radii))
    center, radius = fit_circle_2d(projected_2d)
    if np.isfinite(center).all() and np.isfinite(radius):
        return center, float(radius)
    return None


def _pca_plane(coords: np.ndarray):
    """Best-fit plane via eigendecomposition of the covariance.

    Returns (centroid, basis (3,2)) or None on failure.
    """
    centroid = coords.mean(axis=0)
    centered = coords - centroid
    try:
        cov = np.cov(centered, rowvar=False)
        eigenvalues, eigenvectors = np.linalg.eigh(cov)
        order = np.argsort(eigenvalues)[::-1]
        basis = eigenvectors[:, order][:, :2]
    except np.linalg.LinAlgError:
        return None
    return centroid, basis, centered


def get_candidate_centers_and_spreads(
    sphere: Sphere,
    points: np.ndarray,
    eps: float,
    min_samples: int,
    algorithm: str = "agglomerative",
    linkage: str = "average",
    clustering_type: str = "angular",
    ransac_iterations: int = 20,
    ransac_subset_percentage: float = 0.75,
    rng: np.random.Generator | None = None,
):
    """Branch candidates on a sphere's shell (reference :80-264).

    Marks the sphere ``is_outer`` when no candidates are found (and when a
    seed sphere yields exactly one candidate, mirroring :259-261).
    """
    rng = rng or np.random.default_rng(0)
    if sphere.outer_points.size == 0:
        sphere.is_outer = True
        return []

    shell = points[sphere.outer_points]

    if clustering_type == "euclidian":
        if len(shell) < 2:
            sphere.is_outer = True
            return []
        if algorithm == "agglomerative":
            labels = cluster_labels_agglomerative(
                shell, eps=eps, min_cluster_size=min_samples, linkage=linkage
            )
        elif algorithm == "euclidian":
            labels = cluster_labels_euclidian(
                shell, eps=eps, min_cluster_size=min_samples
            )
        else:
            raise NotImplementedError(
                "euclidean DBSCAN shell clustering "
                f"(clustering_algorithm={algorithm!r}) is not ported"
            )
    else:  # angular: DBSCAN on pairwise angles between shell directions
        vectors = shell - sphere.center
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        unit = vectors / np.maximum(norms, 1e-9)
        # native C++ path (treemorph_tpu_torch.native) — this clustering
        # runs thousands of times per tree on small matrices.
        from ...native import angular_cluster

        labels = angular_cluster(unit, eps, min_samples)

    valid_labels = set(labels) - {-1}
    if not valid_labels:
        sphere.is_outer = True
        return []

    candidates = []
    for label in valid_labels:
        cluster_coords = shell[labels == label]
        if len(cluster_coords) < 3:
            continue
        plane = _pca_plane(cluster_coords)
        if plane is None:
            continue
        centroid, basis, centered = plane
        projected = centered @ basis
        fit = _ransac_circle(
            projected, ransac_iterations, ransac_subset_percentage, rng
        )
        if fit is None:
            continue
        center_2d, spread = fit
        center_3d = centroid + basis @ center_2d
        # Reject candidates drifting too far from the parent (:247-254)
        if np.linalg.norm(center_3d - sphere.center) > sphere.radius * 1.5:
            continue
        candidates.append((center_3d, spread))

    if sphere.is_seed and len(candidates) == 1:
        sphere.is_outer = True
    return candidates


def initialize_first_sphere(
    points: np.ndarray,
    slice_height: float = 0.5,
    sphere_thickness: float = 0.1,
    sphere_thickness_type: str = "relative",
    rng: np.random.Generator | None = None,
) -> Sphere:
    """Seed sphere from the lowest slice of the tree (reference :665-764):
    PCA plane + RANSAC circle fit of the base slice; sphere radius =
    2 * fitted radius, centered at the fitted center dropped to min z."""
    rng = rng or np.random.default_rng(0)
    min_z = points[:, 2].min()
    base = points[points[:, 2] <= min_z + slice_height]
    if len(base) < 10:
        raise ValueError(
            "Not enough points near the base to initialize the seed sphere."
        )
    plane = _pca_plane(base)
    if plane is None:
        raise ValueError("PCA failed for the base slice.")
    centroid, basis, centered = plane
    projected = centered @ basis
    fit = _ransac_circle(projected, 10, 0.8, rng)
    if fit is None:
        raise ValueError("Circle fit failed for the base slice.")
    center_2d, radius = fit
    center_3d = centroid + basis @ center_2d
    center_3d[2] = min_z
    return Sphere(
        center_3d,
        radius=radius * 2,
        thickness=sphere_thickness,
        is_seed=True,
        spread=radius,
        thickness_type=sphere_thickness_type,
    )


def find_seed_sphere(
    points: np.ndarray,
    potential_seed_indices: np.ndarray,
    sphere_radius: float,
    sphere_thickness: float,
    sphere_thickness_type: str = "relative",
    rng: np.random.Generator | None = None,
) -> Sphere:
    """Random unsegmented point becomes a new seed (reference :767-781)."""
    rng = rng or np.random.default_rng(0)
    if potential_seed_indices.size == 0:
        raise ValueError("No potential seed indices provided.")
    seed_idx = int(rng.choice(potential_seed_indices))
    return Sphere(
        points[seed_idx],
        radius=sphere_radius,
        thickness=sphere_thickness,
        is_seed=True,
        spread=None,
        thickness_type=sphere_thickness_type,
    )
