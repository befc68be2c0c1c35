"""Geometric primitives of the QSM sphere-following algorithm.

Behavioral parity with reference ``QSMFittingDepthFirst.py``: candidate
branch detection on a sphere's outer shell (:80-264), base-slice seed-sphere
initialization (:665-764), point-spread estimation (:651-662), and the
clustering label helpers (:827-886). scikit-learn's agglomerative
clustering and DBSCAN, which the JAX package calls, are rebuilt on scipy
with scikit-learn's label numbering (the card's machine has no
scikit-learn).

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


def _mst_single_linkage(x: np.ndarray):
    """scikit-learn's single-linkage tree without connectivity
    (``_agglomerative.py::linkage_tree``): Prim's MST as
    ``_hierarchical_fast.pyx::mst_linkage_core`` builds it (each row the
    node added last, the node it adds, the distance; ties to the lowest
    index), rows stably sorted by distance, then merged by union-find as
    ``single_linkage_label`` merges them. Returns (children, distances)."""
    n, n_features = x.shape
    in_tree = np.zeros(n, bool)
    current = np.full(n, np.inf)
    mst = np.zeros((n - 1, 3))
    node = 0
    for i in range(n - 1):
        in_tree[node] = True
        # the Euclidean distance as the Cython metric sums it, in order
        diff = x[node] - x
        sq = diff[:, 0] * diff[:, 0]
        for k in range(1, n_features):
            sq = sq + diff[:, k] * diff[:, k]
        d = np.sqrt(sq)
        closer = ~in_tree & (d < current)
        current[closer] = d[closer]
        new = int(np.argmin(np.where(in_tree, np.inf, current)))
        mst[i] = node, new, current[new]
        node = new
    mst = mst[np.argsort(mst[:, 2], kind="mergesort")]
    parent = np.full(2 * n - 1, -1, dtype=np.intp)
    children = np.zeros((n - 1, 2), dtype=np.intp)

    def find(a):
        root = a
        while parent[root] != -1:
            root = parent[root]
        while a != root:  # path compression; the roots are sklearn's
            a, parent[a] = parent[a], root
        return root

    for i, (left, right, _) in enumerate(mst):
        a, b = find(int(left)), find(int(right))
        children[i] = a, b
        parent[a] = parent[b] = n + i
    return children, mst[:, 2]


def _linkage_tree(x: np.ndarray, linkage: str):
    """(children, merge distances) of scikit-learn's full tree for
    ``linkage`` without connectivity: scipy's ``linkage`` (``ward`` through
    ``hierarchy.ward``), single linkage through
    :func:`_mst_single_linkage`."""
    if linkage == "single":
        return _mst_single_linkage(x)
    from scipy.cluster import hierarchy

    if linkage == "ward":
        out = hierarchy.ward(x)
    elif linkage in ("average", "complete"):
        out = hierarchy.linkage(x, method=linkage, metric="euclidean")
    else:
        raise ValueError(f"unknown linkage {linkage!r}")
    return out[:, :2].astype(np.intp), out[:, 2]


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int):
    """scikit-learn's ``_agglomerative.py::_hc_cut``: split the tree's
    largest node ``n_clusters - 1`` times on a heap of negated node ids,
    then number the clusters by the heap's order."""
    import heapq

    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    labels = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            j = stack.pop()
            if j < n_leaves:
                leaves.append(j)
            else:
                stack.extend(children[j - n_leaves])
        labels[leaves] = i
    return labels


def cluster_labels_agglomerative(
    points, eps=0.2, min_cluster_size=5, linkage="average"
):
    """Agglomerative clustering with DBSCAN-style labels; clusters smaller
    than ``min_cluster_size`` become -1 (reference :827-857).

    scikit-learn's ``AgglomerativeClustering(n_clusters=None,
    distance_threshold=eps, linkage=linkage)`` without scikit-learn: the
    full tree (:func:`_linkage_tree`), ``count(distances >= eps) + 1``
    clusters (``_agglomerative.py:1082``), cut and numbered as its
    ``_hc_cut`` numbers them, so that labels match number for number."""
    if len(points) < 2:
        return -np.ones(len(points), dtype=int)
    x = np.ascontiguousarray(points, dtype=np.float64)
    children, distances = _linkage_tree(x, linkage)
    n_clusters = int(np.count_nonzero(distances >= eps)) + 1
    labels = _hc_cut(n_clusters, children, len(x))
    out = -np.ones_like(labels)
    unique, counts = np.unique(labels, return_counts=True)
    for label, count in zip(unique, counts):
        if count >= min_cluster_size:
            out[labels == label] = label
    return out


def _brute_neighbourhoods(x: np.ndarray, eps: float, single: bool) -> list:
    """Neighbourhoods as sklearn's brute-force Euclidean radius search
    computes them (``_radius_neighbors.pyx.tp::EuclideanRadiusNeighbors``):
    ``|x|^2 + (-2 x . y) + |y|^2`` in float64 from the same BLAS calls
    (``ddot`` for the norms, one ``dgemm`` for the middle terms), clipped
    at 0, against ``eps**2``, which its float32 version (``single``: the
    points were float32) squares in float32."""
    from scipy.linalg import blas

    norms = np.array([blas.ddot(row, row) for row in x])
    middle = blas.dgemm(-2.0, x.T, x.T, trans_a=1).T
    sq = np.maximum(norms[:, None] + middle + norms[None, :], 0.0)
    radius = (float(np.float32(eps) * np.float32(eps)) if single
              else eps * eps)
    return [np.nonzero(row <= radius)[0] for row in sq]


def _dbscan_inner(core, hoods, labels):
    """sklearn's ``_dbscan_inner.pyx::dbscan_inner``, step for step."""
    label = 0
    for i in range(len(labels)):
        if labels[i] != -1 or not core[i]:
            continue
        stack = []
        while True:
            if labels[i] == -1:
                labels[i] = label
                if core[i]:
                    stack.extend(v for v in hoods[i] if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label += 1
    return labels


def dbscan_labels(points, eps, min_samples):
    """scikit-learn's ``DBSCAN(eps, min_samples).fit(points).labels_``
    (euclidean) without scikit-learn. Neighbourhoods are the points within
    ``distance <= eps``, the point itself included
    (``cKDTree.query_ball_point``, as sklearn's k-d tree compares squared
    distances with ``eps**2``); a point with at least ``min_samples`` is a
    core point. sklearn's ``dbscan_inner`` visits the points by index, starts
    a new label at each unlabeled core point and expands it depth-first
    through core points, so a cluster is a component of the core points'
    neighbour graph, numbered in the order of its lowest index, and a
    border point takes the lowest label among its core neighbours (the
    first cluster to reach it). ``min_samples=1`` gives connected
    components numbered by their lowest index. Up to 11 points sklearn's
    ``NearestNeighbors`` searches by brute force instead of its k-d tree
    (its default ``n_neighbors=5`` is then at least half the points), which
    rounds distances otherwise (:func:`_brute_neighbourhoods`) and not
    symmetrically, so there the search runs ``dbscan_inner`` itself
    (:func:`_dbscan_inner`)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    single = np.asarray(points).dtype == np.float32
    x = np.ascontiguousarray(points, dtype=np.float64)
    n = len(x)
    labels = -np.ones(n, dtype=np.intp)
    if n == 0:
        return labels
    if n <= 11:
        hoods = _brute_neighbourhoods(x, eps, single)
        core = np.array([len(h) >= min_samples for h in hoods])
        return _dbscan_inner(core, hoods, labels)
    hoods = cKDTree(x).query_ball_point(x, eps)
    sizes = np.fromiter(map(len, hoods), np.intp, n)
    core = sizes >= min_samples
    if not core.any():
        return labels
    rows = np.repeat(np.arange(n), sizes)
    cols = np.concatenate([np.asarray(h, np.intp) for h in hoods])
    both = core[rows] & core[cols]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8),
                        (rows[both], cols[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.nonzero(core)[0]
    # number the components by their lowest core index
    _, first = np.unique(comp[core_idx], return_index=True)
    number = np.empty(comp.max() + 1, np.intp)
    number[comp[core_idx[np.sort(first)]]] = np.arange(len(first))
    labels[core_idx] = number[comp[core_idx]]
    border = ~core[rows] & core[cols]
    if border.any():
        lowest = np.full(n, np.iinfo(np.intp).max)
        np.minimum.at(lowest, rows[border], labels[cols[border]])
        reached = lowest < np.iinfo(np.intp).max
        labels[reached] = lowest[reached]
    return labels


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
            labels = dbscan_labels(shell, eps, min_samples)
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
