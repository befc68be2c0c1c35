"""Stage 3: sphere-following QSM fitting engine.

Host-orchestrated state machine — the rebuild of reference
``QSMFittingDepthFirst.py:1096-2041``:

- :func:`cluster_points_priority` — min-heap sphere following with the
  moving-average priority ``alpha*spread + (1-alpha)*parent`` (:1096-1452);
- :func:`cylinder_proximity_segmentation` — points within ``eps_cylinder``
  of freshly fitted cylinders are segmented via the numpy mirror of the
  projection kernel (:1006-1094 used the GPU broadcast kernel; our
  per-iteration queries are a few hundred points x tens of cylinders,
  where a device round trip costs more than the whole computation);
- :func:`grow_cluster` — expanding-search-radius branch discovery +
  connection (:1522-1638);
- :func:`find_best_merge_connection` / :func:`connect_branch_to_main` /
  :func:`final_merge_clusters` — cluster graph merging (:899-1004,
  :1455-1519, :1642-1732);
- :func:`correct_cylinder_radii` — parent-relative radius clamping over the
  cylinder tree (:1735-1757), iterative instead of recursive;
- :func:`fit_qsm` — the driver with seed loop, stall detection, partial
  result export, cProfile dump, and per-tree debug logging (:1773-2041).

The inherently sequential control flow AND the small per-iteration
geometry stay on the host (it is CPU-bound in the reference too,
SURVEY.md §3.3). All randomness flows through one
``numpy.random.Generator`` so fits are reproducible (the reference uses
global ``random``/``np.random`` state).
"""

from __future__ import annotations

import cProfile
import io
import logging
import os
import pstats
import time

import numpy as np
from scipy.spatial import cKDTree

from .geometry import (
    compute_spread_of_points,
    dbscan_labels,
    find_seed_sphere,
    get_candidate_centers_and_spreads,
    initialize_first_sphere,
)
from ... import native
from .params import QSMParams
from .structures import (
    Cylinder,
    CylinderTracker,
    Sphere,
    SphereCluster,
    export_clusters_spheres_ply,
)

logger = logging.getLogger("treemorph_tpu_torch.qsm")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def cylinder_proximity_segmentation(
    points: np.ndarray,
    candidate_mask: np.ndarray,
    query_sphere: Sphere,
    cylinders: list[Cylinder],
    point_tree: cKDTree,
    eps: float,
) -> np.ndarray:
    """Unset mask bits for points within ``eps`` of the given cylinders.

    Host kernel: the numpy mirror of the projection tile
    (:func:`treemorph_tpu_torch.ops.projection.closest_cylinder_host`); only
    points near the query sphere (3x its radius, reference :1050) are
    tested. These queries are a few hundred points x tens of cylinders,
    thousands of times per fit, so they stay on the host: a device round
    trip per call would cost more than the computation.
    """
    from ...ops.projection import closest_cylinder_host

    if not cylinders:
        return candidate_mask.copy()
    local = point_tree.query_ball_point(
        query_sphere.center, query_sphere.radius * 3
    )
    if not local:
        return candidate_mask.copy()
    local = np.asarray(local, int)
    process = np.zeros_like(candidate_mask)
    process[local] = True
    process &= candidate_mask
    idx = np.nonzero(process)[0]
    if idx.size == 0:
        return candidate_mask.copy()

    _, dists, _ = closest_cylinder_host(
        points[idx, :3].astype(np.float32),
        np.array([c.start for c in cylinders], np.float32),
        np.array([c.end for c in cylinders], np.float32),
        np.array([c.radius for c in cylinders], np.float32),
    )
    out = candidate_mask.copy()
    out[idx[dists < eps]] = False
    return out


def find_neighborhood_points(
    unsegmented_mask: np.ndarray,
    sphere: Sphere,
    search_radius: float,
    point_tree: cKDTree,
) -> np.ndarray:
    """Unsegmented points within sphere.radius + search_radius (:792-824)."""
    if not unsegmented_mask.any():
        return np.array([], dtype=int)
    local = point_tree.query_ball_point(
        sphere.center, sphere.radius + search_radius
    )
    if not local:
        return np.array([], dtype=int)
    local = np.asarray(local, int)
    return local[unsegmented_mask[local]]


def _make_child_sphere(center, spread, lower, upper, params: QSMParams):
    capped = float(np.clip(spread, lower, upper))
    radius = min(
        max(capped * params.sphere_factor, params.radius_min),
        params.radius_max,
    )
    return Sphere(
        center,
        radius=radius,
        thickness=params.sphere_thickness,
        spread=capped,
        thickness_type=params.sphere_thickness_type,
    )


def cluster_points_priority(
    points: np.ndarray,
    sphere_id_start: int,
    initial_sphere: Sphere,
    segmentation_ids: np.ndarray,
    unsegmented_mask: np.ndarray,
    tracker: CylinderTracker,
    params: QSMParams,
    point_tree: cKDTree,
    rng: np.random.Generator,
    debug_log=None,
):
    """Priority-queue sphere following (reference :1096-1452).

    Returns (cluster, next_sphere_id, segmentation_ids, unsegmented_mask).
    """
    import heapq
    import itertools

    cluster = SphereCluster()
    cluster.add_sphere(initial_sphere)
    initial_sphere.assign_points(points, unsegmented_mask, point_tree)

    current_id = sphere_id_start
    segmentation_ids[initial_sphere.contained_points] = current_id
    failsafe_id = current_id

    if len(initial_sphere.contained_points) < params.min_growth_points:
        unsegmented_mask[initial_sphere.contained_points] = False
        return cluster, sphere_id_start, segmentation_ids, unsegmented_mask

    if params.segmentation_type == "sphere":
        unsegmented_mask &= segmentation_ids == -1

    pq = []
    tiebreak = itertools.count()
    initial_spread = initial_sphere.spread or 0.0
    heapq.heappush(pq, (-initial_spread, next(tiebreak), initial_sphere))
    grown = False

    # Index-based bookkeeping: the reference formulation materializes
    # several full-cloud boolean arrays per sphere pop (copy, ==, &,
    # sum) — at 1M+ points over thousands of pops that WAS the
    # dominant fit cost. ``unsegmented_mask`` is only mutated at the
    # END of a pop, so inside one it doubles as the reference's
    # ``available`` snapshot, and every set operation below works on
    # the small local index arrays instead. ``in_pop`` is a reusable
    # scratch mask marking this pop's assignments (reset by index).
    in_pop = np.zeros_like(unsegmented_mask)
    first_pop = True

    while pq:
        neg_priority, _, sphere = heapq.heappop(pq)
        parent_score = -neg_priority
        if debug_log:
            debug_log.info(
                "pop sphere center=%s r=%.3f spread=%s score=%.3f",
                sphere.center,
                sphere.radius,
                sphere.spread,
                parent_score,
            )

        available = unsegmented_mask
        candidates = get_candidate_centers_and_spreads(
            sphere,
            points,
            eps=params.eps,
            min_samples=params.min_samples,
            algorithm=params.clustering_algorithm,
            linkage=params.clustering_linkage,
            clustering_type=params.clustering_type,
            ransac_iterations=params.ransac_iterations,
            ransac_subset_percentage=params.ransac_subset_percentage,
            rng=rng,
        )
        if not candidates:
            sphere.is_outer = True
            if params.segmentation_type == "sphere":
                unsegmented_mask &= segmentation_ids == -1
            current_id += 1
            first_pop = False
            continue

        parent_spread = sphere.spread if sphere.spread is not None else 0.05
        lower = parent_spread * params.min_spread_growth
        upper = parent_spread * params.max_spread_growth
        made_child = False
        pop_idx: list[np.ndarray] = []  # this pop's newly-assigned rows

        centers = np.array([c for c, _ in candidates])
        spreads = np.array([s for _, s in candidates])
        if len(candidates) > 1 and params.merging_procedure != "none":
            # DBSCAN(min_samples=1) over the centers: connected components
            labels = dbscan_labels(
                centers, sphere.radius * params.merging_eps_factor, 1)
        else:
            labels = np.arange(len(candidates))

        for label in np.unique(labels):
            members = np.nonzero(labels == label)[0]
            child = None
            if len(members) == 1:
                center, spread = candidates[members[0]]
                child = _make_child_sphere(center, spread, lower, upper,
                                           params)
            else:
                child = _merge_candidate_group(
                    points,
                    centers[members],
                    spreads[members],
                    available,
                    lower,
                    upper,
                    params,
                    point_tree,
                )
            if child is None:
                continue

            child.assign_points(points, available, point_tree)
            cand = child.contained_points
            idx_new = cand[available[cand]] if cand.size else cand
            if idx_new.size < params.min_points_threshold:
                continue

            grown = True
            made_child = True
            segmentation_ids[idx_new] = current_id
            in_pop[idx_new] = True
            pop_idx.append(idx_new)
            cluster.add_sphere(child)
            tracker.add_cylinder(sphere, child, child.spread)

            child_spread = child.spread or 0.0
            score = (
                params.priority_alpha * child_spread
                + (1 - params.priority_alpha) * parent_score
            )
            heapq.heappush(pq, (-score, next(tiebreak), child))

        # segmentation update after processing all candidates (:1372-1422)
        # — index form of: assigned_now & available, the cylinder
        # proximity sweep over (available & ~new_by_sphere), and the
        # final unsegmented &= ~(new_by_sphere | removed_by_cyl)
        if first_pop:
            # the initial sphere's points carry this current_id too
            # (assigned before the loop) and are removed by the first
            # pop's update in the reference formulation
            init_idx = initial_sphere.contained_points
            if init_idx.size:
                init_live = init_idx[available[init_idx]]
                in_pop[init_live] = True
                pop_idx.append(init_live)
        if params.segmentation_type == "cylinder":
            removed_idx = None
            if made_child and tracker.recent_cylinders:
                cyls = tracker.recent_cylinders
                local = point_tree.query_ball_point(
                    sphere.center, sphere.radius * 3
                )
                if local:
                    local = np.asarray(local, int)
                    check = local[available[local] & ~in_pop[local]]
                    if check.size:
                        from ...ops.projection import closest_cylinder_host

                        _, dists, _ = closest_cylinder_host(
                            points[check, :3].astype(np.float32),
                            np.array([c.start for c in cyls], np.float32),
                            np.array([c.end for c in cyls], np.float32),
                            np.array([c.radius for c in cyls], np.float32),
                        )
                        removed_idx = check[dists < params.eps_cylinder]
                tracker.recent_cylinders = []
            for idx in pop_idx:
                unsegmented_mask[idx] = False
            if removed_idx is not None and removed_idx.size:
                unsegmented_mask[removed_idx] = False
        else:
            unsegmented_mask &= segmentation_ids == -1
        for idx in pop_idx:
            in_pop[idx] = False
        first_pop = False
        current_id += 1

    if not grown and params.segmentation_type == "cylinder":
        unsegmented_mask &= segmentation_ids != failsafe_id

    cluster.get_outer_spheres()
    return cluster, current_id, segmentation_ids, unsegmented_mask


def _merge_candidate_group(
    points, centers, spreads, available, lower, upper, params, point_tree
):
    """Merged sphere from a DBSCAN group of candidates (reference
    :1260-1311). Used only when merging_procedure != 'none'."""
    temp, weights = [], []
    if available.any():
        for center, spread in zip(centers, spreads):
            s = _make_child_sphere(center, spread, lower, upper, params)
            s.assign_points(points, available, point_tree)
            if len(s.contained_points) >= params.min_points_threshold:
                temp.append(s)
                weights.append(len(s.contained_points))
    if not temp:
        return None
    weights = np.asarray(weights, float)
    if len(temp) == 1:
        s = temp[0]
        capped = float(np.clip(s.spread, lower, upper))
        s.radius = min(
            max(capped * params.sphere_factor, params.radius_min),
            params.radius_max,
        )
        s.spread = capped
        s.assign_points(points, available, point_tree)
        return s

    centers_arr = np.array([s.center for s in temp])
    spreads_arr = np.array([s.spread for s in temp])
    merged_center = np.average(centers_arr, axis=0, weights=weights)
    merged_spread = float(np.average(spreads_arr, weights=weights))
    capped = float(np.clip(merged_spread, lower, upper))

    if params.merging_procedure == "weighted":
        n = len(centers_arr)
        dists = np.linalg.norm(
            centers_arr[:, None] - centers_arr[None], axis=2
        )
        i_idx, j_idx = np.triu_indices(n, k=1)
        pair_weights = weights[i_idx] + weights[j_idx]
        wavg = (
            np.average(dists[i_idx, j_idx], weights=pair_weights)
            if pair_weights.sum() > 0
            else 0.0
        )
        radius = max(
            capped * params.sphere_factor + 0.5 * wavg, params.radius_min
        )
    elif params.merging_procedure == "enclosed":
        radius = max(
            np.linalg.norm(merged_center - s.center) + s.radius for s in temp
        )
    elif params.merging_procedure == "subset":
        combined = np.unique(
            np.concatenate([s.contained_points for s in temp])
        )
        if len(combined):
            radius = float(
                np.linalg.norm(points[combined] - merged_center, axis=1).max()
            )
        else:
            radius = capped * params.sphere_factor
    else:
        radius = capped * params.sphere_factor

    radius = min(max(radius, params.radius_min), params.radius_max)
    return Sphere(
        merged_center,
        radius=radius,
        thickness=params.sphere_thickness,
        spread=capped,
        thickness_type=params.sphere_thickness_type,
    )


def find_best_merge_connection(
    outer_main: list[Sphere],
    outer_branch: list[Sphere],
    angle_threshold_degrees: float = 45,
    max_dist: float = 0.3,
    distance_type: str = "effective",
):
    """Best (main, branch) sphere pair to bridge two clusters (:899-1004)."""
    if not outer_main or not outer_branch:
        return None
    centers_main = np.array([s.center for s in outer_main])
    centers_branch = np.array([s.center for s in outer_branch])
    dists = np.linalg.norm(
        centers_main[:, None] - centers_branch[None], axis=2
    )
    if distance_type == "effective":
        radii_main = np.array([s.radius for s in outer_main])
        radii_branch = np.array([s.radius for s in outer_branch])
        dists = np.maximum(
            dists - (radii_main[:, None] + radii_branch[None]), 0.0
        )

    pi, pj = np.nonzero(dists < max_dist)
    if pi.size == 0:
        return None

    # vectorized over candidate pairs (the reference walks them in a
    # python loop; at tens of thousands of calls per fit the per-pair
    # numpy overhead dominated the merge phase) — selection semantics
    # identical: first strictly-smallest distance in row-major order
    conn = centers_main[pi] - centers_branch[pj]  # (P, 3)
    norms = np.linalg.norm(conn, axis=1)
    has_main = np.array(
        [bool(s.connection_vectors) for s in outer_main], bool
    )
    has_branch = np.array(
        [bool(s.connection_vectors) for s in outer_branch], bool
    )
    valid = (norms >= 1e-9) & (has_main[pi] | has_branch[pj])
    if not valid.any():
        return None
    # average vectors only for spheres actually appearing in a valid
    # pair (computing them for every outer sphere per call regressed
    # the merge phase)
    avg_main = np.zeros((len(outer_main), 3))
    for i in np.unique(pi[valid]):
        avg_main[i] = outer_main[i].average_connection_vector()
    avg_branch = np.zeros((len(outer_branch), 3))
    for j in np.unique(pj[valid]):
        avg_branch[j] = outer_branch[j].average_connection_vector()
    conn_unit = conn / np.maximum(norms, 1e-12)[:, None]
    # Branch's average connection vector points INTO the branch; invert.
    branch_avg = -avg_branch[pj]
    use_main = np.linalg.norm(branch_avg, axis=1) < 1e-9
    branch_avg = np.where(use_main[:, None], avg_main[pi], branch_avg)
    degenerate = np.linalg.norm(branch_avg, axis=1) < 1e-9
    cosang = np.clip(np.sum(branch_avg * conn_unit, axis=1), -1, 1)
    angle = np.degrees(np.arccos(cosang))
    angle = np.where(degenerate, 0.0, angle)
    valid &= angle < angle_threshold_degrees
    if not valid.any():
        return None
    d = dists[pi, pj]
    cand = np.nonzero(valid)[0]
    k = cand[np.argmin(d[cand])]
    return (int(pi[k]), int(pj[k]), float(d[k]), float(angle[k]))


def connect_branch_to_main(
    queried_sphere: Sphere,
    stem_cluster: SphereCluster,
    branch_clusters: list[SphereCluster],
    segmentation_ids: np.ndarray,
    tracker: CylinderTracker,
    params: QSMParams,
    rng: np.random.Generator,
):
    """Bridge freshly grown branch clusters onto one outer sphere
    (:1455-1519)."""
    connected = []
    order = list(branch_clusters)
    rng.shuffle(order)
    for branch in order:
        branch.get_outer_spheres()
        tracker.reset_reassigned_flags(branch)
        if not branch.outer_spheres:
            continue
        result = find_best_merge_connection(
            [queried_sphere],
            branch.outer_spheres,
            angle_threshold_degrees=params.max_angle,
            max_dist=params.max_dist,
            distance_type=params.distance_type,
        )
        if result is None:
            continue
        _, i_branch, _, _ = result
        s_branch = branch.outer_spheres[i_branch]
        spread_a = queried_sphere.spread or 0.05
        spread_b = s_branch.spread or 0.05
        conn_id = tracker.add_cylinder(
            queried_sphere,
            s_branch,
            float(np.mean([spread_a, spread_b])),
            cyl_type="connection",
        )
        tracker.reassign_parent(conn_id, s_branch)
        if len(s_branch.connected_cylinder_ids) > 1:
            s_branch.is_outer = False
        if s_branch.is_seed:
            s_branch.is_seed = False
            s_branch.first_cylinder_id = conn_id
        for sphere in branch.spheres:
            sphere.is_seed = False
            segmentation_ids[sphere.contained_points] = 0
            stem_cluster.add_sphere(sphere)
        connected.append(branch)
    stem_cluster.get_outer_spheres()
    return connected


def grow_cluster(
    points: np.ndarray,
    sphere_id_start: int,
    initial_sphere: Sphere,
    segmentation_ids: np.ndarray,
    unsegmented_mask: np.ndarray,
    tracker: CylinderTracker,
    params: QSMParams,
    clusters: list,
    point_tree: cKDTree,
    rng: np.random.Generator,
    debug_log=None,
):
    """Grow the main cluster, then sweep expanding search radii for nearby
    branches and connect them (reference :1522-1638)."""
    main_cluster, next_id, segmentation_ids, unsegmented_mask = (
        cluster_points_priority(
            points,
            sphere_id_start,
            initial_sphere,
            segmentation_ids,
            unsegmented_mask,
            tracker,
            params,
            point_tree,
            rng,
            debug_log,
        )
    )
    if not main_cluster.spheres:
        return next_id, segmentation_ids, unsegmented_mask

    search_radius = params.smallest_search_radius
    while search_radius <= params.max_search_radius:
        outer = list(main_cluster.get_outer_spheres())
        rng.shuffle(outer)
        new_clusters = []
        processed = set()
        for outer_sphere in outer:
            if id(outer_sphere) in processed or not outer_sphere.is_outer:
                continue
            neighborhood = find_neighborhood_points(
                unsegmented_mask, outer_sphere, search_radius, point_tree
            )
            while len(neighborhood) >= params.min_growth_points:
                seed = find_seed_sphere(
                    points,
                    neighborhood,
                    params.sphere_radius,
                    params.sphere_thickness,
                    sphere_thickness_type=params.sphere_thickness_type,
                    rng=rng,
                )
                seed.assign_points(points, unsegmented_mask, point_tree)
                if len(seed.contained_points) < params.min_growth_points:
                    if seed.contained_points.size:
                        unsegmented_mask[seed.contained_points] = False
                    neighborhood = np.setdiff1d(
                        neighborhood,
                        seed.contained_points.astype(int),
                        assume_unique=True,
                    )
                    continue
                seed.spread = compute_spread_of_points(
                    points[seed.contained_points]
                )
                branch, next_id, segmentation_ids, unsegmented_mask = (
                    cluster_points_priority(
                        points,
                        next_id,
                        seed,
                        segmentation_ids,
                        unsegmented_mask,
                        tracker,
                        params,
                        point_tree,
                        rng,
                        debug_log,
                    )
                )
                if branch.spheres:
                    new_clusters.append(branch)
                neighborhood = find_neighborhood_points(
                    unsegmented_mask, outer_sphere, search_radius, point_tree
                )

            connected = connect_branch_to_main(
                outer_sphere,
                main_cluster,
                new_clusters,
                segmentation_ids,
                tracker,
                params,
                rng,
            )
            new_clusters = [c for c in new_clusters if c not in connected]
            processed.add(id(outer_sphere))
            if connected:
                outer_sphere.is_outer = False

        clusters.extend(new_clusters)
        search_radius += params.search_radius_step
        if not unsegmented_mask.any():
            break

    clusters.append(main_cluster)
    return next_id, segmentation_ids, unsegmented_mask


def final_merge_clusters(
    clusters: list[SphereCluster],
    tracker: CylinderTracker,
    segmentation_ids: np.ndarray,
    params: QSMParams,
):
    """Merge remaining clusters by outer-sphere proximity (:1642-1732)."""
    merged = set()
    sizes = [len(c.spheres) for c in clusters]
    for i in np.argsort(sizes)[::-1]:
        if i in merged:
            continue
        main = clusters[i]
        if len(main.spheres) == 1:
            continue
        tracker.reset_reassigned_flags(main)
        frontier = main.get_outer_spheres()
        while frontier:
            current = frontier
            frontier = []
            for j in range(len(clusters)):
                if j == i or j in merged:
                    continue
                candidate = clusters[j]
                tracker.reset_reassigned_flags(candidate)
                cand_outer = candidate.get_outer_spheres()
                result = find_best_merge_connection(
                    current,
                    cand_outer,
                    angle_threshold_degrees=params.max_angle,
                    max_dist=params.max_dist,
                    distance_type=params.distance_type,
                )
                if result is None:
                    continue
                i_main, i_branch, _, _ = result
                s1, s2 = current[i_main], cand_outer[i_branch]
                conn_id = tracker.add_cylinder(
                    s1,
                    s2,
                    float(np.mean([s1.spread or 0.05, s2.spread or 0.05])),
                    cyl_type="connection",
                )
                tracker.reassign_parent(conn_id, s2)
                for sphere in candidate.spheres:
                    segmentation_ids[sphere.contained_points] = 0
                    sphere.is_seed = False
                s1.is_outer = False
                if len(s2.connected_cylinder_ids) > 1:
                    s2.is_outer = False
                main.add_spheres(candidate.spheres)
                merged.add(j)
                frontier.extend(candidate.get_outer_spheres())
    remaining = [c for k, c in enumerate(clusters) if k not in merged]
    return remaining, segmentation_ids


def correct_cylinder_radii(tracker: CylinderTracker, params: QSMParams):
    """Clamp child radii relative to their parent over the cylinder tree
    (:1735-1757), iteratively."""
    roots = [
        c
        for c in tracker.cylinders.values()
        if c.parent_cylinder_id is None
    ]
    stack = list(roots)
    visited = set()
    while stack:
        parent = stack.pop()
        if parent.id in visited:
            continue
        visited.add(parent.id)
        for child_id in parent.child_cylinder_ids:
            child = tracker.cylinders[child_id]
            if (
                not params.only_correct_connections
                or child.cyl_type == "connection"
            ):
                new_radius = float(
                    np.clip(
                        child.radius,
                        parent.radius * params.min_spread_growth,
                        parent.radius * params.max_spread_growth,
                    )
                )
                if child.radius != new_radius:
                    child.radius = new_radius
                    child.volume = np.pi * new_radius**2 * child.length
            stack.append(child)


def fit_qsm(
    cloud_data: np.ndarray,
    params: QSMParams | dict | None = None,
    output_base: str | None = None,
    save_csv: bool = True,
    save_cyl_ply: bool = False,
    save_sphere_ply: bool = False,
    verbose: bool = False,
    debug_log_path: str | None = None,
    profile: bool = False,
):
    """Fit a cylinder skeleton to a refined cloud (reference :1773-2041).

    Returns (cylinder :class:`Table`, tracker, clusters, segmentation_ids), and
    optionally writes ``{output_base}_cylinders.csv`` / ``.ply`` /
    ``_spheres.ply``.
    """
    if params is None:
        params = QSMParams()
    elif isinstance(params, dict):
        params = QSMParams.from_dict(params)
    rng = np.random.default_rng(params.seed)

    if cloud_data is None or len(cloud_data) < 10:
        logger.warning("fit_qsm: insufficient points, skipping")
        return None, None, [], None

    debug_log = None
    if debug_log_path:
        debug_log = logging.getLogger(f"qsm.{os.path.basename(debug_log_path)}")
        debug_log.setLevel(logging.INFO)
        if not debug_log.handlers:
            handler = logging.FileHandler(debug_log_path)
            handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            debug_log.addHandler(handler)

    profiler = None
    if profile:
        profiler = cProfile.Profile()
        profiler.enable()

    # build the C++ core before the fit's error isolation below, so a
    # library that does not build raises instead of a partial export
    native.load()

    t0 = time.time()
    points = np.asarray(cloud_data, np.float64)[:, :3]
    num_points = len(points)
    segmentation_ids = -np.ones(num_points, dtype=int)
    unsegmented_mask = np.ones(num_points, dtype=bool)
    clusters: list[SphereCluster] = []
    tracker = CylinderTracker()
    point_tree = cKDTree(points)
    current_id = 0
    last_count = num_points

    try:
        initial = initialize_first_sphere(
            points,
            slice_height=0.2,
            sphere_thickness=params.sphere_thickness,
            sphere_thickness_type=params.sphere_thickness_type,
            rng=rng,
        )
        current_id, segmentation_ids, unsegmented_mask = grow_cluster(
            points,
            current_id,
            initial,
            segmentation_ids,
            unsegmented_mask,
            tracker,
            params,
            clusters,
            point_tree,
            rng,
            debug_log,
        )
        last_count = unsegmented_mask.sum()

        # seed loop over leftover regions with stall detection (:1874-1937)
        while unsegmented_mask.sum() > params.min_points_absolute_stop:
            seeds = np.nonzero(unsegmented_mask)[0]
            if seeds.size == 0:
                break
            try:
                seed = find_seed_sphere(
                    points,
                    seeds,
                    params.sphere_radius,
                    params.sphere_thickness,
                    sphere_thickness_type=params.sphere_thickness_type,
                    rng=rng,
                )
            except ValueError:
                break
            seed.assign_points(points, unsegmented_mask, point_tree)
            if len(seed.contained_points) < params.min_growth_points:
                segmentation_ids[seed.contained_points] = -2
                if seed.contained_points.size:
                    unsegmented_mask[seed.contained_points] = False
                count = unsegmented_mask.sum()
                if count == last_count:
                    logger.warning("fit_qsm: stalled finding seeds, stopping")
                    break
                last_count = count
                continue
            seed.spread = compute_spread_of_points(
                points[seed.contained_points]
            )
            current_id, segmentation_ids, unsegmented_mask = grow_cluster(
                points,
                current_id,
                seed,
                segmentation_ids,
                unsegmented_mask,
                tracker,
                params,
                clusters,
                point_tree,
                rng,
                debug_log,
            )
            count = unsegmented_mask.sum()
            if count == last_count:
                segmentation_ids[unsegmented_mask] = -2
                logger.warning("fit_qsm: stalled clustering, stopping")
                break
            last_count = count
    except ValueError as e:
        logger.warning("fit_qsm: clustering error (%s); exporting partial", e)
    except Exception:
        logger.exception("fit_qsm: unexpected clustering error; partial")

    if clusters:
        try:
            clusters, segmentation_ids = final_merge_clusters(
                clusters, tracker, segmentation_ids, params
            )
        except Exception:
            logger.exception("fit_qsm: merge failed; skipping")
    if tracker.cylinders:
        try:
            correct_cylinder_radii(tracker, params)
        except Exception:
            logger.exception("fit_qsm: radius correction failed; skipping")

    df = tracker.export_table()
    if output_base is not None:
        os.makedirs(os.path.dirname(output_base) or ".", exist_ok=True)
        if save_csv and len(df):
            df.to_csv(f"{output_base}_cylinders.csv")
        if save_cyl_ply and tracker.cylinders:
            tracker.export_mesh_ply(
                f"{output_base}_cylinders.ply",
                resolution=10,
                color_by_root=True,
            )
        if save_sphere_ply and clusters:
            export_clusters_spheres_ply(
                clusters,
                f"{output_base}_spheres.ply",
                resolution=8,
                color_by_outer=True,
            )

    if profiler is not None:
        profiler.disable()
        s = io.StringIO()
        pstats.Stats(profiler, stream=s).sort_stats("cumulative").print_stats(
            50
        )
        (debug_log or logger).info("QSM profile:\n%s", s.getvalue())

    if verbose:
        print(
            f"fit_qsm: {len(tracker.cylinders)} cylinders in "
            f"{len(clusters)} clusters ({time.time() - t0:.1f}s)"
        )
    return df, tracker, clusters, segmentation_ids
