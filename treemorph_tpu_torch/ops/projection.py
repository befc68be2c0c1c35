"""Host cylinder projection of the QSM stage.

The port keeps only :func:`closest_cylinder_host`, the numpy mirror of
``treemorph_tpu/ops/projection.py``'s projection tile that the QSM engine
queries per sphere; the device projection of labeling and evaluation is
not part of the port yet.
"""

from __future__ import annotations

import numpy as np

PERP_ATOL = 1e-3
NORM_EPS = 1e-8


def closest_cylinder_host(
    points: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    radius: np.ndarray,
    move_to_mantle: bool = True,
):
    """Nearest cylinder surface of each point.

    The QSM engine queries a few hundred points against tens of
    cylinders thousands of times per fit, so this stays on the host.

    Returns (ids, distances, offsets) with ids indexing the input rows.
    """
    p = points[:, None, :].astype(np.float32)  # (N, 1, 3)
    s = start[None, :, :].astype(np.float32)
    axis = (end - start).astype(np.float32)
    length = np.linalg.norm(axis, axis=1)
    u = (axis / np.maximum(length, NORM_EPS)[:, None])[None, :, :]
    ln = length[None, :, None]
    r = radius.astype(np.float32)[None, :, None]

    t = np.clip(np.sum((p - s) * u, axis=2, keepdims=True), 0.0, ln)
    q = s + t * u
    w = p - q
    w_dot_u = np.sum(w * u, axis=2, keepdims=True)
    perpendicular = np.abs(w_dot_u) <= PERP_ATOL
    rejected = w - w_dot_u * u
    rej_norm = np.linalg.norm(rejected, axis=2, keepdims=True)
    n = rejected / np.maximum(rej_norm, NORM_EPS)

    mantle_point = q + n * r
    disc_point = q + np.minimum(rej_norm, r) * n
    surface_point = np.where(perpendicular, mantle_point, disc_point)
    dist = np.linalg.norm(
        points[:, None, :].astype(np.float32) - surface_point, axis=2
    )
    best = np.argmin(dist, axis=1)
    rows = np.arange(len(points))
    best_dist = dist[rows, best]

    if move_to_mantle:
        s_axis = np.minimum(rej_norm, r) + r
        closer_to_start = s_axis < (2 * r - s_axis)
        rim_point = np.where(closer_to_start, q - r * n, q + r * n)
        final_point = np.where(perpendicular, mantle_point, rim_point)
    else:
        final_point = surface_point
    offsets = final_point[rows, best] - points[:, :3].astype(np.float32)
    return best.astype(np.int32), best_dist, offsets
