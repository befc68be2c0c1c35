"""Point -> nearest-cylinder projection: labeling and the QSM stage.

Port of ``treemorph_tpu/ops/projection.py`` (reference
``Modules/Projection.py``), the geometry that turns a cloud and its QSM
into offset labels. For every point p and cylinder (start s, unit axis u,
length L, radius r):

1. project p onto the axis segment, ``t = clamp(dot(p - s, u), 0, L)``,
   axis point ``q = s + t u``;
2. split ``w = p - q`` into its part along u and the rejection; the point
   is beside the mantle ("perpendicular") when ``|w.u| <= PERP_ATOL``;
3. beside the mantle, the closest surface point is ``q + r n`` with
   ``n = rejection / max(|rejection|, NORM_EPS)``; beyond a cap, it is the
   cap disc's ``q + min(|rejection|, r) n``;
4. the distance to it ranks the cylinders (padding never wins, the first
   minimum is taken);
5. with ``move_to_mantle`` (labeling's default) cap-case points snap to the
   rim ``q +- r n``, so offset labels land on the mantle.

:func:`closest_cylinder` evaluates the (N, M) broadcast in point tiles
(default 4096) on the points' device, in float32, with the JAX tile's
formulas and case splits; :func:`generate_offset_cloud` labels a cloud
against a QSM table on the CUDA device unless told otherwise.
:func:`closest_cylinder_host` is the numpy mirror the QSM engine queries
per sphere (a few hundred points against tens of cylinders, thousands of
times a fit), where a device round trip per query would cost more than
the work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

# Column-name candidates accepted for QSM CSV tables, in preference order
# (reference Modules/Projection.py:287-297).
QSM_COLUMN_MAPPINGS = {
    "startX": ["startX", "start.x", "start_x"],
    "startY": ["startY", "start.y", "start_y"],
    "startZ": ["startZ", "start.z", "start_z"],
    "endX": ["endX", "end.x", "end_x"],
    "endY": ["endY", "end.y", "end_y"],
    "endZ": ["endZ", "end.z", "end_z"],
    "radius": ["radius", "Radius"],
    "ID": ["ID", "extension", "id"],
}

PERP_ATOL = 1e-3
NORM_EPS = 1e-8


class Cylinders(NamedTuple):
    """Structure-of-arrays cylinder set, optionally padded; ``valid`` masks
    out padding, which never wins the argmin."""

    start: torch.Tensor  # (M, 3) float32
    axis_unit: torch.Tensor  # (M, 3) float32
    axis_length: torch.Tensor  # (M,) float32
    radius: torch.Tensor  # (M,) float32
    ids: torch.Tensor  # (M,) int32
    valid: torch.Tensor  # (M,) bool


def make_cylinders(start, end, radius, ids=None, pad_to: int | None = None,
                   device="cpu") -> Cylinders:
    """A :class:`Cylinders` from start / end / radius arrays, built on the
    host as the JAX package builds it, then moved to ``device``."""
    start = np.asarray(start, dtype=np.float32)
    end = np.asarray(end, dtype=np.float32)
    radius = np.asarray(radius, dtype=np.float32)
    m = start.shape[0]
    if ids is None:
        ids = np.arange(m, dtype=np.int32)
    ids = np.asarray(ids, dtype=np.int32)

    axis = end - start
    length = np.linalg.norm(axis, axis=1)
    # zero-length axes get a safe unit (reference Projection.py:129-132)
    unit = axis / np.maximum(length, NORM_EPS)[:, None]

    valid = np.ones(m, dtype=bool)
    if pad_to is not None and pad_to > m:
        pad = pad_to - m
        start = np.concatenate([start, np.zeros((pad, 3), np.float32)])
        unit = np.concatenate(
            [unit, np.tile(np.array([[0, 0, 1]], np.float32), (pad, 1))])
        length = np.concatenate([length, np.zeros(pad, np.float32)])
        radius = np.concatenate([radius, np.zeros(pad, np.float32)])
        ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return Cylinders(start=t(start), axis_unit=t(unit),
                     axis_length=t(length.astype(np.float32)),
                     radius=t(radius), ids=t(ids), valid=t(valid))


def cylinders_from_table(table, pad_to: int | None = None,
                         device="cpu") -> Cylinders:
    """Cylinders of a QSM table (:class:`~treemorph_tpu_torch.utils.table.
    Table`, or any mapping with ``columns``), resolving the column-name
    variants of :data:`QSM_COLUMN_MAPPINGS`."""
    cols = {}
    available = list(table.columns)
    for internal, candidates in QSM_COLUMN_MAPPINGS.items():
        found = next((c for c in candidates if c in available), None)
        if found is None:
            raise KeyError(
                f"QSM table missing field {internal!r}; tried {candidates}, "
                f"available: {available}")
        cols[internal] = np.asarray(table[found])
    return make_cylinders(
        start=np.stack([cols["startX"], cols["startY"], cols["startZ"]], 1),
        end=np.stack([cols["endX"], cols["endY"], cols["endZ"]], 1),
        radius=cols["radius"],
        ids=cols["ID"].astype(np.int32),
        pad_to=pad_to,
        device=device,
    )


def _sum3(x):
    return x[..., 0:1] + x[..., 1:2] + x[..., 2:3]


def _project_tile(points: torch.Tensor, cyl: Cylinders,
                  move_to_mantle: bool):
    """The (n, M) broadcast of one tile: (ids, distances, offsets)."""
    p = points[:, None, :]  # (n, 1, 3)
    s = cyl.start[None]  # (1, M, 3)
    u = cyl.axis_unit[None]
    length = cyl.axis_length[None, :, None]  # (1, M, 1)
    r = cyl.radius[None, :, None]

    t = _sum3((p - s) * u)  # (n, M, 1)
    t = torch.minimum(t.clamp_min(0.0), length)
    q = s + t * u  # clamped axis point

    w = p - q
    w_dot_u = _sum3(w * u)
    perpendicular = w_dot_u.abs() <= PERP_ATOL

    rejected = w - w_dot_u * u
    rej_norm = torch.sqrt(_sum3(rejected * rejected))
    n = rejected / rej_norm.clamp_min(NORM_EPS)

    mantle_point = q + n * r  # radial projection onto the mantle
    disc_point = q + torch.minimum(rej_norm, r) * n  # nearest cap-disc point
    surface_point = torch.where(perpendicular, mantle_point, disc_point)

    diff = p - surface_point
    dist = torch.sqrt(_sum3(diff * diff))[..., 0]  # (n, M)
    dist = torch.where(cyl.valid[None], dist,
                       torch.full_like(dist, float("inf")))

    best = dist.argmin(dim=1)  # first minimum
    row = torch.arange(len(points), device=points.device)
    best_dist = dist[row, best]
    if move_to_mantle:
        q_b, n_b, r_b = q[row, best], n[row, best], r[0, best]
        # cap-case points snap to the rim q +- r n, the nearer end of the
        # diameter segment (the reference's strict '<',
        # Projection.py:100: the far end unless |rejection| < 0)
        s_axis = torch.minimum(rej_norm[row, best], r_b) + r_b
        closer_to_start = s_axis < (2 * r_b - s_axis)
        rim_point = torch.where(closer_to_start, q_b - r_b * n_b,
                                q_b + r_b * n_b)
        final_point = torch.where(perpendicular[row, best],
                                  mantle_point[row, best], rim_point)
    else:
        final_point = surface_point[row, best]
    return cyl.ids[best], best_dist, final_point - points


def closest_cylinder(points: torch.Tensor, cyl: Cylinders,
                     move_to_mantle: bool = True, tile: int = 4096):
    """Nearest cylinder of every point (N, 3), in point tiles of ``tile``
    on the points' device: ids (N,) int32, distances (N,) float32, offsets
    to the surface point (N, 3) float32."""
    points = points.float()
    ids, dists, offs = [], [], []
    for p0 in range(0, len(points), tile):
        i, d, o = _project_tile(points[p0:p0 + tile], cyl, move_to_mantle)
        ids.append(i)
        dists.append(d)
        offs.append(o)
    if not ids:
        return (torch.zeros(0, dtype=torch.int32, device=points.device),
                torch.zeros(0, device=points.device),
                torch.zeros((0, 3), device=points.device))
    return torch.cat(ids), torch.cat(dists), torch.cat(offs)


def generate_offset_cloud(cloud, cylinders_table, tile: int = 4096,
                          device=None) -> np.ndarray:
    """Label a cloud against a QSM table: the (N, 7) offset-cloud layout
    (xyz, offset to the nearest cylinder surface, cylinder id), computed on
    ``device`` (the CUDA device unless named; raises without one)."""
    device = resolve_device(device)
    cyl = cylinders_from_table(cylinders_table, device=device)
    pts = np.ascontiguousarray(np.asarray(cloud)[:, :3], dtype=np.float32)
    ids, _, offsets = closest_cylinder(torch.from_numpy(pts).to(device), cyl,
                                       tile=tile)
    out = np.zeros((len(pts), 7), dtype=np.float32)
    out[:, :3] = pts
    out[:, 3:6] = offsets.cpu().numpy()
    out[:, 6] = ids.cpu().numpy()
    return out


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
