"""Synthetic fixtures: procedural QSMs and point clouds with known ground truth.

The reference verifies behavior with a procedural noisy cylinder
(``ModelTestingScripts/SanityCheckPointNet2.py:23-55``) and generates training
noise clouds by sampling QSM cylinder mantles
(``PreProcessing/NoiseDataGeneration.py:14-106``). These generators
industrialize both patterns so that every layer of the framework is testable
without the (absent) forest dataset: a synthetic QSM gives exact cylinders,
the sampled cloud gives exact per-point offsets, and the whole stack
(label generation -> training -> pipeline -> QSM fit) can be round-tripped.

All generators are host-side numpy with explicit ``rng`` for reproducibility.
"""

from __future__ import annotations

import numpy as np

from ..utils.table import Table


def _rotation_from_z(axis_unit: np.ndarray) -> np.ndarray:
    """Per-row rotation matrices mapping local +z onto ``axis_unit``.

    Rodrigues formula (as in reference
    ``PreProcessing/NoiseDataGeneration.py:78-97``), but with the degenerate
    aligned/anti-aligned cases handled exactly: the reference substitutes an
    arbitrary vector for v when sin(theta)=0, which shears exactly-vertical
    cylinders; here those rows get the exact identity / 180-degree rotation.
    """
    z_axis = np.array([0.0, 0.0, 1.0])
    v = np.cross(np.broadcast_to(z_axis, axis_unit.shape), axis_unit)
    s = np.linalg.norm(v, axis=1)
    c = axis_unit @ z_axis

    vx = np.zeros((len(axis_unit), 3, 3))
    vx[:, 0, 1], vx[:, 0, 2] = -v[:, 2], v[:, 1]
    vx[:, 1, 0], vx[:, 1, 2] = v[:, 2], -v[:, 0]
    vx[:, 2, 0], vx[:, 2, 1] = -v[:, 1], v[:, 0]
    eye = np.eye(3)[None]
    rot = eye + vx + np.einsum("nij,njk->nik", vx, vx) * (
        (1 - c) / (s**2 + 1e-8)
    )[:, None, None]

    degenerate = s < 1e-8
    rot[degenerate & (c > 0)] = np.eye(3)
    rot[degenerate & (c <= 0)] = np.diag([1.0, -1.0, -1.0])
    return rot


QSM_COLUMNS = [
    "ID",
    "startX",
    "startY",
    "startZ",
    "endX",
    "endY",
    "endZ",
    "radius",
    "parentID",
    "BranchOrder",
]


def synthetic_cylinder_cloud(
    n_points: int = 10000,
    radius: float = 0.1,
    height: float = 5.0,
    noise_scale: float = 0.02,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Noisy vertical cylinder with exact ground-truth offsets.

    Matches the reference sanity-check fixture
    (``SanityCheckPointNet2.py:23-55``): points sampled on a vertical cylinder
    mantle with Gaussian radial noise; the offset label moves each point back
    to the perfect surface. Returns the labeled ``(N, 11)`` format
    (features zeroed except the relative-height column).
    """
    rng = rng or np.random.default_rng(0)
    angles = rng.uniform(0.0, 2 * np.pi, size=n_points)
    heights = rng.uniform(0.0, height, size=n_points)
    radii = radius + rng.normal(0.0, noise_scale, size=n_points)

    coords = np.stack(
        [radii * np.cos(angles), radii * np.sin(angles), heights], axis=1
    )
    offsets = np.stack(
        [
            (radius - radii) * np.cos(angles),
            (radius - radii) * np.sin(angles),
            np.zeros(n_points),
        ],
        axis=1,
    )
    cyl_id = np.zeros((n_points, 1))
    feats = np.zeros((n_points, 4))
    feats[:, 3] = heights / height  # relative height feature
    return np.concatenate([coords, offsets, cyl_id, feats], axis=1).astype(
        np.float32
    )


def synthetic_qsm(
    n_branches: int = 6,
    stem_height: float = 8.0,
    stem_radius: float = 0.25,
    n_stem_segments: int = 8,
    rng: np.random.Generator | None = None,
) -> Table:
    """Procedural tree QSM: a tapering vertical stem with angled branches.

    Produces a cylinder table in the reference QSM CSV schema
    (columns per ``Modules/Projection.py:287-297``): start/end coordinates,
    radius, ID, parentID, BranchOrder (0 = stem).
    """
    rng = rng or np.random.default_rng(0)
    rows = []
    seg_h = stem_height / n_stem_segments
    next_id = 0
    stem_ids = []
    for i in range(n_stem_segments):
        z0, z1 = i * seg_h, (i + 1) * seg_h
        taper = 1.0 - 0.7 * (i / max(n_stem_segments - 1, 1))
        rows.append(
            dict(
                ID=next_id,
                startX=0.0,
                startY=0.0,
                startZ=z0,
                endX=0.0,
                endY=0.0,
                endZ=z1,
                radius=stem_radius * taper,
                parentID=next_id - 1 if i > 0 else -1,
                BranchOrder=0,
            )
        )
        stem_ids.append(next_id)
        next_id += 1

    for _ in range(n_branches):
        seg = int(rng.integers(n_stem_segments // 3, n_stem_segments))
        z_base = (seg + 0.5) * seg_h
        azimuth = rng.uniform(0, 2 * np.pi)
        elevation = rng.uniform(np.pi / 6, np.pi / 3)
        length = rng.uniform(0.8, 2.0)
        direction = np.array(
            [
                np.cos(azimuth) * np.cos(elevation),
                np.sin(azimuth) * np.cos(elevation),
                np.sin(elevation),
            ]
        )
        start = np.array([0.0, 0.0, z_base])
        end = start + direction * length
        rows.append(
            dict(
                ID=next_id,
                startX=start[0],
                startY=start[1],
                startZ=start[2],
                endX=end[0],
                endY=end[1],
                endZ=end[2],
                radius=stem_radius * 0.3,
                parentID=stem_ids[seg],
                BranchOrder=1,
            )
        )
        next_id += 1

    return Table.from_records(rows, columns=QSM_COLUMNS)


def qsm_noise_cloud(
    qsm: Table,
    density: float = 50.0,
    lognormal_mean: float = -3.0,
    lognormal_sigma: float = 0.85,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sample a synthetic noisy cloud on the mantles of a QSM's cylinders.

    Behavioral parity with reference noise generation
    (``PreProcessing/NoiseDataGeneration.py:14-106``): per-cylinder point
    count proportional to mantle area with height-dependent density falloff
    ``1 - (3/4) h_rel^0.33``, lognormal(-3, 0.85) radial noise, rotation from
    the local +z frame to the cylinder axis via the Rodrigues formula.
    Returns ``(N, 3)`` world-frame points.
    """
    rng = rng or np.random.default_rng(0)
    start = qsm.to_numpy(["startX", "startY", "startZ"])
    end = qsm.to_numpy(["endX", "endY", "endZ"])
    radius = np.asarray(qsm["radius"], np.float64)

    axis = end - start
    axis_length = np.linalg.norm(axis, axis=1)
    axis_unit = axis / np.maximum(axis_length, 1e-12)[:, None]

    z_min = np.minimum(start[:, 2], end[:, 2]).min()
    z_max = np.maximum(start[:, 2], end[:, 2]).max()
    tree_height = max(z_max - z_min, 1e-12)
    rel_height = ((start[:, 2] + end[:, 2]) / 2 - z_min) / tree_height

    adjusted_density = density * (1 - 0.75 * np.clip(rel_height, 0, 1) ** 0.33)
    n_angular = (2 * np.pi * radius * adjusted_density).astype(int)
    n_axial = (axis_length * adjusted_density).astype(int)
    counts = n_angular * n_axial
    cyl_ids = np.repeat(np.arange(len(qsm)), counts)

    theta = rng.uniform(0, 2 * np.pi, size=cyl_ids.shape)
    z = rng.uniform(0, axis_length[cyl_ids])
    r_noisy = radius[cyl_ids] + rng.lognormal(
        lognormal_mean, lognormal_sigma, size=cyl_ids.shape
    )
    local = np.stack(
        [r_noisy * np.cos(theta), r_noisy * np.sin(theta), z], axis=1
    )

    rot = _rotation_from_z(axis_unit)
    world = np.einsum("nij,nj->ni", rot[cyl_ids], local) + start[cyl_ids]
    return world.astype(np.float32)


def synthetic_tree_cloud(
    qsm: Table | None = None,
    points_per_m2: float = 400.0,
    noise_scale: float = 0.01,
    outlier_fraction: float = 0.05,
    outlier_scale: float = 0.4,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, Table]:
    """A realistic synthetic scan: dense mantle points + far outliers.

    Points lie close to the QSM surface (Gaussian radial noise) with an
    ``outlier_fraction`` of points pushed far off-surface to exercise the
    semantic/noise head. Returns ``(points (N,3), qsm)``.
    """
    rng = rng or np.random.default_rng(0)
    if qsm is None:
        qsm = synthetic_qsm(rng=rng)

    start = qsm.to_numpy(["startX", "startY", "startZ"])
    end = qsm.to_numpy(["endX", "endY", "endZ"])
    radius = np.asarray(qsm["radius"], np.float64)
    axis = end - start
    axis_length = np.linalg.norm(axis, axis=1)
    axis_unit = axis / np.maximum(axis_length, 1e-12)[:, None]

    area = 2 * np.pi * radius * axis_length
    counts = np.maximum((area * points_per_m2).astype(int), 8)
    cyl_ids = np.repeat(np.arange(len(qsm)), counts)

    theta = rng.uniform(0, 2 * np.pi, size=cyl_ids.shape)
    z = rng.uniform(0, axis_length[cyl_ids])
    radial_noise = rng.normal(0.0, noise_scale, size=cyl_ids.shape)
    outliers = rng.uniform(size=cyl_ids.shape) < outlier_fraction
    radial_noise = np.where(
        outliers, rng.uniform(0.1, outlier_scale, size=cyl_ids.shape), radial_noise
    )
    r_noisy = np.maximum(radius[cyl_ids] + radial_noise, 1e-4)
    local = np.stack(
        [r_noisy * np.cos(theta), r_noisy * np.sin(theta), z], axis=1
    )

    rot = _rotation_from_z(axis_unit)
    world = np.einsum("nij,nj->ni", rot[cyl_ids], local) + start[cyl_ids]
    return world.astype(np.float32), qsm
