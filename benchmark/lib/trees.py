"""Synthetic labeled trees: procedural cylinder skeletons and scans of them
with exact per-point labels.

A frozen copy of the port's ``fixtures/synthetic.py`` generators
(``synthetic_qsm``, ``synthetic_tree_cloud``), kept here so that the
traffic cannot change when the program changes. It adds what a training
set needs: each point's offset back to its cylinder's surface (minus its
drawn radial noise, along the radial direction) and whether it is one of
the scan's outliers. Host numpy, every draw from an explicit generator.
"""

from __future__ import annotations

import numpy as np


def rotation_from_z(axis_unit: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations mapping local +z onto each row of
    ``axis_unit`` (Rodrigues; exact at the aligned and opposed rows)."""
    z_axis = np.array([0.0, 0.0, 1.0])
    v = np.cross(np.broadcast_to(z_axis, axis_unit.shape), axis_unit)
    s = np.linalg.norm(v, axis=1)
    c = axis_unit @ z_axis
    vx = np.zeros((len(axis_unit), 3, 3))
    vx[:, 0, 1], vx[:, 0, 2] = -v[:, 2], v[:, 1]
    vx[:, 1, 0], vx[:, 1, 2] = v[:, 2], -v[:, 0]
    vx[:, 2, 0], vx[:, 2, 1] = -v[:, 1], v[:, 0]
    rot = np.eye(3)[None] + vx + np.einsum("nij,njk->nik", vx, vx) * (
        (1 - c) / (s**2 + 1e-8))[:, None, None]
    degenerate = s < 1e-8
    rot[degenerate & (c > 0)] = np.eye(3)
    rot[degenerate & (c <= 0)] = np.diag([1.0, -1.0, -1.0])
    return rot


def skeleton(rng: np.random.Generator, n_branches: int = 6,
             stem_height: float = 8.0, stem_radius: float = 0.25,
             n_stem_segments: int = 8) -> dict:
    """A tapering vertical stem of ``n_stem_segments`` cylinders and
    ``n_branches`` angled first-order branches: ``{"start", "end",
    "radius"}`` arrays, one row a cylinder."""
    seg_h = stem_height / n_stem_segments
    start, end, radius = [], [], []
    for i in range(n_stem_segments):
        taper = 1.0 - 0.7 * (i / max(n_stem_segments - 1, 1))
        start.append((0.0, 0.0, i * seg_h))
        end.append((0.0, 0.0, (i + 1) * seg_h))
        radius.append(stem_radius * taper)
    for _ in range(n_branches):
        seg = int(rng.integers(n_stem_segments // 3, n_stem_segments))
        z_base = (seg + 0.5) * seg_h
        azimuth = rng.uniform(0, 2 * np.pi)
        elevation = rng.uniform(np.pi / 6, np.pi / 3)
        length = rng.uniform(0.8, 2.0)
        direction = np.array([np.cos(azimuth) * np.cos(elevation),
                              np.sin(azimuth) * np.cos(elevation),
                              np.sin(elevation)])
        base = np.array([0.0, 0.0, z_base])
        start.append(tuple(base))
        end.append(tuple(base + direction * length))
        radius.append(stem_radius * 0.3)
    return {"start": np.asarray(start), "end": np.asarray(end),
            "radius": np.asarray(radius)}


def scan(sk: dict, rng: np.random.Generator, n_points: int,
         noise_scale: float, outlier_fraction: float,
         outlier_scale: float = 0.4):
    """``n_points`` scan points of skeleton ``sk``, spread over its
    cylinders' mantles by area: Gaussian radial noise of ``noise_scale``,
    and an ``outlier_fraction`` pushed 0.1 to ``outlier_scale`` off the
    surface. Returns ``(points, offsets, outlier)``: (n, 3) float32
    positions, (n, 3) float32 vectors back to the surface, (n,) bool."""
    start, end, radius = sk["start"], sk["end"], sk["radius"]
    axis = end - start
    axis_length = np.linalg.norm(axis, axis=1)
    axis_unit = axis / np.maximum(axis_length, 1e-12)[:, None]
    area = 2 * np.pi * radius * axis_length
    cyl = rng.choice(len(radius), size=n_points, p=area / area.sum())
    theta = rng.uniform(0, 2 * np.pi, size=n_points)
    z = rng.uniform(0, axis_length[cyl])
    noise = rng.normal(0.0, noise_scale, size=n_points)
    outlier = rng.uniform(size=n_points) < outlier_fraction
    noise = np.where(outlier, rng.uniform(0.1, outlier_scale, n_points),
                     noise)
    r_noisy = np.maximum(radius[cyl] + noise, 1e-4)
    radial = np.stack([np.cos(theta), np.sin(theta), np.zeros(n_points)],
                      axis=1)
    local = radial * r_noisy[:, None]
    local[:, 2] = z
    rot = rotation_from_z(axis_unit)[cyl]
    world = np.einsum("nij,nj->ni", rot, local) + start[cyl]
    back = np.einsum("nij,nj->ni", rot, radial) * (radius[cyl]
                                                  - r_noisy)[:, None]
    return world.astype(np.float32), back.astype(np.float32), outlier


def scan_in_order(sk: dict, rng: np.random.Generator, density: float,
                  noise_scale: float, outlier_fraction: float,
                  outlier_scale: float = 0.4):
    """A scan at ``density`` points a square metre of mantle, cylinder by
    cylinder in the skeleton's order (stem from the base up, then the
    branches), as ``synthetic_tree_cloud`` lays its points out: each
    cylinder ``max(area * density, 8)`` points. Returns :func:`scan`'s
    triple."""
    start, end, radius = sk["start"], sk["end"], sk["radius"]
    length = np.linalg.norm(end - start, axis=1)
    counts = np.maximum((2 * np.pi * radius * length * density).astype(int),
                        8)
    parts = [scan({"start": start[i:i + 1], "end": end[i:i + 1],
                   "radius": radius[i:i + 1]}, rng, int(c), noise_scale,
                  outlier_fraction, outlier_scale)
             for i, c in enumerate(counts)]
    return tuple(np.concatenate(p) for p in zip(*parts))


def rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    """``points`` (or vectors) turned by ``angle`` about the vertical."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return (points @ rot.T).astype(np.float32)
