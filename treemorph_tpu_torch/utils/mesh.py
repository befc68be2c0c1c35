"""Minimal triangle-mesh generation + PLY export (open3d replacement).

The reference exports QSM visualizations through open3d's C++ mesh builders
(``QSMFittingDepthFirst.py:497-614``, ``Plotting/csv_to_ply.py``); open3d is
not available here, so cylinder/sphere meshes are generated in numpy and
written as binary-less ASCII PLY directly.
"""

from __future__ import annotations

import numpy as np


def _rotation_from_z(direction: np.ndarray) -> np.ndarray:
    direction = direction / max(np.linalg.norm(direction), 1e-12)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, direction)
    s = np.linalg.norm(v)
    c = float(z @ direction)
    if s < 1e-9:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    k = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
    return np.eye(3) + k + k @ k * ((1 - c) / s**2)


def cylinder_mesh(
    p0: np.ndarray, p1: np.ndarray, radius: float, resolution: int = 10
):
    """Closed cylinder between p0 and p1. Returns (vertices, faces)."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    height = max(np.linalg.norm(p1 - p0), 1e-4)
    radius = max(float(radius), 1e-4)

    theta = np.linspace(0, 2 * np.pi, resolution, endpoint=False)
    ring = np.stack([np.cos(theta), np.sin(theta)], axis=1) * radius
    bottom = np.concatenate([ring, np.zeros((resolution, 1))], axis=1)
    top = np.concatenate(
        [ring, np.full((resolution, 1), height)], axis=1
    )
    centers = np.array([[0, 0, 0], [0, 0, height]], float)
    verts = np.vstack([bottom, top, centers])

    faces = []
    for i in range(resolution):
        j = (i + 1) % resolution
        # side quads as two triangles
        faces.append([i, j, resolution + i])
        faces.append([j, resolution + j, resolution + i])
        # caps
        faces.append([2 * resolution, j, i])
        faces.append([2 * resolution + 1, resolution + i, resolution + j])
    faces = np.array(faces, int)

    rot = _rotation_from_z(p1 - p0)
    verts = verts @ rot.T + p0
    return verts, faces


def sphere_mesh(center: np.ndarray, radius: float, resolution: int = 8):
    """UV sphere. Returns (vertices, faces)."""
    center = np.asarray(center, float)
    radius = max(float(radius), 1e-4)
    n_lat = max(resolution, 3)
    n_lon = max(2 * resolution, 4)

    verts = [[0, 0, radius]]
    for i in range(1, n_lat):
        phi = np.pi * i / n_lat
        for j in range(n_lon):
            theta = 2 * np.pi * j / n_lon
            verts.append(
                [
                    radius * np.sin(phi) * np.cos(theta),
                    radius * np.sin(phi) * np.sin(theta),
                    radius * np.cos(phi),
                ]
            )
    verts.append([0, 0, -radius])
    verts = np.asarray(verts) + center

    faces = []
    for j in range(n_lon):
        faces.append([0, 1 + j, 1 + (j + 1) % n_lon])
    for i in range(n_lat - 2):
        base = 1 + i * n_lon
        nxt = base + n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append([base + j, nxt + j, nxt + j2])
            faces.append([base + j, nxt + j2, base + j2])
    last = len(verts) - 1
    base = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append([last, base + (j + 1) % n_lon, base + j])
    return verts, np.asarray(faces, int)


def combine_meshes(meshes):
    """Concatenate (vertices, faces, color) triples into one colored mesh."""
    all_v, all_f, all_c = [], [], []
    offset = 0
    for verts, faces, color in meshes:
        all_v.append(verts)
        all_f.append(faces + offset)
        all_c.append(np.tile(np.asarray(color, float), (len(verts), 1)))
        offset += len(verts)
    return np.vstack(all_v), np.vstack(all_f), np.vstack(all_c)


def write_ply(path: str, vertices, faces, vertex_colors=None):
    """Write an ASCII PLY triangle mesh."""
    vertices = np.asarray(vertices, float)
    faces = np.asarray(faces, int)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if vertex_colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
            )
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if vertex_colors is not None:
            colors = np.clip(
                np.asarray(vertex_colors, float) * 255, 0, 255
            ).astype(int)
            for v, c in zip(vertices, colors):
                f.write(
                    f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]}\n"
                )
        else:
            for v in vertices:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
