"""QSM data structures: spheres, sphere clusters, cylinders.

Behavioral parity with reference
``Modules/Pipeline/QSMFittingDepthFirst.py``: ``Sphere`` (:20-78),
``SphereCluster`` (:325-375), ``Cylinder``/``CylinderTracker`` (:378-495).
The cylinder graph logic (parent/child linkage, recursive parent
reassignment after a connection) is re-implemented iteratively; PLY export
uses the numpy mesh builders in :mod:`treemorph_tpu_torch.utils.mesh` instead of
open3d.
"""

from __future__ import annotations

import numpy as np

from ...utils.table import Table
from ...utils.mesh import (
    combine_meshes,
    cylinder_mesh,
    sphere_mesh,
    write_ply,
)


class Sphere:
    """A search sphere with a thin outer shell used for branch detection."""

    __slots__ = (
        "is_seed",
        "center",
        "radius",
        "thickness",
        "contained_points",
        "outer_points",
        "is_outer",
        "spread",
        "first_cylinder_id",
        "connected_cylinder_ids",
        "connection_vectors",
        "_avg_cache",
    )

    def __init__(
        self,
        center,
        radius: float,
        thickness: float,
        is_seed: bool = False,
        spread: float | None = None,
        thickness_type: str = "relative",
    ):
        if thickness_type == "relative":
            self.thickness = radius * thickness
        elif thickness_type == "absolute":
            self.thickness = thickness
        else:
            raise ValueError(
                "thickness_type must be 'relative' or 'absolute'"
            )
        self.center = np.asarray(center, float)
        self.radius = float(radius)
        self.is_seed = is_seed
        self.spread = spread
        self.contained_points = np.array([], dtype=int)
        self.outer_points = np.array([], dtype=int)
        self.is_outer = False
        self.first_cylinder_id = None
        self.connected_cylinder_ids: list[int] = []
        self.connection_vectors: list[np.ndarray] = []

    def assign_points(self, points, available_mask, point_tree):
        """Collect available points inside the sphere and in its shell.

        Shell = [radius - thickness, radius]; queries use a +5 cm slack
        radius like the reference (:52).
        """
        local = point_tree.query_ball_point(self.center, self.radius + 0.05)
        if len(local) == 0:
            self.contained_points = np.array([], dtype=int)
            self.outer_points = np.array([], dtype=int)
            return
        local = np.asarray(local, int)
        local = local[available_mask[local]]
        if local.size == 0:
            self.contained_points = np.array([], dtype=int)
            self.outer_points = np.array([], dtype=int)
            return
        dists = np.linalg.norm(points[local] - self.center, axis=1)
        contained = dists <= self.radius
        outer = contained & (dists > self.radius - self.thickness)
        self.contained_points = local[contained]
        self.outer_points = local[outer]

    def average_connection_vector(self) -> np.ndarray:
        # memoized by list length: vectors are only ever appended, so
        # the length identifies the state (hot in the merge scans)
        n_vecs = len(self.connection_vectors)
        cached = getattr(self, "_avg_cache", None)
        if cached is not None and cached[0] == n_vecs:
            return cached[1]
        if n_vecs:
            avg = np.mean(self.connection_vectors, axis=0)
            n = np.linalg.norm(avg)
            out = avg / n if n > 1e-9 else np.zeros(3)
        else:
            out = np.zeros(3)
        self._avg_cache = (n_vecs, out)
        return out


class SphereCluster:
    def __init__(self):
        self.spheres: list[Sphere] = []
        self.outer_spheres: list[Sphere] = []

    def add_sphere(self, sphere: Sphere):
        self.spheres.append(sphere)

    def add_spheres(self, spheres):
        self.spheres.extend(spheres)

    def get_outer_spheres(self):
        """Refresh the outer-sphere list; guarantee at least one by
        falling back to the lowest sphere (reference :339-354)."""
        self.outer_spheres = [s for s in self.spheres if s.is_outer]
        if not self.outer_spheres and self.spheres:
            lowest = min(self.spheres, key=lambda s: s.center[2])
            lowest.is_outer = True
            self.outer_spheres.append(lowest)
        return self.outer_spheres


class Cylinder:
    __slots__ = (
        "id",
        "start",
        "end",
        "radius",
        "volume",
        "spheres",
        "parent_cylinder_id",
        "child_cylinder_ids",
        "reassigned",
        "length",
        "cyl_type",
    )

    def __init__(
        self,
        id: int,
        start,
        end,
        radius: float,
        start_sphere=None,
        end_sphere=None,
        parent_cylinder_id=None,
        cyl_type: str = "follow",
    ):
        self.id = id
        self.start = np.asarray(start, float)
        self.end = np.asarray(end, float)
        self.radius = float(radius)
        self.length = float(np.linalg.norm(self.end - self.start))
        self.volume = float(np.pi * radius**2 * self.length)
        self.spheres = [start_sphere, end_sphere]
        self.parent_cylinder_id = parent_cylinder_id
        self.child_cylinder_ids: list[int] = []
        self.reassigned = False
        self.cyl_type = cyl_type

    def to_dict(self):
        return {
            "ID": self.id,
            "startX": self.start[0],
            "startY": self.start[1],
            "startZ": self.start[2],
            "endX": self.end[0],
            "endY": self.end[1],
            "endZ": self.end[2],
            "radius": self.radius,
            "volume": self.volume,
            "length": self.length,
            "parentID": self.parent_cylinder_id,
            "childrenIDs": self.child_cylinder_ids,
            "type": self.cyl_type,
        }


class CylinderTracker:
    """Cylinder graph with parent/child linkage (reference :406-495)."""

    def __init__(self):
        self.cylinders: dict[int, Cylinder] = {}
        self.next_id = 0
        self.recent_cylinders: list[Cylinder] = []

    def add_cylinder(
        self,
        sphere_a: Sphere,
        sphere_b: Sphere,
        radius: float,
        cyl_type: str = "follow",
    ) -> int:
        cylinder_id = self.next_id
        self.next_id += 1

        parent_id = sphere_a.first_cylinder_id
        if sphere_b.first_cylinder_id is None:
            sphere_b.first_cylinder_id = cylinder_id

        cyl = Cylinder(
            id=cylinder_id,
            start=sphere_a.center,
            end=sphere_b.center,
            radius=radius,
            start_sphere=sphere_a,
            end_sphere=sphere_b,
            parent_cylinder_id=parent_id,
            cyl_type=cyl_type,
        )
        if parent_id is not None:
            self.cylinders[parent_id].child_cylinder_ids.append(cylinder_id)

        sphere_a.connected_cylinder_ids.append(cylinder_id)
        sphere_b.connected_cylinder_ids.append(cylinder_id)
        sphere_a.connection_vectors.append(sphere_b.center - sphere_a.center)
        sphere_b.connection_vectors.append(sphere_a.center - sphere_b.center)

        self.cylinders[cylinder_id] = cyl
        self.recent_cylinders.append(cyl)
        return cylinder_id

    def reassign_parent(self, new_parent_id: int, child_start_sphere: Sphere):
        """Re-root the cylinder subgraph reachable from ``child_start_sphere``
        so its cylinders hang off ``new_parent_id``.

        Iterative re-formulation of the reference's recursion (:463-491):
        a worklist of (incoming cylinder id, sphere) pairs.
        """
        stack = [(new_parent_id, child_start_sphere)]
        while stack:
            parent_id, sphere = stack.pop()
            sphere.first_cylinder_id = parent_id
            self.cylinders[parent_id].child_cylinder_ids = []
            for cyl_id in sphere.connected_cylinder_ids:
                if cyl_id == parent_id:
                    continue
                cyl = self.cylinders[cyl_id]
                if cyl.reassigned:
                    continue
                cyl.parent_cylinder_id = parent_id
                self.cylinders[parent_id].child_cylinder_ids.append(cyl_id)
                cyl.reassigned = True
                other = next(
                    (s for s in cyl.spheres if s is not sphere), None
                )
                if other is not None:
                    stack.append((cyl_id, other))

    def reset_reassigned_flags(self, cluster: SphereCluster):
        for sphere in cluster.spheres:
            for cyl_id in sphere.connected_cylinder_ids:
                if cyl_id in self.cylinders:
                    self.cylinders[cyl_id].reassigned = False

    def export_table(self) -> Table:
        return Table.from_records(
            [c.to_dict() for c in self.cylinders.values()]
        )

    def export_mesh_ply(
        self,
        filename: str,
        resolution: int = 10,
        color_by_type: bool = False,
        color_by_root: bool = False,
    ):
        if not self.cylinders:
            return
        radii = np.array(
            [c.radius for c in self.cylinders.values()], float
        )
        finite = radii[np.isfinite(radii) & (radii > 1e-6)]
        r_min = max(finite.min(), 1e-4) if len(finite) else 1e-4
        r_max = finite.max() if len(finite) else 1e-4

        meshes = []
        for cyl in self.cylinders.values():
            radius = max(
                cyl.radius if np.isfinite(cyl.radius) else 1e-4, 1e-4
            )
            if color_by_root:
                color = (
                    [1, 0, 0]
                    if cyl.parent_cylinder_id is None
                    else [0, 0, 1]
                )
            elif color_by_type:
                color = (
                    [1, 0, 0] if cyl.cyl_type == "connection" else [0, 1, 0]
                )
            else:
                t = (
                    (np.clip(radius, r_min, r_max) - r_min)
                    / (r_max - r_min)
                    if r_max - r_min > 1e-8
                    else 0.5
                )
                color = [t, 1 - t, 0]
            v, f = cylinder_mesh(cyl.start, cyl.end, radius, resolution)
            meshes.append((v, f, color))
        verts, faces, colors = combine_meshes(meshes)
        write_ply(filename, verts, faces, colors)


def export_clusters_spheres_ply(
    clusters,
    filename: str,
    resolution: int = 8,
    color_by_outer: bool = False,
):
    """Sphere-cloud visualization (reference :267-321)."""
    all_radii = [s.radius for c in clusters for s in c.spheres]
    if not all_radii:
        return
    r_min, r_max = min(all_radii), max(all_radii)
    meshes = []
    for cluster in clusters:
        for sphere in cluster.spheres:
            if color_by_outer:
                color = [0, 0, 1] if sphere.is_outer else [0.5, 0.5, 0.5]
            else:
                t = (sphere.radius - r_min) / (r_max - r_min + 1e-9)
                color = [t, 0, 1 - t]
            v, f = sphere_mesh(sphere.center, sphere.radius, resolution)
            meshes.append((v, f, color))
    verts, faces, colors = combine_meshes(meshes)
    write_ply(filename, verts, faces, colors)
