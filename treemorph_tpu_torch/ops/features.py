"""Per-point geometric features.

Port of ``treemorph_tpu/ops/features.py`` (reference
``Modules/Features.py``): PCA normals (the smallest eigenvector of the
k-NN covariance), curvature (the smallest eigenvalue's share), density
(radius count), relative height, verticality and XY distance to the
centre, batched over the cloud on its device. The (N, 3, 3) covariances go
through the same closed-form symmetric 3x3 eigensolver as the JAX package
(trigonometric eigenvalues, eigenvector from the largest cross product of
two rows of A - lambda I), not ``torch.linalg.eigh``, so the normals are
the JAX package's, degenerate cases included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .neighbors import knn, radius_count


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1))


def _sym3x3_smallest_eig(cov: torch.Tensor):
    """Smallest eigenvector (..., 3) and ascending eigenvalues (..., 3) of
    symmetric 3x3 matrices (Smith's trigonometric method)."""
    a00, a01, a02 = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    a11, a12, a22 = cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))

    # det(B)/2 with B = (A - qI)/p
    det = (b00 * (b11 * b22 - a12 * a12)
           - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)  # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3

    lam = e3
    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    stacked = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)],
                          dim=-2)  # (..., 3, 3)
    best = _norm(stacked).argmax(dim=-1)
    vec = stacked.gather(-2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    vec = vec / torch.clamp_min(_norm(vec)[..., None], 1e-12)
    # Degenerate (isotropic) case: any direction works; use +z.
    degenerate = (p2 < 1e-24)[..., None]
    vec = torch.where(degenerate,
                      torch.tensor([0.0, 0.0, 1.0], dtype=vec.dtype,
                                   device=vec.device), vec)
    return vec, torch.stack([e3, e2, e1], dim=-1)


def _neighbor_covariance(points, valid, k, cell_size, max_per_cell):
    idx, d2 = knn(points, points, valid, k, cell_size, max_per_cell)
    w = torch.isfinite(d2).float()  # (N, k)
    nbrs = points.float()[idx]  # (N, k, 3)
    cnt = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    mean = (nbrs * w[..., None]).sum(dim=1, keepdim=True) / cnt[..., None]
    centered = (nbrs - mean) * w[..., None]
    # np.cov's unbiased (n-1) normalization (reference Features.py:25,129)
    denom = torch.clamp_min(cnt - 1.0, 1.0)
    return torch.einsum("nkd,nke->nde", centered, centered) \
        / denom[..., None]


def compute_normals(points, valid, k: int = 15, cell_size: float = 0.25,
                    max_per_cell: int = 16) -> torch.Tensor:
    """PCA normals: the smallest eigenvector of the k-NN covariance (sign
    not canonicalized, as in the reference)."""
    cov = _neighbor_covariance(points, valid, k, cell_size, max_per_cell)
    return _sym3x3_smallest_eig(cov)[0]


def compute_curvature(points, valid, k: int = 10, cell_size: float = 0.25,
                      max_per_cell: int = 16) -> torch.Tensor:
    """Smallest eigenvalue / (sum + 1e-6)."""
    cov = _neighbor_covariance(points, valid, k, cell_size, max_per_cell)
    eigvals = _sym3x3_smallest_eig(cov)[1]
    return eigvals[:, 0] / (eigvals.sum(dim=1) + 1e-6)


def compute_height(points, valid) -> torch.Tensor:
    """Relative height in [0, 1]."""
    z = points[:, 2].float()
    inf = torch.tensor(float("inf"), device=z.device)
    z_min = torch.where(valid, z, inf).min()
    z_max = torch.where(valid, z, -inf).max()
    return (z - z_min) / torch.clamp_min(z_max - z_min, 1e-12)


def compute_density(points, valid, radius: float = 0.1) -> torch.Tensor:
    """Valid points within ``radius`` of each point, itself included."""
    return radius_count(points, points, valid, radius)


def compute_verticality(normals) -> torch.Tensor:
    """|cos| of the normal against +z."""
    return normals[:, 2].abs()


def compute_distance_to_center(points, valid) -> torch.Tensor:
    """XY distance to the valid points' XY centroid."""
    w = valid.float()
    xy = points[:, :2].float()
    center = (xy * w[:, None]).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    return _norm(xy - center)


def add_features(
    labeled_cloud,
    use_normals: bool = True,
    use_heights: bool = True,
    use_densities: bool = False,
    use_verticalities: bool = False,
    use_distances: bool = False,
    use_curvatures: bool = False,
    cell_size: float = 0.25,
    density_radius: float = 0.1,
    device=None,
) -> np.ndarray:
    """The labeled cloud (numpy) with the selected feature columns appended
    in the reference's order: normals (3), curvature, density, height,
    verticality, distance to centre. Computed on ``device`` (the CUDA
    device unless named; raises without one)."""
    device = resolve_device(device)
    labeled_cloud = np.asarray(labeled_cloud, dtype=np.float32)
    pts = torch.from_numpy(np.ascontiguousarray(labeled_cloud[:, :3])).to(
        device)
    valid = torch.ones(len(pts), dtype=torch.bool, device=device)

    columns = [labeled_cloud]
    normals = None
    if use_normals:
        normals = compute_normals(pts, valid, k=15, cell_size=cell_size)
        columns.append(normals.cpu().numpy())
    if use_curvatures:
        curv = compute_curvature(pts, valid, k=10, cell_size=cell_size)
        columns.append(curv.cpu().numpy()[:, None])
    if use_densities:
        dens = radius_count(pts, pts, valid, density_radius)
        columns.append(dens.cpu().numpy().astype(np.float32)[:, None])
    if use_heights:
        columns.append(compute_height(pts, valid).cpu().numpy()[:, None])
    if use_verticalities:
        if normals is None:
            normals = compute_normals(pts, valid, k=15, cell_size=cell_size)
        columns.append(compute_verticality(normals).cpu().numpy()[:, None])
    if use_distances:
        d = compute_distance_to_center(pts, valid)
        columns.append(d.cpu().numpy()[:, None])
    return np.concatenate(columns, axis=1)
