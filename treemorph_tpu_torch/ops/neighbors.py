"""Grid-bucketed neighbor search: KNN and radius counting.

Port of ``treemorph_tpu/ops/neighbors.py`` (the JAX package's device
replacement for the reference's ``cKDTree`` / ``NearestNeighbors``), with
its static-shape semantics, on whatever device the tensors are on:

1. points fall into cubic cells of ``cell_size`` from the valid points'
   minimum corner;
2. a stable sort orders them by linear cell key (invalid points last);
3. each query takes at most ``max_per_cell`` candidates from each of its 27
   adjacent cells, the first ones in sorted order (two ``searchsorted``
   probes per cell); the candidates past the cap are dropped, the same ones
   JAX drops: at the plot's density (~50,000 points/m^2, 0.25 m cells)
   nearly every cell holds more than 16, so this is the common case;
4. candidates are ranked by squared distance, ties to the earlier slot
   (``lax.top_k``'s order); empty slots get index 0 and distance +inf.

The squared distances round as the JAX package's compiled program rounds
them (a product, then two fused multiply-adds,
:func:`~treemorph_tpu_torch.ops.sampling._dot3`), so the ranks, and the
indices, are JAX's. Queries go in chunks to bound the (Q, 27 x cap)
candidate buffers.
"""

from __future__ import annotations

import torch

from .sampling import _dot3

_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]
#: key of an invalid point (sorted past every cell)
_INVALID_KEY = 0x7FFFFFF0
#: queries per chunk
_QUERY_CHUNK = 65_536


class _Grid:
    """Points sorted by cell key, and the key of any cell."""

    def __init__(self, points, valid, cell_size):
        self.points = points.float()
        big = torch.tensor(3.4e38, dtype=torch.float32, device=points.device)
        safe = torch.where(valid[:, None], self.points, big)
        mins = safe.min(dim=0).values
        self.mins = torch.where(torch.isfinite(mins), mins,
                                torch.zeros_like(mins))
        self.cell_size = cell_size
        cell = self.cells(self.points)
        zero = torch.zeros_like(cell)
        cell = torch.where(valid[:, None], cell.clamp_min(0), zero)
        self.extent = torch.where(valid[:, None], cell, zero).max(
            dim=0).values + 3 if len(cell) else torch.full_like(
                self.mins, 3, dtype=torch.int64)
        keys = torch.where(valid, self.key(cell),
                           torch.full_like(cell[:, 0], _INVALID_KEY))
        self.order = torch.argsort(keys, stable=True)
        self.sorted_keys = keys[self.order]

    def cells(self, pts):
        return torch.floor((pts - self.mins) / self.cell_size).to(
            torch.int32).long()

    def key(self, c):
        # +1 margin so neighbor offsets of boundary cells stay non-negative
        cc = c + 1
        return (cc[..., 0] * self.extent[1] + cc[..., 1]) * self.extent[2] \
            + cc[..., 2]

    def candidates(self, queries, max_per_cell):
        """(Q, 27 * cap) point indices and squared distances (+inf where
        a slot is empty), in JAX's slot order."""
        n = len(self.points)
        qcell = self.cells(queries).clamp_min(0)
        lanes = torch.arange(max_per_cell, device=queries.device)
        idx_all, d2_all = [], []
        for off in _OFFSETS:
            nkey = self.key(qcell + torch.tensor(off, device=queries.device))
            start = torch.searchsorted(self.sorted_keys, nkey)
            end = torch.searchsorted(self.sorted_keys, nkey + 1)
            count = torch.clamp(end - start, max=max_per_cell)
            slots = (start[:, None] + lanes).clamp(0, max(n - 1, 0))
            idx = self.order[slots]
            diff = queries[:, None, :] - self.points[idx]
            d2 = _dot3(diff, diff)
            d2 = torch.where(lanes < count[:, None], d2,
                             torch.full_like(d2, float("inf")))
            idx_all.append(idx)
            d2_all.append(d2)
        return torch.cat(idx_all, dim=1), torch.cat(d2_all, dim=1)


def knn(points: torch.Tensor, queries: torch.Tensor, valid: torch.Tensor,
        k: int, cell_size: float, max_per_cell: int = 16):
    """``k`` nearest valid ``points`` (N, 3) of each of ``queries`` (Q, 3):
    (indices (Q, k) int64, squared distances (Q, k) float32). Slots with no
    candidate carry index 0 and distance +inf."""
    grid = _Grid(points, valid, cell_size)
    queries = queries.float()
    out_idx, out_d2 = [], []
    for q0 in range(0, len(queries), _QUERY_CHUNK):
        idx, d2 = grid.candidates(queries[q0:q0 + _QUERY_CHUNK],
                                  max_per_cell)
        d2, pos = torch.sort(d2, dim=1, stable=True)
        d2, pos = d2[:, :k], pos[:, :k]
        idx = idx.gather(1, pos)
        out_idx.append(torch.where(torch.isinf(d2), torch.zeros_like(idx),
                                   idx))
        out_d2.append(d2)
    if not out_idx:
        return (torch.zeros((0, k), dtype=torch.int64, device=points.device),
                torch.zeros((0, k), device=points.device))
    return torch.cat(out_idx), torch.cat(out_d2)


def radius_count(points: torch.Tensor, queries: torch.Tensor,
                 valid: torch.Tensor, radius: float,
                 max_per_cell: int = 32) -> torch.Tensor:
    """Number of valid points within ``radius`` of each query (cells of
    edge ``radius``, so the 27-cell stencil covers the ball), at most
    ``max_per_cell`` counted from each cell; (Q,) int64."""
    grid = _Grid(points, valid, radius)
    queries = queries.float()
    r2 = torch.tensor(radius, dtype=torch.float32).square().item()
    counts = []
    for q0 in range(0, len(queries), _QUERY_CHUNK):
        _, d2 = grid.candidates(queries[q0:q0 + _QUERY_CHUNK], max_per_cell)
        counts.append((d2 <= r2).sum(dim=1))
    if not counts:
        return torch.zeros(0, dtype=torch.int64, device=points.device)
    return torch.cat(counts)
