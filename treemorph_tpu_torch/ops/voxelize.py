"""Voxelization via one stable sort of packed lexicographic keys.

Port of ``treemorph_tpu/ops/voxelize.py``: batched point clouds are
quantized per batch element against that element's min corner,
deduplicated into voxels, and per-voxel mean features are computed over
ALL points of a voxel. Arrays keep the JAX package's static layout: voxel
arrays are padded to ``capacity`` rows with a ``num_voxels`` count and a
validity mask, voxels come out in lexicographic (b, x, y, z) order (the
order every downstream rulebook and band plan relies on), and
``point_to_voxel`` maps points whose voxel overflowed the capacity (and
padding points past it) to ``capacity``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_BATCH = 0x7FFFFFF0

#: packed-key layout: b[6] x[19] y[19] z[19] — 63 bits, so the key stays a
#: non-negative int64 and sorts like the (b, x, y, z) tuple
COORD_BITS = 19
BATCH_LIMIT = 1 << 6
KEY_SENTINEL = torch.iinfo(torch.int64).max


class VoxelizedCloud(NamedTuple):
    """Padded voxel set; voxel arrays are padded to the static capacity."""

    voxel_feats: torch.Tensor  # (cap, D) float32 voxel means, padding zero
    voxel_coords: torch.Tensor  # (cap, 4) int32: batch, gx, gy, gz (-1 pad)
    point_to_voxel: torch.Tensor  # (N,) int64 voxel of every point
    num_voxels: torch.Tensor  # () int64
    voxel_valid: torch.Tensor  # (cap,) bool
    grid_min: torch.Tensor  # (B, 3) float32 per-element min corner
    spatial_shape: torch.Tensor  # (3,) int32 max grid extent over the batch


def pack_keys(key4: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) int64 keys whose order is lexicographic (b, x, y, z) order;
    invalid rows get a sentinel above every key. Raises when a valid row
    falls outside the packing range (batch < 64, coordinates < 2^19),
    where the JAX package switches to hashed keys."""
    k = key4.to(torch.int64)
    live = k[valid]
    if live.numel() and (
        int(live.min()) < 0
        or int(live[:, 0].max()) >= BATCH_LIMIT
        or int(live[:, 1:].max()) >= 1 << COORD_BITS
    ):
        raise ValueError(
            "voxel keys outside the packing range (batch < 64, "
            "coordinates in [0, 2^19))"
        )
    key = (
        (k[:, 0] << (3 * COORD_BITS))
        | (k[:, 1] << (2 * COORD_BITS))
        | (k[:, 2] << COORD_BITS)
        | k[:, 3]
    )
    return torch.where(valid, key, KEY_SENTINEL)


class SortedRuns(NamedTuple):
    """Sorted-domain view of a dedup: equal (b, x, y, z) rows adjacent in
    lexicographic order, padding last."""

    s_valid: torch.Tensor  # (N,) bool validity per sorted row
    s_orig: torch.Tensor  # (N,) int64 original row of each sorted row
    new: torch.Tensor  # (N,) bool run-boundary flags (invalid rows: True)
    s_id: torch.Tensor  # (N,) int64 run index per sorted row
    num: torch.Tensor  # () int64 number of valid runs


def sorted_runs(key4: torch.Tensor, valid: torch.Tensor) -> SortedRuns:
    """One stable sort of the packed keys. Stability makes a run's first
    sorted row carry its smallest original index, as in the JAX package;
    every invalid row is its own run, so ids stay monotone."""
    key = pack_keys(key4, valid)
    s_key, s_orig = torch.sort(key, stable=True)
    s_valid = valid[s_orig]
    new = torch.ones_like(s_valid)
    new[1:] = s_key[1:] != s_key[:-1]
    new = torch.where(s_valid, new, True)
    s_id = torch.cumsum(new.to(torch.int64), 0) - 1
    num = torch.where(s_valid, s_id + 1, 0).max()
    return SortedRuns(s_valid, s_orig, new, s_id, num)


def first_rows_of_runs(r: SortedRuns, cap: int) -> torch.Tensor:
    """(cap,) original row of each run's first element (run r of the sort
    IS dedup group r); runs past ``cap`` and padding give 0."""
    idx = torch.where(r.s_valid & r.new, r.s_id.clamp(max=cap), cap)
    out = torch.zeros(cap + 1, dtype=torch.int64, device=idx.device)
    out[idx] = r.s_orig  # unique targets apart from the dump row
    return out[:cap]


def voxelize(
    coords: torch.Tensor,
    feats: torch.Tensor,
    batch_ids: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    batch_size: int,
    capacity: int | None = None,
) -> VoxelizedCloud:
    """Voxelize a flat-concatenated batch of clouds.

    Args:
        coords: (N, 3) float32 point positions.
        feats: (N, D) float32 per-point features to be voxel-averaged.
        batch_ids: (N,) integer batch element of each point.
        valid: (N,) bool, False for padding points.
        voxel_size: edge length of the cubic voxels.
        batch_size: number of batch elements.
        capacity: bound on the voxel count (default N); points whose voxel
            overflows it are masked out (``point_to_voxel == capacity``).
    """
    n = coords.shape[0]
    dev = coords.device
    cap = capacity if capacity is not None else n
    batch_ids = torch.where(
        valid, batch_ids.to(torch.int64), INVALID_BATCH
    )

    # per-batch-element min corner over valid points (an element without
    # points keeps the 3.4e38 fill, as in the JAX package)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    safe_coords = torch.where(valid[:, None], coords, big)
    grid_min = torch.stack([
        torch.where((batch_ids == be)[:, None], safe_coords, big).amin(dim=0)
        for be in range(batch_size)
    ])
    grid_min = torch.where(torch.isfinite(grid_min), grid_min, 0.0)

    mins = grid_min[batch_size - 1] * torch.ones_like(coords)
    for be in range(batch_size - 1):
        mins = torch.where((batch_ids == be)[:, None], grid_min[be], mins)
    # divide by a device tensor: CUDA divides by a CPU scalar through its
    # reciprocal, which can move a point across a voxel boundary
    size = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    grid = torch.floor((coords - mins) / size).to(torch.int64)
    grid = grid.clamp(min=0)
    grid = torch.where(valid[:, None], grid, 0)

    key4 = torch.cat([batch_ids[:, None], grid], dim=1)
    r = sorted_runs(key4, valid)
    num_voxels = r.num.clamp(max=cap)

    point_to_voxel = torch.empty(n, dtype=torch.int64, device=dev)
    point_to_voxel[r.s_orig] = r.s_id.clamp(max=cap)

    # per-voxel means: one (D+1)-wide scatter-add carries the counts too
    # (atomic on CUDA, so the sums' order is not fixed there)
    weights = valid.to(torch.float32)
    ext = torch.cat([feats * weights[:, None], weights[:, None]], dim=1)
    span = torch.zeros((cap + 1, ext.shape[1]), dtype=torch.float32,
                       device=dev)
    span.index_add_(0, point_to_voxel, ext)
    span = span[:cap]
    sums, counts = span[:, :-1], span[:, -1]
    voxel_feats = sums / counts.clamp(min=1.0)[:, None]

    rows = first_rows_of_runs(r, cap)
    voxel_valid = counts > 0
    voxel_coords = torch.where(
        voxel_valid[:, None],
        torch.cat([batch_ids[rows][:, None], grid[rows]], dim=1),
        -1,
    ).to(torch.int32)
    spatial_shape = (
        torch.where(valid[:, None], grid, 0).amax(dim=0) + 1
    ).to(torch.int32)

    return VoxelizedCloud(
        voxel_feats=voxel_feats,
        voxel_coords=voxel_coords,
        point_to_voxel=point_to_voxel,
        num_voxels=num_voxels,
        voxel_valid=voxel_valid,
        grid_min=grid_min,
        spatial_shape=spatial_shape,
    )


def voxelize_treelearn_features(
    coords: torch.Tensor,
    feats: torch.Tensor,
    batch_ids: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    batch_size: int,
    use_coords: bool = False,
    use_feats: bool = True,
    capacity: int | None = None,
) -> VoxelizedCloud:
    """TreeLearn voxel features in the ``[feats..., coords]`` layout: the
    voxel mean of ``[coords, feats]`` with either half replaced by ones
    when unused, reordered features-first (reference TreeLearn.py:221-225).
    """
    stacked = torch.cat([coords, feats], dim=1)
    out = voxelize(
        coords, stacked, batch_ids, valid, voxel_size, batch_size,
        capacity=capacity,
    )
    vf = out.voxel_feats
    coord_part = vf[:, :3] if use_coords else torch.ones_like(vf[:, :3])
    feat_part = vf[:, 3:] if use_feats else torch.ones_like(vf[:, 3:])
    return out._replace(
        voxel_feats=torch.cat([feat_part, coord_part], dim=1)
    )
