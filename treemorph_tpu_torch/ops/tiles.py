"""Dense-tile submanifold conv engine.

Port of ``treemorph_tpu/ops/tiles.py``, a library API (no model runs it):
active voxels are grouped into cubic tiles of ``L^3`` cells (tile key =
``coords >> log2(L)``, lex-sorted as :func:`.sparse.build_downsample` sorts
its coarse voxels), with a 27-entry neighbor-tile table. Features live in a
``(T+2, L, L, L, C)`` dense array (row T the overflow dump, row T+1 the
zero tile that missing neighbors read); a conv assembles each tile's
one-cell halo from its 26 neighbor tiles (:func:`halo_expand`) and runs one
dense conv over it (:func:`tile_subm_conv`), outputs masked to the active
cells: the gather engine's function with the same ``(27, Cin, Cout)``
weights in kernel-offset order.

Neighbor tiles come from :func:`.sparse.build_rulebook`'s exact lookup over
the tile coordinates (the JAX package's hash lookup without
``verify_coords``, up to its rare false hits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .bricks import _segment_max, conv3d_no_tf32, conv3d_kernel
from .sparse import build_rulebook
from .voxelize import sorted_runs


class TileSet(NamedTuple):
    """Static-shape tile structure of one voxel level; ``cap`` tiles, the
    dense array two more rows (``cap``: the overflow dump, written and
    never read; ``cap + 1``: the zero tile, read and never written)."""

    tile_of_voxel: torch.Tensor  # (M,) int64 tile row; cap = overflow
    cell_of_voxel: torch.Tensor  # (M,) int64 flat cell in [0, L^3)
    tile_coords: torch.Tensor  # (cap, 4) int64 (b, tx, ty, tz)
    tile_valid: torch.Tensor  # (cap,) bool
    nbr: torch.Tensor  # (cap, 27) int64 rows; cap + 1 = missing
    active: torch.Tensor  # (cap + 2, L, L, L, 1) float32 cell mask
    num_tiles: torch.Tensor  # () int64
    overflow: torch.Tensor  # () int64 voxels dropped by the cap


def tile_offsets(device=None) -> torch.Tensor:
    """(27, 3) neighbor-tile offsets in kernel-offset order."""
    r = (-1, 0, 1)
    return torch.tensor([(dx, dy, dz) for dx in r for dy in r for dz in r],
                        dtype=torch.int64, device=device)


def build_tiles(coords: torch.Tensor, valid: torch.Tensor, cap: int,
                tile: int = 8) -> TileSet:
    """Group voxels into ``tile``^3 dense tiles (a power of two), tile
    rows lex-sorted by (b, tx, ty, tz), with their neighbor table."""
    if tile & (tile - 1):
        raise ValueError("tile must be a power of two")
    shift = tile.bit_length() - 1
    c = coords.to(torch.int64)
    b = c[:, 0]
    txyz = c[:, 1:] >> shift
    local = c[:, 1:] & (tile - 1)
    cell = (local[:, 0] * tile + local[:, 1]) * tile + local[:, 2]
    r = sorted_runs(torch.cat([b[:, None], txyz], dim=1), valid)
    tile_full = torch.empty_like(b)
    tile_full[r.s_orig] = r.s_id
    tile_of_voxel = tile_full.clamp(max=cap)
    overflow = (valid & (tile_full >= cap)).sum()

    tile_b = _segment_max(torch.where(valid, b, -1), tile_of_voxel, cap + 1)
    tile_xyz = _segment_max(torch.where(valid[:, None], txyz, -1),
                            tile_of_voxel, cap + 1)
    tile_coords = torch.cat([tile_b[:cap, None], tile_xyz[:cap]], dim=1)
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=coords.device)
    counts.index_add_(0, tile_of_voxel, valid.to(torch.int64))
    tile_valid = counts[:cap] > 0
    # kernel-offset order, the center the tile itself; missing -> cap + 1
    nbr = build_rulebook(tile_coords, tile_valid, 3)
    nbr = torch.where(nbr == cap, cap + 1, nbr)
    active = _scatter_dense(valid.float()[:, None], tile_of_voxel, cell,
                            valid, cap, tile)
    return TileSet(
        tile_of_voxel=tile_of_voxel, cell_of_voxel=cell,
        tile_coords=tile_coords, tile_valid=tile_valid, nbr=nbr,
        active=active, num_tiles=r.num.clamp(max=cap), overflow=overflow,
    )


def _scatter_dense(feats, tile_of_voxel, cell, valid, cap, tile):
    l3 = tile ** 3
    flat_idx = torch.where(valid, tile_of_voxel * l3 + cell, cap * l3)
    flat = feats.new_zeros(((cap + 2) * l3, feats.shape[-1]))
    flat = flat.index_put((flat_idx,),
                          torch.where(valid[:, None], feats, 0))
    return flat.reshape(cap + 2, tile, tile, tile, feats.shape[-1])


def to_dense(feats: torch.Tensor, ts: TileSet, tile: int) -> torch.Tensor:
    """(M, C) -> (cap + 2, L, L, L, C): one scatter of M rows."""
    cap = ts.tile_coords.shape[0]
    every = torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
    return _scatter_dense(feats, ts.tile_of_voxel, ts.cell_of_voxel, every,
                          cap, tile)


def from_dense(dense: torch.Tensor, ts: TileSet,
               valid: torch.Tensor) -> torch.Tensor:
    """(cap + 2, L, L, L, C) -> (M, C): one gather of M rows, zero where a
    voxel is invalid or overflowed."""
    cap1, tile = dense.shape[0], dense.shape[1]
    l3 = tile ** 3
    ok = valid & (ts.tile_of_voxel < cap1 - 2)
    idx = torch.where(ok, ts.tile_of_voxel * l3 + ts.cell_of_voxel, 0)
    return dense.reshape(cap1 * l3, -1)[idx] * ok[:, None]


def halo_expand(dense: torch.Tensor, ts: TileSet) -> torch.Tensor:
    """(T+2, L, L, L, C) -> (T+2, L+2, L+2, L+2, C): each tile's one-cell
    halo from its 26 neighbor tiles (missing ones read the zero tile); rows
    ``cap`` and ``cap + 1`` keep zero halos."""
    cap = ts.nbr.shape[0]
    n = dense.shape[1]
    src = {-1: slice(n - 1, n), 0: slice(0, n), 1: slice(0, 1)}
    dst = {-1: slice(0, 1), 0: slice(1, n + 1), 1: slice(n + 1, n + 2)}
    halo = F.pad(dense, (0, 0, 1, 1, 1, 1, 1, 1))
    for o, (dx, dy, dz) in enumerate(tile_offsets().tolist()):
        if (dx, dy, dz) == (0, 0, 0):
            continue
        slab = dense[:, src[dx], src[dy], src[dz], :][ts.nbr[:, o]]
        halo[:cap, dst[dx], dst[dy], dst[dz], :] = slab
    return halo


def tile_subm_conv(dense: torch.Tensor, weights: torch.Tensor, ts: TileSet,
                   compute_dtype=None, impl: str = "conv") -> torch.Tensor:
    """Submanifold conv on dense tiles, output masked to active cells.
    ``impl="conv"``: one ``F.conv3d`` over the halo'd tiles, TF32 off on the
    card (:func:`.bricks.conv3d_no_tf32`); ``"slice"``: 27 static-slice
    matmuls. Operands are rounded to ``compute_dtype`` and summed in f32."""
    dtype = compute_dtype or dense.dtype
    cin, cout = dense.shape[-1], weights.shape[-1]
    n = dense.shape[1]
    halo = halo_expand(dense, ts).to(dtype).float()
    w = weights.to(dtype).float()
    if impl == "conv":
        out = conv3d_no_tf32(halo.permute(0, 4, 1, 2, 3), conv3d_kernel(w))
        out = out.permute(0, 2, 3, 4, 1)
    elif impl == "slice":
        rows = dense.shape[0]
        out = halo.new_zeros((rows, n, n, n, cout))
        for o, (dx, dy, dz) in enumerate(tile_offsets().tolist()):
            slab = halo[:, 1 + dx:1 + dx + n, 1 + dy:1 + dy + n,
                        1 + dz:1 + dz + n, :]
            out = out + (slab.reshape(-1, cin) @ w[o]).reshape(
                rows, n, n, n, cout)
    else:
        raise ValueError(f"tile_subm_conv: unknown impl {impl!r}")
    return out * ts.active
