"""Z-order (Morton) codes of grid coordinates.

The port carries the part of ``treemorph_tpu/ops/serialization.py`` that the
device upsampler needs: the z-order code at depth <= 16. The JAX package
keeps the 3*depth-bit key as a (hi, lo) pair of uint32 words; here it is one
int64, which orders exactly like the lexicographic (hi, lo) pair.
"""

from __future__ import annotations

import torch

ORDERS = ("z", "z-trans")


def z_order_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Morton code: bit i of x lands at position 3i+2, y at 3i+1, z at 3i.

    ``grid_coord`` is (N, 3) integer, each coordinate in [0, 2^depth).
    Returns (N,) int64."""
    if depth > 16:
        raise ValueError(f"z-order depth {depth} > 16")
    c = grid_coord.to(torch.int64)
    code = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for i in range(depth):
        for dim in range(3):
            code |= ((c[:, dim] >> i) & 1) << (3 * i + (2 - dim))
    return code


def encode(
    grid_coord: torch.Tensor,
    batch: torch.Tensor | None = None,
    depth: int = 16,
    order: str = "z",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serialize grid coordinates along the z-order curve. The transposed
    order swaps x and y first. Returns ``(batch, code)``: sorting by
    batch, then code is the order of the packed ``batch << 3*depth | code``
    key."""
    if order not in ORDERS:
        raise NotImplementedError(f"serialization order {order!r} is not ported")
    if order.endswith("-trans"):
        grid_coord = grid_coord[:, [1, 0, 2]]
    code = z_order_encode(grid_coord, depth=depth)
    if batch is None:
        batch = torch.zeros(
            grid_coord.shape[0], dtype=torch.int32, device=grid_coord.device
        )
    return batch.to(torch.int32), code
