"""Space-filling-curve codes of grid coordinates: z-order and Hilbert.

Port of ``treemorph_tpu/ops/serialization.py`` (encoders only). The JAX
package keeps the 3*depth-bit key as a (hi, lo) pair of uint32 words; here
it is one int64, which orders exactly like the lexicographic (hi, lo) pair
and equals ``(hi << 32) | lo`` bit for bit. The transposed orders swap x
and y before encoding.
"""

from __future__ import annotations

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _interleave(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Bit i of x lands at position 3i+2, y at 3i+1, z at 3i."""
    code = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(depth):
        for dim, c in enumerate((x, y, z)):
            code |= ((c >> i) & 1) << (3 * i + (2 - dim))
    return code


def z_order_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Morton code of (N, 3) integer coordinates in [0, 2^depth); (N,)
    int64."""
    if depth > 16:
        raise ValueError(f"z-order depth {depth} > 16")
    c = grid_coord.to(torch.int64)
    return _interleave(c[:, 0], c[:, 1], c[:, 2], depth)


def hilbert_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Hilbert code by the Skilling transform (each axis's bits packed in
    one integer; "invert / exchange the lower bits" is an XOR against a
    lower-bit mask), interleaved like the z-order code, then gray-decoded
    with a prefix XOR. (N,) int64."""
    if depth > 16:
        raise ValueError(f"Hilbert depth {depth} > 16")
    X = [grid_coord[:, d].to(torch.int64) for d in range(3)]
    for bit in range(depth - 1):
        shift = depth - 1 - bit
        lower = (1 << shift) - 1
        for dim in range(3):
            d = X[dim]
            m = (d >> shift) & 1
            inv = X[0] ^ (m * lower)
            t = torch.where(m == 1, 0, (inv ^ d) & lower)
            X[dim] = d ^ t
            X[0] = inv ^ t
    code = _interleave(X[0], X[1], X[2], depth)
    for s in (1, 2, 4, 8, 16, 32):
        code ^= code >> s
    return code


def encode(
    grid_coord: torch.Tensor,
    batch: torch.Tensor | None = None,
    depth: int = 16,
    order: str = "z",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serialize grid coordinates along a curve. Returns ``(batch, code)``:
    sorting by batch, then code is the order of the packed
    ``batch << 3*depth | code`` key."""
    if order not in ORDERS:
        raise ValueError(f"unknown serialization order {order!r}")
    if order.endswith("-trans"):
        grid_coord = grid_coord[:, [1, 0, 2]]
    if order.startswith("z"):
        code = z_order_encode(grid_coord, depth=depth)
    else:
        code = hilbert_encode(grid_coord, depth=depth)
    if batch is None:
        batch = torch.zeros(
            grid_coord.shape[0], dtype=torch.int32, device=grid_coord.device
        )
    return batch.to(torch.int32), code
