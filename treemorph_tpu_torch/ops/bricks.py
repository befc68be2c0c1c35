"""Dense-brick submanifold conv engine.

Port of ``treemorph_tpu/ops/bricks.py``. Active voxels are grouped into
4x4x4 bricks (brick key = coords >> 2); per level their features live in a
dense (B, 4, 4, 4, C) tensor (:func:`to_dense`, :func:`from_dense`). A conv
gathers each brick's one-voxel halo from its 26 neighbor bricks
(:func:`_halo_pad`) and runs one dense 3^3 conv over the halo'd
(B, 6, 6, 6, C) tensor; masking the outputs to active voxels restores
submanifold semantics. ``impl="conv"`` is one ``F.conv3d`` (the JAX
package's ``lax.conv``), ``impl="xslab"`` three banded x-slab matmuls. The
hand-written kernel over the same halo'd tensor is
:func:`.brick_conv.brick_conv`.

Neighbor bricks are found with :func:`.sparse.build_rulebook`'s exact
lookup over the unique brick coordinates; the JAX package looks them up in
its dual-hash table, whose rare false hits (~1e-7 per lookup) are a
documented deviation of the reference. Bricks sort in the JAX package's
order, so brick ids, and every tensor indexed by them, match.

TreeLearn's ``engine="brick"`` runs this engine with ``impl="conv"`` or
``"xslab"``, as the JAX package's does: not the hand kernel, which its
brick engine does not call either. ``impl="conv"`` on the card runs cuDNN
in full f32 (:func:`conv3d_no_tf32`): PyTorch lets cuDNN use TF32 by
default, and the f32 engine would then round its operands to 10 bits.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .brick_conv import DIRS27
from .sparse import build_rulebook
from .voxelize import sorted_runs

BRICK = 4  # brick edge in voxels
CELLS = BRICK**3
_INT32_MIN = -(2**31)


class BrickStructure(NamedTuple):
    """Static-shape brick decomposition of a voxel set."""

    brick_id: torch.Tensor  # (M,) int64 voxel -> brick (cap = overflow dump)
    cell: torch.Tensor  # (M, 3) int64 within-brick cell coords
    brick_coords: torch.Tensor  # (Bcap, 4) int32 (b, bx, by, bz)
    brick_valid: torch.Tensor  # (Bcap,) bool
    brick_nbrs: torch.Tensor  # (Bcap, 27) int64 neighbor brick or Bcap
    num_bricks: torch.Tensor  # () int64


def _segment_max(values, ids, segments):
    """Per-segment max of int rows; an empty segment gives INT32_MIN, the
    identity of the JAX package's ``segment_max`` on int32."""
    out = torch.full((segments, *values.shape[1:]), _INT32_MIN,
                     dtype=values.dtype, device=values.device)
    idx = ids.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax")


def brickize(coords: torch.Tensor, valid: torch.Tensor,
             cap: int) -> BrickStructure:
    """Group voxels into bricks, lex-sorted by (b, bx, by, bz); build the
    27-neighbor brick rulebook. Bricks past ``cap`` are dropped
    (``brick_id == cap``). Rows of a brick that holds only invalid voxels
    carry coordinates -1, rows of no brick INT32_MIN (as the JAX
    package's segment maxima give them); neither is valid."""
    m = coords.shape[0]
    c = coords.to(torch.int64)
    b = c[:, 0]
    bxyz = c[:, 1:] >> 2
    cell = c[:, 1:] & 3
    r = sorted_runs(torch.cat([b[:, None], bxyz], dim=1), valid)
    num_bricks = r.num.clamp(max=cap)
    brick_id = torch.empty(m, dtype=torch.int64, device=coords.device)
    brick_id[r.s_orig] = r.s_id.clamp(max=cap)

    brick_b = _segment_max(torch.where(valid, b, -1), brick_id, cap + 1)
    brick_xyz = _segment_max(torch.where(valid[:, None], bxyz, -1), brick_id,
                             cap + 1)
    brick_coords = torch.cat([brick_b[:cap, None], brick_xyz[:cap]], dim=1)
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=coords.device)
    counts.index_add_(0, brick_id, valid.to(torch.int64))
    brick_valid = counts[:cap] > 0
    # the rulebook's identity column is the brick itself, its missing
    # entries are cap: the JAX lookup's neighbor table, kernel-offset order
    nbrs = build_rulebook(brick_coords, brick_valid, 3)
    return BrickStructure(
        brick_id=brick_id,
        cell=cell,
        brick_coords=brick_coords.to(torch.int32),
        brick_valid=brick_valid,
        brick_nbrs=nbrs,
        num_bricks=num_bricks,
    )


def to_dense(feats: torch.Tensor, bs: BrickStructure) -> torch.Tensor:
    """(M, C) flat features -> (Bcap+1, 4, 4, 4, C) dense (the last brick
    is the overflow/missing dump, kept zero)."""
    cap = bs.brick_coords.shape[0]
    dense = torch.zeros((cap + 1, BRICK, BRICK, BRICK, feats.shape[-1]),
                        dtype=feats.dtype, device=feats.device)
    dense[bs.brick_id, bs.cell[:, 0], bs.cell[:, 1], bs.cell[:, 2]] = feats
    return dense


def from_dense(dense: torch.Tensor, bs: BrickStructure) -> torch.Tensor:
    """(Bcap+1, 4, 4, 4, C) dense -> (M, C) flat features."""
    return dense[bs.brick_id, bs.cell[:, 0], bs.cell[:, 1], bs.cell[:, 2]]


def _halo_pad(dense: torch.Tensor, bs: BrickStructure) -> torch.Tensor:
    """(Bcap+1, 4,4,4, C) -> (Bcap, 6,6,6, C) with 1-voxel halos gathered
    from the 26 neighbor bricks (a missing neighbor is the dump brick, all
    zeros), assembled by nested concatenation."""
    cap = bs.brick_coords.shape[0]

    def side(d):
        # the neighbor at direction d contributes its far-side cells
        return {1: slice(0, 1), -1: slice(BRICK - 1, BRICK),
                0: slice(0, BRICK)}[d]

    def block(d):
        if d == (0, 0, 0):
            return dense[:cap]
        nbr = bs.brick_nbrs[:, DIRS27.index(d)]  # (Bcap,), cap = dump
        return dense[:, side(d[0]), side(d[1]), side(d[2])][nbr]

    return torch.cat([
        torch.cat([
            torch.cat([block((dx, dy, dz)) for dz in (-1, 0, 1)], dim=3)
            for dy in (-1, 0, 1)
        ], dim=2)
        for dx in (-1, 0, 1)
    ], dim=1)


def _xslab_selector(device=None) -> torch.Tensor:
    """0/1 tensor S (9, 36, 16) mapping a (dy, dz) kernel tap to its
    positions in the x-slab banded matrix: S[dy*3+dz, r, cb] = 1 iff
    r == (yo+dy)*6 + (zo+dz) and cb == yo*4 + zo for a core output cell
    (yo, zo) in [0, 4)^2."""
    s = torch.zeros((9, 36, 16), device=device)
    for dy in range(3):
        for dz in range(3):
            for yo in range(4):
                for zo in range(4):
                    s[dy * 3 + dz, (yo + dy) * 6 + (zo + dz), yo * 4 + zo] = 1
    return s


def _xslab_weights(weights: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) kernel -> (3, 36*Cin, 16*Cout) banded x-slab
    matrices (one einsum with the 0/1 selector, so weight gradients flow
    through it)."""
    cin, cout = weights.shape[1], weights.shape[2]
    w = weights.reshape(3, 9, cin, cout)
    s = _xslab_selector(weights.device).to(weights.dtype)
    wb = torch.einsum("jrb,xjio->xribo", s, w)
    return wb.reshape(3, 36 * cin, 16 * cout)


def _xslab_conv(padded, weights, compute_dtype):
    """Banded x-slab matmul conv on the halo'd (B, 6, 6, 6, Cin) tensor: the
    (y, z, c) axes fuse into one 36*Cin column axis, and each x-offset dx is
    ONE (B*4, 36*Cin) x (36*Cin, 16*Cout) product against a banded weight
    matrix. Operands are rounded to ``compute_dtype`` and multiplied in
    f32."""
    b, cin = padded.shape[0], padded.shape[-1]
    cout = weights.shape[-1]
    dtype = compute_dtype or padded.dtype
    p = padded.reshape(b, 6, 36 * cin).to(dtype).float()
    w = _xslab_weights(weights).to(dtype).float()
    out = torch.zeros((b * 4, 16 * cout), dtype=torch.float32,
                      device=padded.device)
    for dx in range(3):
        # one (B*4, 36*Cin) GEMM: a sliced 3-D operand would go to a
        # batched GEMM of B tiny products
        out = out + p[:, dx:dx + 4, :].reshape(b * 4, 36 * cin) @ w[dx]
    return out.reshape(b, BRICK, BRICK, BRICK, cout)


def conv3d_kernel(weights: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) kernel-offset weights as ``F.conv3d``'s
    (Cout, Cin, 3, 3, 3): offset (dx, dy, dz) is tap (dx+1, dy+1, dz+1)
    of the correlation."""
    return weights.reshape(3, 3, 3, *weights.shape[1:]).permute(4, 3, 0, 1, 2)


@contextlib.contextmanager
def _cudnn_without_tf32():
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _Conv3dNoTF32(torch.autograd.Function):
    """``F.conv3d`` (no padding, stride 1) whose forward and backward both
    run with cuDNN's TF32 off, whatever the global setting; the setting is
    restored after each call."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _cudnn_without_tf32():
            return F.conv3d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        with _cudnn_without_tf32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv3d_input(x.shape, w, g)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv3d_weight(x, w.shape, g)
        return dx, dw


def conv3d_no_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv3d(x, w)`` in full f32 on the card, forward and backward:
    cuDNN's TF32 is switched off for the call only."""
    return _Conv3dNoTF32.apply(x, w)


def brick_subm_conv(
    dense: torch.Tensor,  # (Bcap+1, 4,4,4, C) active-masked features
    weights: torch.Tensor,  # (K=27, Cin, Cout) in kernel-offset order
    bs: BrickStructure,
    active: torch.Tensor,  # (Bcap+1, 4,4,4, 1) activity mask
    impl: str = "conv",
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold 3^3 conv on the dense brick tensor -> the same layout.

    out[v] = sum_k W[k] @ feat[v + off_k] with the offsets of
    :func:`.sparse.kernel_offsets`: a correlation over the halo'd tensor,
    which is what ``F.conv3d`` computes with :func:`conv3d_kernel`.
    ``impl``: 'conv' = one ``F.conv3d`` on the halo'd tensor's
    channels-first view, in full f32 (:func:`conv3d_no_tf32`: TF32 off for
    the call, forward and backward); 'xslab' = :func:`_xslab_conv`, the
    only impl that honors ``compute_dtype`` (its f32 products are
    ``torch.matmul``'s, which PyTorch keeps out of TF32 by default)."""
    cout = weights.shape[-1]
    padded = _halo_pad(dense, bs)  # (Bcap, 6,6,6, Cin)
    if impl == "xslab":
        out = _xslab_conv(padded, weights, compute_dtype)
    elif impl == "conv":
        out = conv3d_no_tf32(padded.permute(0, 4, 1, 2, 3),
                             conv3d_kernel(weights))
        out = out.permute(0, 2, 3, 4, 1).float()  # (Bcap, 4,4,4, Cout)
    else:
        raise ValueError(f"brick_subm_conv: unknown impl {impl!r}")
    out = torch.cat([out, out.new_zeros((1, BRICK, BRICK, BRICK, cout))])
    return out * active
