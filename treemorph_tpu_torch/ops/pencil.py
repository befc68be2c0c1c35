"""Pencil-layout submanifold conv engine (TreeLearn's ``engine="pencil"``).

Port of ``treemorph_tpu/ops/pencil.py``: the gather engine's function
(:mod:`.sparse`, spconv's ``SubMConv3d``; reference
``Modules/TreeLearn/blocks.py:44-151``) over **z-pencils**: groups of
``cells`` (default 4) consecutive-z voxels of one (b, x, y) column packed
into one ``cells*C`` row, so a 3x3x3 conv needs the 9 xy-neighbor pencils of
each pencil instead of 27 voxel neighbors of each voxel:

1. Voxels arrive lex-sorted by (b, x, y, z) (:func:`.sparse.dedup_sort_perm`
   order), so a pencil's z+-1 sibling pencils are its adjacent rows, and the
   conv's cross-pencil terms are shifts (:func:`extend_rows`).
2. The conv's z direction is a banded block-Toeplitz matmul
   (:func:`banded_weights`); plain ``torch.matmul``, as the JAX package
   computes it outside any Pallas kernel.
3. Submanifold semantics: inputs and outputs are masked by each cell's
   activity.

The backward is the JAX package's custom VJP: the 9-offset pencil rulebook
is antisymmetric (``rulebook[p, j] == q <=> rulebook[q, 8-j] == p``), so
``d_core`` is 9 gathers of the output gradient through the mirrored
columns, with no scatter.

Neighbor pencils come from :func:`.sparse.lookup` (exact, over the rows the
JAX hash table keeps), which equals the JAX lookup with ``verify_coords``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sparse import build_key_table, dedup_sort_perm, lookup

#: default voxels per pencil (its z extent); a power of two
CELLS = 4
_MAX_BLOCK = 4  # output cells per banded matmul block


def _block_of(cells: int) -> int:
    return min(_MAX_BLOCK, cells)


class PencilStructure(NamedTuple):
    """Static-shape pencil view of one voxel level; every row array holds a
    trailing dump row (index P, the capacity) that stays zero / invalid."""

    keys: torch.Tensor  # (P+1, 4) int64 (b, x, y, t); -1 where unused
    row_valid: torch.Tensor  # (P+1,) bool
    slot: torch.Tensor  # (M,) int64 voxel -> row*cells + cell; P*cells dump
    cell_active: torch.Tensor  # (P+1, cells) float32, 1 at active cells
    has_prev: torch.Tensor  # (P+1,) bool: row-1 is the z-1 sibling
    has_next: torch.Tensor  # (P+1,) bool
    rulebook: torch.Tensor  # (P+1, 9) int64 xy-neighbor rows; missing = P
    num_pencils: torch.Tensor  # () int64
    overflow: torch.Tensor  # () int64 voxels dropped by the cap


def build_pencils(coords: torch.Tensor, valid: torch.Tensor, cap: int,
                  cells: int = CELLS) -> PencilStructure:
    """Group a lex-sorted voxel level (valid rows first) into z-pencils,
    closed under ghosts: an empty pencil at t-1 and t+1 of every pencil, so
    that a center whose neighbor column holds voxels only across a pencil
    boundary still finds a row to gather (its extended row carries the
    boundary cells). Pencil rows past ``cap`` (reals and ghosts) are
    dropped and their voxels counted in ``overflow``."""
    if cells & (cells - 1):
        raise ValueError("cells must be a power of two")
    m = coords.shape[0]
    dev = coords.device
    c = coords.to(torch.int64)
    t = c[:, 3] >> (cells.bit_length() - 1)
    cell = c[:, 3] & (cells - 1)
    pkey = torch.stack([c[:, 0], c[:, 1], c[:, 2], t], dim=1)
    ez = torch.tensor([0, 0, 0, 1], device=dev)
    cand = torch.cat([pkey, pkey - ez, pkey + ez])  # (3M, 4)
    cand_valid = torch.cat([valid, valid & (t >= 1), valid])

    perm = dedup_sort_perm(cand, cand_valid)
    s_key, s_valid = cand[perm], cand_valid[perm]
    new = torch.ones(3 * m, dtype=torch.bool, device=dev)
    new[1:] = (s_key[1:] != s_key[:-1]).any(dim=1)
    new |= ~s_valid
    s_gid = torch.cumsum(new, 0) - 1
    num_pencils = torch.where(s_valid, s_gid + 1, 0).max().clamp(max=cap)

    g_of_cand = torch.empty(3 * m, dtype=torch.int64, device=dev)
    g_of_cand[perm] = s_gid.clamp(max=cap)
    row = g_of_cand[:m]
    in_cap = valid & (row < cap)
    overflow = (valid & ~in_cap).sum()
    slot = torch.where(in_cap, row * cells + cell, cap * cells)

    keys = torch.full((cap + 1, 4), -1, dtype=torch.int64, device=dev)
    keys[torch.where(s_valid, s_gid.clamp(max=cap), cap)] = s_key
    row_valid = torch.arange(cap + 1, device=dev) < num_pencils
    cell_active = torch.zeros((cap + 1) * cells, device=dev)
    cell_active[slot] = valid.float()
    cell_active = cell_active.reshape(cap + 1, cells)
    cell_active[cap] = 0.0

    prev_k, cur_k = keys[:-1], keys[1:]
    sib = ((prev_k[:, :3] == cur_k[:, :3]).all(dim=1)
           & (prev_k[:, 3] + 1 == cur_k[:, 3])
           & row_valid[:-1] & row_valid[1:])
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    has_prev = torch.cat([no, sib])
    has_next = torch.cat([sib, no])

    table = build_key_table(keys[:cap], row_valid[:cap])
    arange = torch.arange(cap + 1, device=dev)
    cols = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                cols.append(torch.where(row_valid, arange, cap))
                continue
            q = keys.clone()
            q[:, 1] += dx
            q[:, 2] += dy
            idx = lookup(table, q)
            cols.append(torch.where(row_valid & (idx >= 0), idx, cap))
    return PencilStructure(
        keys=keys, row_valid=row_valid, slot=slot, cell_active=cell_active,
        has_prev=has_prev, has_next=has_next,
        rulebook=torch.stack(cols, dim=1), num_pencils=num_pencils,
        overflow=overflow,
    )


def to_pencil(feats: torch.Tensor, ps: PencilStructure) -> torch.Tensor:
    """(M, C) voxel features -> (P+1, cells*C) pencil core (dump row 0)."""
    cap1, cells = ps.cell_active.shape
    c = feats.shape[-1]
    flat = feats.new_zeros((cap1 * cells, c)).index_put((ps.slot,), feats)
    flat = flat.reshape(cap1, cells * c)
    # overflow voxels land in the dump row: keep it zero
    return torch.cat([flat[:-1], flat.new_zeros((1, cells * c))])


def from_pencil(core: torch.Tensor, ps: PencilStructure) -> torch.Tensor:
    """(P+1, cells*C) pencil core -> (M, C) voxel features."""
    cap1, cells = ps.cell_active.shape
    return core.reshape(cap1 * cells, core.shape[1] // cells)[ps.slot]


def extend_rows(core, has_prev, has_next, cells: int) -> torch.Tensor:
    """(P+1, E) -> (P+1, E+2C): the z-1 sibling's last cell before each row
    and the z+1 sibling's first cell after it (two shifts)."""
    e = core.shape[1]
    c = e // cells
    z = core.new_zeros((1, c))
    prev_last = torch.cat([z, core[:-1, e - c:]]) * has_prev[:, None]
    next_first = torch.cat([core[1:, :c], z]) * has_next[:, None]
    return torch.cat([prev_last, core, next_first], dim=1)


def banded_weights(weights: torch.Tensor, cells: int = CELLS) -> torch.Tensor:
    """(27, Cin, Cout) kernel (kernel-offset order: dx slowest, dz fastest)
    -> (9, (block+2)*Cin, block*Cout) banded block-Toeplitz matrices, one
    per xy offset: row block r, column block u holds W[(j, dz=r-u)] where
    0 <= r-u < 3 (window cells [4k-1, 4k+5) hit output cells [4k, 4k+4) at
    z offset r-u-1)."""
    k, cin, cout = weights.shape
    if k != 27:
        raise ValueError("the pencil engine takes 3x3x3 kernels")
    block = _block_of(cells)
    w9 = weights.reshape(9, 3, cin, cout)
    zero = weights.new_zeros((9, cin, cout))
    rows = [torch.cat([w9[:, r - u] if 0 <= r - u < 3 else zero
                       for u in range(block)], dim=2)
            for r in range(block + 2)]
    return torch.cat(rows, dim=1)


def pencil_conv_apply(core, weights, ps: PencilStructure,
                      compute_dtype=None) -> torch.Tensor:
    """Submanifold 3x3x3 conv on the pencil layout -> (P+1, cells*Cout),
    inputs and outputs masked by ``cell_active``. Operands are rounded to
    ``compute_dtype`` and multiplied in f32."""
    cells = ps.cell_active.shape[1]
    cin = core.shape[1] // cells
    dtype = compute_dtype or core.dtype
    act = ps.cell_active
    masked = (core.reshape(*act.shape, cin) * act[..., None]).reshape(
        core.shape)
    banded = banded_weights(weights, cells)
    out = _PencilConv.apply(masked, banded, ps.rulebook, ps.has_prev,
                            ps.has_next, ps.row_valid, dtype, cells)
    cout = banded.shape[-1] // _block_of(cells)
    return (out.reshape(*act.shape, cout) * act[..., None]).reshape(
        out.shape[0], -1)


def _pencil_conv_impl(dtype, cells, core, banded, rulebook, has_prev,
                      has_next):
    block = _block_of(cells)
    cin = core.shape[1] // cells
    acc = torch.promote_types(dtype, torch.float32)
    ext = extend_rows(core, has_prev, has_next, cells).to(dtype).to(acc)
    bd = banded.to(dtype).to(acc)
    outs = [0.0] * (cells // block)
    for j in range(9):
        win = ext[rulebook[:, j]]  # missing -> the zero dump row
        for k in range(cells // block):
            s = win[:, k * block * cin:(k * block + block + 2) * cin]
            outs[k] = outs[k] + s @ bd[j]
    return torch.cat(outs, dim=1)


class _PencilConv(torch.autograd.Function):
    """The pencil conv with the JAX package's custom VJP
    (``_pencil_conv_bwd``)."""

    @staticmethod
    def forward(ctx, core, banded, rulebook, has_prev, has_next, row_valid,
                dtype, cells):
        ctx.save_for_backward(core, banded, rulebook, has_prev, has_next,
                              row_valid)
        ctx.dtype, ctx.cells = dtype, cells
        return _pencil_conv_impl(dtype, cells, core, banded, rulebook,
                                 has_prev, has_next)

    @staticmethod
    def backward(ctx, g):
        core, banded, rulebook, has_prev, has_next, row_valid = (
            ctx.saved_tensors)
        dtype, cells = ctx.dtype, ctx.cells
        p1 = core.shape[0]
        block = _block_of(cells)
        cin = core.shape[1] // cells
        cout = banded.shape[-1] // block
        acc = torch.promote_types(dtype, torch.float32)
        bd = banded.to(dtype).to(acc)
        # rows past num_pencils gave no output: zero their gradient so the
        # mirrored gathers are exact transposes
        g = (g * row_valid[:, None]).to(dtype).to(acc)
        ext = extend_rows(core, has_prev, has_next, cells).to(dtype).to(acc)
        d_ext = torch.zeros((p1, (cells + 2) * cin), dtype=acc,
                            device=core.device)
        d_banded = torch.zeros(banded.shape, dtype=acc, device=core.device)
        for j in range(9):
            # the mirrored xy offset: the forward gather's transpose
            gj = g[rulebook[:, 8 - j]]
            win = ext[rulebook[:, j]]
            for k in range(cells // block):
                cols = slice(k * block * cout, (k + 1) * block * cout)
                lo = k * block * cin
                d_ext[:, lo:lo + (block + 2) * cin] += gj[:, cols] @ bd[j].T
                d_banded[j] += win[:, lo:lo + (block + 2) * cin].T @ g[:, cols]
        # the transpose of extend_rows: un-shift the two boundary cells
        e = cells * cin
        d_core = d_ext[:, cin:cin + e].clone()
        up = d_ext[:, :cin] * has_prev[:, None]
        d_core[:-1, e - cin:] += up[1:]
        down = d_ext[:, cin + e:] * has_next[:, None]
        d_core[1:, :cin] += down[:-1]
        return (d_core.to(core.dtype), d_banded.to(banded.dtype), None, None,
                None, None, None, None)
