"""Submanifold sparse 3D convolution: rulebook, gather engine, strided
down/inverse convs.

Port of the main-path part of ``treemorph_tpu/ops/sparse.py``:

1. **Rulebook**: for each row and each kernel offset, the index of the
   neighbor row (or M, a zero pad row), shared by every submanifold conv
   at one level. The JAX package looks neighbors up in a dual-hash table
   that keeps the first 16 valid rows (by index) of each hash bucket;
   here the same rows are kept (:func:`table_rows`) and the lookup over
   them is exact: their packed lexicographic keys are sorted once (stably)
   and every query is one ``searchsorted``. Where several kept rows share
   a coordinate (PTv3's level 0 holds points, not voxels), a lookup
   returns the largest of their row indices, as the JAX lookup's ``max``
   over matching lanes does. The result equals the JAX rulebook built with
   ``verify_coords=True`` for every input; on unique rows whose buckets
   hold at most 16 rows it keeps the antisymmetry
   ``rb[i, k] == j  <=>  rb[j, K-1-k] == i``.
2. **Gather engine** (:func:`_subm_conv_impl`):
   ``out = sum_k feats[rb[:, k]] @ W[k]`` with f32 accumulation; the band
   engine (:mod:`.bandconv`) falls back to it when its plan overflows. Its
   gradient (:class:`_SubmConv`) is the JAX package's custom VJP: K gathers
   through the mirrored rulebook columns and no scatter, so it sums in one
   order on the card too.
3. **Strided convs**: the stride-2 coarse level comes from the same sorted
   dedup as :mod:`.voxelize` and records each fine voxel's ``parent`` and
   child octant, so the down conv is a scatter-add and the inverse conv a
   gather. :func:`build_dedup` is the same sort at stride 1 (points to
   unique voxels), and :func:`dedup_sort_perm` its permutation alone
   (PTv3 re-stores its pooled levels in lex order with it).
4. **Z-pack engine** (:class:`ZPlan`, :func:`build_zplan`,
   :func:`subm_conv_zpack_apply`): over lex-sorted voxels a k^3 conv as
   k^2 gathers of z-packed rows, with the JAX package's custom VJP.
5. **Octant-run table** (:class:`RunTable`, :func:`build_rulebook_runs`):
   the JAX package's other route to the rulebook of lex-sorted voxels, the
   same rulebook.

Index tensors are int64 (torch's index type); ``valid`` masks thread
through every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .voxelize import COORD_BITS, first_rows_of_runs, pack_keys, sorted_runs


def kernel_offsets(kernel_size: int = 3, device=None) -> torch.Tensor:
    """(K, 3) integer offsets of a cubic kernel, centered for odd sizes,
    dz fastest."""
    r = range(kernel_size)
    shift = (kernel_size - 1) // 2
    offs = [
        (dx - shift, dy - shift, dz - shift)
        for dx in r
        for dy in r
        for dz in r
    ]
    return torch.tensor(offs, dtype=torch.int64, device=device)


#: valid rows the JAX package's hash table keeps per bucket (its
#: ``SLOTS_PER_BUCKET``: one 128-byte row of 16 indices and 16 hashes)
SLOTS_PER_BUCKET = 16
_U32 = 0xFFFFFFFF


def _spatial_hash(coords: torch.Tensor) -> torch.Tensor:
    """The JAX package's bucket hash of (b, x, y, z) rows: uint32 products
    XORed, here as int64 masked to 32 bits."""
    c = coords.to(torch.int64)
    return (((c[:, 0] * 2654435761) & _U32)
            ^ ((c[:, 1] * 73856093) & _U32)
            ^ ((c[:, 2] * 19349663) & _U32)
            ^ ((c[:, 3] * 83492791) & _U32))


def table_rows(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M,) bool: the valid rows the JAX package's ``build_table`` stores.
    Its ``t = 2^bitlen(max(8M - 1, 127))`` slots form ``t / 16`` buckets;
    each valid row's lane is its rank by row index among the valid rows of
    its bucket, and rows at lane 16 or above are dropped."""
    m = coords.shape[0]
    slots = 1 << max(8 * m - 1, 127).bit_length()
    n_buckets = slots // SLOTS_PER_BUCKET
    bucket = _spatial_hash(coords) & (n_buckets - 1)
    s_bucket, perm = torch.sort(torch.where(valid, bucket, n_buckets),
                                stable=True)
    pos = torch.arange(m, device=coords.device)
    first = torch.ones(m, dtype=torch.bool, device=coords.device)
    first[1:] = s_bucket[1:] != s_bucket[:-1]
    lane = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    kept = torch.empty_like(valid)
    kept[perm] = lane < SLOTS_PER_BUCKET
    return kept & valid


class KeyTable(NamedTuple):
    """Exact lookup over the rows the JAX package's hash table keeps
    (:func:`table_rows`): their packed keys, sorted stably, and the sort's
    permutation."""

    keys: torch.Tensor  # (M,) int64 sorted packed keys, sentinels last
    perm: torch.Tensor  # (M,) int64 row of each sorted key


def build_key_table(coords: torch.Tensor, valid: torch.Tensor) -> KeyTable:
    keys = pack_keys(coords, table_rows(coords, valid))
    s_key, perm = torch.sort(keys, stable=True)
    return KeyTable(s_key, perm)


def lookup(table: KeyTable, query: torch.Tensor) -> torch.Tensor:
    """Row of each (..., 4) query coordinate in ``table``, or -1: the
    largest row index among the kept rows with that coordinate (a stable
    sort keeps equal keys in index order, and the right-side
    ``searchsorted`` lands on the last), as the JAX lookup's ``max`` over
    matching lanes returns it. Coordinates outside [0, 2^19) are never
    found."""
    q = query.to(torch.int64)
    limit = 1 << COORD_BITS
    in_range = ((q[..., 1:] >= 0) & (q[..., 1:] < limit)).all(dim=-1)
    qkey = (
        (q[..., 0] << (3 * COORD_BITS))
        | (q[..., 1] << (2 * COORD_BITS))
        | (q[..., 2] << COORD_BITS)
        | q[..., 3]
    )
    pos = (torch.searchsorted(table.keys, qkey.reshape(-1), right=True)
           - 1).clamp(min=0).reshape(qkey.shape)
    hit = (table.keys[pos] == qkey) & in_range
    return torch.where(hit, table.perm[pos], -1)


def build_rulebook(
    coords: torch.Tensor,
    valid: torch.Tensor,
    kernel_size: int = 3,
) -> torch.Tensor:
    """(M, K) int64 neighbor indices for a submanifold conv; M marks
    'missing'. ``coords`` is (M, 4) (b, x, y, z). The center column is the
    row itself; another offset looks its coordinate up among the rows the
    JAX hash table keeps (:func:`lookup`), or gives M when the table kept
    none."""
    m = coords.shape[0]
    if kernel_size % 2 != 1:
        raise ValueError("submanifold rulebooks need odd kernels")
    dev = coords.device
    table = build_key_table(coords, valid)
    offs = kernel_offsets(kernel_size, dev)
    k = offs.shape[0]
    half = k // 2
    c = coords.to(torch.int64)
    columns = []
    for j in range(k):
        if j == half:  # identity center column
            columns.append(
                torch.where(valid, torch.arange(m, device=dev), m)
            )
            continue
        q = c.clone()
        q[:, 1:] += offs[j]
        idx = lookup(table, q)
        columns.append(torch.where(valid & (idx >= 0), idx, m))
    return torch.stack(columns, dim=1)


def rulebook_subset_columns(k_from: int, k_to: int) -> list[int]:
    """Columns of the ``k_to`` rulebook inside a ``k_from`` rulebook over
    the same rows (the smaller cube's offsets are a subset of the
    larger's): PTv3's level-0 k=3 rulebook is the k=5 stem rulebook's
    central 27 columns."""
    if not (k_from % 2 == 1 and k_to % 2 == 1 and k_to <= k_from):
        raise ValueError(f"no k={k_to} subset of a k={k_from} rulebook")
    rf, rt = (k_from - 1) // 2, (k_to - 1) // 2
    return [
        ((dx + rf) * k_from + (dy + rf)) * k_from + (dz + rf)
        for dx in range(-rt, rt + 1)
        for dy in range(-rt, rt + 1)
        for dz in range(-rt, rt + 1)
    ]


def subm_conv_apply(
    feats: torch.Tensor,  # (M, Cin)
    weights: torch.Tensor,  # (K, Cin, Cout)
    rulebook,  # (M, K) rulebook, a ZPlan, a BandPlan or a ZBandPlan
    valid: torch.Tensor,  # (M,)
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold conv: out[i] = sum_k W[k] @ feats[nbr_k(i)].

    ``rulebook`` may be a :class:`ZPlan`, a :class:`~.bandconv.BandPlan`
    or a :class:`~.bandconv.ZBandPlan`, selecting the z-pack, the band or
    the z-packed band engine (same weights layout).
    ``compute_dtype=torch.bfloat16`` rounds features (and, on the gather
    and z-pack engines, weights) to bf16; accumulation stays float32
    (float64 for ``torch.float64``, gather and z-pack engines only)."""
    from .bandconv import (
        BandPlan,
        ZBandPlan,
        band_subm_conv_apply,
        zband_subm_conv_apply,
    )

    dtype = compute_dtype or feats.dtype
    if isinstance(rulebook, ZPlan):
        return subm_conv_zpack_apply(feats, weights, rulebook, valid,
                                     compute_dtype=dtype)
    if isinstance(rulebook, ZBandPlan):
        return zband_subm_conv_apply(
            feats, weights, rulebook, valid, compute_dtype=dtype
        )
    if isinstance(rulebook, BandPlan):
        return band_subm_conv_apply(
            feats, weights, rulebook, valid, compute_dtype=dtype
        )
    return _subm_conv(dtype, feats, weights, rulebook, valid)


def _subm_conv_impl(dtype, feats, weights, rulebook, valid):
    """Gather engine: K gathers + (M, Cin) x (Cin, Cout) products. bf16
    operands are rounded first and multiplied in f32 (exact products,
    f32 sums — the JAX package's ``preferred_element_type=f32``)."""
    m, cin = feats.shape
    k = weights.shape[0]
    cout = weights.shape[-1]
    acc = torch.promote_types(dtype, torch.float32)
    feats_pad = torch.cat(
        [
            (feats * valid[:, None]).to(dtype),
            torch.zeros((1, cin), dtype=dtype, device=feats.device),
        ],
        dim=0,
    ).to(acc)
    w = weights.to(dtype).to(acc)
    out = torch.zeros((m, cout), dtype=acc, device=feats.device)
    for j in range(k):
        out = out + feats_pad[rulebook[:, j]] @ w[j]
    return out * valid[:, None]


def _gather_grads(dtype, feats, weights, rulebook, valid, grad,
                  feats_grad: bool = True):
    """``(d_feats, d_weights)`` of the gather engine, f32 (the JAX
    package's ``_subm_conv_bwd``). ``out[t]`` took ``feats[i]`` through
    offset ``j`` exactly when ``rulebook[i, K-1-j] == t`` (antisymmetry), so
    ``d_feats`` gathers the output gradient through the mirrored column:
    the exact transpose of the forward gather, with no scatter.
    ``d_weights`` recomputes the forward gathers and contracts over rows.
    Operands are rounded to ``dtype``; ``d_feats`` is None unless
    ``feats_grad``. Rows that share a coordinate (PTv3's level 0) break
    the antisymmetry, and ``d_feats`` then differs from the forward's true
    transpose: the JAX package's VJP does the same, and the port is held
    to it (ROADMAP.md queue 3)."""
    m, cin = feats.shape
    k, _, cout = weights.shape
    acc = torch.promote_types(dtype, torch.float32)
    w = weights.to(dtype).to(acc)
    g_masked = (grad * valid[:, None]).to(dtype).to(acc)  # (M, Cout)
    g_pad = torch.cat(
        [g_masked, torch.zeros((1, cout), dtype=acc, device=grad.device)]
    )
    feats_pad = torch.cat(
        [
            (feats * valid[:, None]).to(dtype),
            torch.zeros((1, cin), dtype=dtype, device=feats.device),
        ]
    ).to(acc)
    d_feats = (
        torch.zeros((m, cin), dtype=acc, device=feats.device)
        if feats_grad else None
    )
    d_w = []
    for j in range(k):
        if feats_grad:
            d_feats = d_feats + g_pad[rulebook[:, k - 1 - j]] @ w[j].T
        d_w.append(feats_pad[rulebook[:, j]].T @ g_masked)
    if feats_grad:
        d_feats = d_feats * valid[:, None]
    return d_feats, torch.stack(d_w)


class _SubmConv(torch.autograd.Function):
    """The gather engine with the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, feats, weights, rulebook, valid, dtype):
        ctx.save_for_backward(feats, weights, rulebook, valid)
        ctx.dtype = dtype
        return _subm_conv_impl(dtype, feats, weights, rulebook, valid)

    @staticmethod
    def backward(ctx, grad):
        feats, weights, rulebook, valid = ctx.saved_tensors
        d_feats, d_w = _gather_grads(
            ctx.dtype, feats, weights, rulebook, valid, grad,
            ctx.needs_input_grad[0],
        )
        if d_feats is not None:
            d_feats = d_feats.to(feats.dtype)
        return d_feats, d_w.to(weights.dtype), None, None, None


def _subm_conv(dtype, feats, weights, rulebook, valid):
    return _SubmConv.apply(feats, weights, rulebook, valid, dtype)


def dedup_sort_perm(key4: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) int64 permutation bringing equal (b, x, y, z) rows adjacent, in
    lexicographic (b, x, y, z) order, padding last: one stable sort of the
    packed keys (the JAX package's ``lexsort`` of its (hi, lo) lex keys is
    stable too, so ties keep their index order in both)."""
    return torch.sort(pack_keys(key4, valid), stable=True).indices


class DedupMap(NamedTuple):
    """Point rows -> unique-voxel rows (stride-1 dedup): the conv runs once
    per unique voxel, and duplicate rows read its output back through
    ``v2u``. A voxel's representative is its first row by index."""

    rows: torch.Tensor  # (cap,) int64 representative point row per voxel
    coords: torch.Tensor  # (cap, 4) int32 unique (b, x, y, z), lex-sorted
    valid: torch.Tensor  # (cap,) bool
    v2u: torch.Tensor  # (P,) int64 unique id; cap = overflow/invalid dump
    num_unique: torch.Tensor  # () int64
    overflow: torch.Tensor  # () int64 points whose voxel exceeded cap


def build_dedup(
    coords: torch.Tensor, valid: torch.Tensor, cap: int | None = None
) -> DedupMap:
    """Group equal (b, x, y, z) rows with the sort of
    :func:`build_downsample` at stride 1. Unique voxels come out
    lex-sorted; voxels beyond ``cap`` dump to row ``cap`` (counted)."""
    m = coords.shape[0]
    if cap is None:
        cap = m
    dev = coords.device
    r = sorted_runs(coords, valid)
    v2u_full = torch.empty(m, dtype=torch.int64, device=dev)
    v2u_full[r.s_orig] = r.s_id
    v2u = torch.where(valid, v2u_full.clamp(max=cap), cap)
    # valid runs sort first, so unique row r is valid iff r < num
    u_valid = torch.arange(cap, device=dev) < r.num
    rows = torch.where(u_valid, first_rows_of_runs(r, cap), 0)
    u_coords = torch.where(u_valid[:, None], coords[rows], 0)
    return DedupMap(
        rows=rows,
        coords=u_coords.to(torch.int32),
        valid=u_valid,
        v2u=v2u,
        num_unique=r.num.clamp(max=cap),
        overflow=(valid & (v2u_full >= cap)).sum(),
    )


class DownsampleMap(NamedTuple):
    """Fine -> coarse (stride 2) structure."""

    coarse_coords: torch.Tensor  # (cap, 4) int32, padded with -1
    coarse_valid: torch.Tensor  # (cap,) bool
    num_coarse: torch.Tensor  # () int64
    parent: torch.Tensor  # (M,) int64 fine voxel -> coarse index (cap: dropped)
    child_offset: torch.Tensor  # (M,) int64 in [0, 8): fine voxel's octant


def build_downsample(
    coords: torch.Tensor, valid: torch.Tensor, cap: int | None = None
) -> DownsampleMap:
    """Stride-2 coarsening of a voxel set (reference SparseConv3d k=2 s=2,
    TreeLearn/blocks.py:101-112). Coarse voxels come out lex-sorted;
    beyond ``cap`` they are dropped (``parent == cap``)."""
    m = coords.shape[0]
    if cap is None:
        cap = m
    dev = coords.device
    c = coords.to(torch.int64)
    fine = c[:, 1:]
    coarse = fine >> 1  # floor div 2 (coords are non-negative)
    octant = ((fine[:, 0] & 1) << 2) | ((fine[:, 1] & 1) << 1) | (
        fine[:, 2] & 1
    )
    key4 = torch.cat([c[:, :1], coarse], dim=1)
    r = sorted_runs(key4, valid)

    parent = torch.empty(m, dtype=torch.int64, device=dev)
    parent[r.s_orig] = r.s_id
    parent = parent.clamp(max=cap)
    rows = first_rows_of_runs(r, cap)
    coarse_valid = torch.arange(cap, device=dev) < r.num
    rc = c[rows]
    coarse_coords = torch.where(
        coarse_valid[:, None],
        torch.cat([rc[:, :1], rc[:, 1:] >> 1], dim=1),
        -1,
    ).to(torch.int32)
    return DownsampleMap(
        coarse_coords=coarse_coords,
        coarse_valid=coarse_valid,
        num_coarse=r.num.clamp(max=cap),
        parent=parent,
        child_offset=octant,
    )


def down_conv_apply(
    feats: torch.Tensor,  # (M, Cin) fine features
    weights: torch.Tensor,  # (8, Cin, Cout) one filter per octant
    ds: DownsampleMap,
    valid: torch.Tensor,  # (M,) fine validity
    compute_dtype=None,
) -> torch.Tensor:
    """Strided (k=2, s=2) conv:
    coarse[j] = sum_{i: parent(i)=j} W[oct(i)] @ fine[i],
    as 8 masked matmuls and one scatter-add (atomic on CUDA)."""
    m = feats.shape[0]
    cap = ds.coarse_coords.shape[0]
    cout = weights.shape[-1]
    dtype = compute_dtype or feats.dtype
    acc = torch.promote_types(dtype, torch.float32)
    masked = (feats * valid[:, None]).to(dtype)
    w = weights.to(dtype).to(acc)
    contrib = torch.zeros((m, cout), dtype=acc, device=feats.device)
    for k in range(8):
        sel = (ds.child_offset == k).to(dtype)[:, None]
        contrib = contrib + (masked * sel).to(acc) @ w[k]
    out = torch.zeros((cap + 1, cout), dtype=acc, device=feats.device)
    out.index_add_(0, ds.parent, contrib)
    return out[:cap] * ds.coarse_valid[:, None]


def inverse_conv_apply(
    coarse_feats: torch.Tensor,  # (cap, Cin)
    weights: torch.Tensor,  # (8, Cin, Cout)
    ds: DownsampleMap,
    fine_valid: torch.Tensor,  # (M,)
    compute_dtype=None,
) -> torch.Tensor:
    """Inverse of the stride-2 conv (reference SparseInverseConv3d): each
    fine voxel reads its parent's features through its octant filter."""
    m = ds.parent.shape[0]
    cap = ds.coarse_coords.shape[0]
    cout = weights.shape[-1]
    dtype = compute_dtype or coarse_feats.dtype
    parent_ok = ds.parent < cap
    gathered = coarse_feats.to(dtype)[ds.parent.clamp(0, cap - 1)]
    gathered = gathered * parent_ok[:, None].to(dtype)
    acc = torch.promote_types(dtype, torch.float32)
    w = weights.to(dtype).to(acc)
    out = torch.zeros((m, cout), dtype=acc, device=coarse_feats.device)
    for k in range(8):
        sel = (ds.child_offset == k).to(dtype)[:, None]
        out = out + (gathered * sel).to(acc) @ w[k]
    return out * fine_valid[:, None]


# ---------------------------------------------------------------------------
# z-pack submanifold conv: the lex-order formulation
# ---------------------------------------------------------------------------


def plane_offsets(kernel_size: int = 3, device=None) -> torch.Tensor:
    """(K^2, 2) centered (dx, dy) offsets, enumerated so that offset o is
    minus offset K^2 - 1 - o (the mirror behind the z-pack conv's flipped
    kernel in its backward) and the center sits at K^2 // 2."""
    r = range(kernel_size)
    shift = (kernel_size - 1) // 2
    return torch.tensor([(dx - shift, dy - shift) for dx in r for dy in r],
                        dtype=torch.int64, device=device)


class ZPlan(NamedTuple):
    """Per-level structure of the z-pack conv engine (the JAX package's
    ``ZPlan``). Rows must be lex-sorted (b, x, y, z), duplicate-free, with
    padding last, so the voxels of one (b, x, y) column are consecutive rows
    in z order and a z-neighbor within reach 2r of row j sits at row j + s,
    |s| <= 2r. A k^3 conv is then K^2 = k^2 gathers of z-packed rows:

    - the band matrix q (M, (4r+1)C) holds, in band c, the features of the
      column's voxel at z + c (zero where there is none), from shifted
      slices of the features;
    - P = [p^-r; ..; p^+r; 0-row] stacks the alignment views
      p^a = q[:, (r-a)C : (r-a+2r+1)C];
    - ``ext[i, o]`` indexes P at row (a+r)*M + j', j' the row of the first
      voxel found in column xy_i + o at z offset a (preference 0, -1, +1,
      ..): p^a[j'] is the column's window centered at z_i whichever a hit.
      (2r+1)*M marks a column with nothing in reach."""

    ext: torch.Tensor  # (M, K^2) int64 rows into P; (2r+1)*M = missing
    zshift: torch.Tensor  # (M, 4r) int64 row offset of the z+c voxel, 0 none


def build_zplan(coords: torch.Tensor, valid: torch.Tensor,
                kernel_size: int = 3) -> ZPlan:
    """The z-pack structure of lex-sorted rows (see :class:`ZPlan`). The
    z shifts compare shifted coordinates exactly; the in-plane lookups are
    :func:`lookup`'s, over the rows the JAX hash table keeps."""
    m = coords.shape[0]
    if kernel_size % 2 != 1:
        raise ValueError("submanifold rulebooks need odd kernels")
    r = (kernel_size - 1) // 2
    dev = coords.device
    c = coords.to(torch.int64)
    table = build_key_table(coords, valid)
    offs = plane_offsets(kernel_size, dev)
    k2 = offs.shape[0]
    half = k2 // 2
    noncenter = torch.cat([offs[:half], offs[half + 1:]])
    aligns = [0]
    for a in range(1, r + 1):
        aligns += [-a, a]
    missing = (2 * r + 1) * m
    ext_nc = torch.full((k2 - 1, m), missing, dtype=torch.int64, device=dev)
    for a in aligns:
        q = c[None].repeat(k2 - 1, 1, 1)
        q[:, :, 1:3] += noncenter[:, None, :]
        q[:, :, 3] += a
        idx = lookup(table, q)  # (K2-1, M)
        hit = valid[None, :] & (idx >= 0)
        enc = (a + r) * m + torch.where(hit, idx, 0)
        ext_nc = torch.where(hit & (ext_nc == missing), enc, ext_nc)
    center = torch.where(valid, r * m + torch.arange(m, device=dev),
                         missing)[None]
    ext = torch.cat([ext_nc[:half], center, ext_nc[half:]]).T.contiguous()

    def shifted_rows(s):
        """Coordinates and validity of row j + s (out of range: invalid)."""
        v = torch.zeros_like(valid)
        if s > 0:
            v[:-s] = valid[s:]
        else:
            v[-s:] = valid[:s]
        return torch.roll(c, -s, dims=0), v

    slots = []
    for dz in [*range(-2 * r, 0), *range(1, 2 * r + 1)]:
        target = c.clone()
        target[:, 3] += dz
        res = torch.zeros(m, dtype=torch.int64, device=dev)
        step = 1 if dz > 0 else -1
        for s in range(step, dz + step, step):
            sc, sv = shifted_rows(s)
            hit = valid & sv & (sc == target).all(dim=1)
            res = torch.where(hit & (res == 0), s, res)
        slots.append(res)
    return ZPlan(ext=ext, zshift=torch.stack(slots, dim=1))


def _zbands(feats, zshift, valid, dtype):
    """(M, C) -> (M, (4r+1)C) band matrix q, bands c ascending in [-2r, 2r]
    (the same column's voxel features at z + c, zero where absent): shifted
    slices and selects, no gathers."""
    m, c = feats.shape
    f = torch.where(valid[:, None], feats, 0).to(dtype)
    r2 = zshift.shape[1] // 2  # = 2r

    def shifted(s):
        z = f.new_zeros((abs(s), c))
        return torch.cat([f[s:], z]) if s > 0 else torch.cat([z, f[:s]])

    bands = []
    for t, dz in enumerate([*range(-r2, 0), *range(1, r2 + 1)]):
        band = torch.zeros_like(f)
        step = 1 if dz > 0 else -1
        for s in range(step, dz + step, step):
            band = torch.where((zshift[:, t] == s)[:, None], shifted(s), band)
        bands.append(band)
    return torch.cat(bands[:r2] + [f] + bands[r2:], dim=1)


def _zviews(q, cin, k):
    """The alignment views of the band matrix and P (their stack on a zero
    row). View a gathers at the voxel z' = z + a, so its window is the
    bands centered at -a relative to z' (f(z + dz), dz in [-r, r])."""
    r = (k - 1) // 2
    e = k * cin
    views = [q[:, (r - a) * cin:(r - a) * cin + e] for a in range(-r, r + 1)]
    return views, torch.cat(views + [q.new_zeros((1, e))])


def _zconv_impl(dtype, feats, weights, ext, zshift, valid):
    """The z-pack conv's forward; weights (k^3, Cin, Cout) in
    :func:`kernel_offsets` order, as the gather engine takes them. Operands
    are rounded to ``dtype`` and multiplied in f32 (float64 for float64)."""
    m, cin = feats.shape
    k3, _, cout = weights.shape
    k = round(k3 ** (1 / 3))
    r = (k - 1) // 2
    k2 = k * k
    acc = torch.promote_types(dtype, torch.float32)
    views, p = _zviews(_zbands(feats, zshift, valid, dtype).to(acc), cin, k)
    # (k^3, Cin, Cout) -> (K^2, k*Cin, Cout): dz fastest, as q's bands
    w2 = weights.to(dtype).to(acc).reshape(k2, k * cin, cout)
    out = torch.zeros((m, cout), dtype=acc, device=feats.device)
    for o in range(k2):
        g = views[r] if o == k2 // 2 else p[ext[:, o]]
        out = out + g @ w2[o]
    return out * valid[:, None]


class _ZConv(torch.autograd.Function):
    """The z-pack conv with the JAX package's custom VJP (``_zconv_bwd``):
    ``d_feats`` is the same conv of the masked output gradient with the
    offset-flipped, channel-transposed kernel over the same plan (each
    voxel's alignment entries enumerate exactly the column voxels in
    reach), and ``d_w`` recomputes the forward's gathers and contracts over
    rows."""

    @staticmethod
    def forward(ctx, feats, weights, ext, zshift, valid, dtype):
        ctx.save_for_backward(feats, weights, ext, zshift, valid)
        ctx.dtype = dtype
        return _zconv_impl(dtype, feats, weights, ext, zshift, valid)

    @staticmethod
    def backward(ctx, g):
        feats, weights, ext, zshift, valid = ctx.saved_tensors
        dtype = ctx.dtype
        m, cin = feats.shape
        k3, _, cout = weights.shape
        k = round(k3 ** (1 / 3))
        r = (k - 1) // 2
        k2 = k * k
        acc = torch.promote_types(dtype, torch.float32)
        g_masked = (g * valid[:, None]).to(dtype)
        d_feats = None
        if ctx.needs_input_grad[0]:
            w_bwd = weights.flip(0).transpose(-1, -2)
            d_feats = _zconv_impl(dtype, g_masked, w_bwd, ext, zshift,
                                  valid).to(feats.dtype)
        views, p = _zviews(_zbands(feats, zshift, valid, dtype).to(acc), cin,
                           k)
        g_acc = g_masked.to(acc)
        d_w2 = [(views[r] if o == k2 // 2 else p[ext[:, o]]).T @ g_acc
                for o in range(k2)]
        d_w = torch.stack(d_w2).reshape(k3, cin, cout).to(weights.dtype)
        return d_feats, d_w, None, None, None, None


def subm_conv_zpack_apply(feats, weights, plan: ZPlan, valid,
                          compute_dtype=None) -> torch.Tensor:
    """Submanifold conv by the z-pack formulation (:class:`ZPlan`): the
    gather engine's function with the same weights, up to the f32 sum order
    (K^2 packed products instead of K^3)."""
    dtype = compute_dtype or feats.dtype
    return _ZConv.apply(feats, weights, plan.ext, plan.zshift, valid, dtype)


# ---------------------------------------------------------------------------
# the octant-run table: another route to the rulebook of lex-sorted voxels
# ---------------------------------------------------------------------------

#: octant slots per RunTable bucket (three int32 lanes each, 16 lanes)
RUN_SLOTS = 5


def _spatial_hash2(coords: torch.Tensor) -> torch.Tensor:
    """The JAX package's second (verifier) hash of (b, x, y, z) rows, as
    int64 masked to 32 bits."""
    c = coords.to(torch.int64)
    return (((c[..., 0] * 40503) & _U32)
            ^ ((c[..., 1] * 3267000013) & _U32)
            ^ ((c[..., 2] * 2860486313) & _U32)
            ^ ((c[..., 3] * 805459861) & _U32))


class RunTable(NamedTuple):
    """The JAX package's octant-run hash table over lex-sorted,
    duplicate-free voxels: the voxels of one z-octant column (b, x, y,
    z >> 3) are consecutive rows, so one (first_row, zmask) pair answers all
    eight z's of the octant (z-bit j sits at ``first_row + popcount(zmask &
    ((1 << j) - 1))``). Each 16-lane row holds RUN_SLOTS slots of [hash2
    tag, first_row, zmask], ``first_row == -1`` marking an empty one; the
    buckets number ~4x the voxels, and octants past RUN_SLOTS in a bucket
    are dropped, as the JAX table drops them."""

    coords: torch.Tensor  # (M, 4) lex-sorted unique (b, x, y, z)
    valid: torch.Tensor  # (M,) bool, a prefix
    rows: torch.Tensor  # (NB, 16) int64
    mask: int  # NB - 1


def build_run_table(coords: torch.Tensor, valid: torch.Tensor) -> RunTable:
    """The octant-run table of lex-sorted, duplicate-free rows with the
    padding last (:class:`RunTable`; the JAX package's insertion: octants
    ranked by first row, a stable sort by bucket, each octant's slot its
    rank within its bucket)."""
    m = coords.shape[0]
    dev = coords.device
    nb = 1 << max(4 * m - 1, 127).bit_length()
    mask = nb - 1
    c = coords.to(torch.int64)
    okey = torch.cat([c[:, :3], c[:, 3:4] >> 3], dim=1)
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = (okey[1:] != okey[:-1]).any(dim=1)
    is_first = valid & first
    oct_id = torch.cumsum(is_first, 0) - 1
    n_oct = is_first.sum()
    # an octant's z's are distinct (unique rows): OR == SUM of the bits
    bits = torch.where(valid, 1 << (c[:, 3] & 7), 0)
    zmask = torch.zeros(m + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(valid, oct_id, m), bits)[:m]
    firsts = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    firsts[torch.where(is_first, oct_id, m)] = torch.arange(m, device=dev)
    firsts = firsts[:m]

    oct_valid = torch.arange(m, device=dev) < n_oct
    okeys = okey[firsts]
    h2 = _spatial_hash2(okeys)
    h2 = torch.where(h2 >= 1 << 31, h2 - (1 << 32), h2)  # int32 bits
    bucket = _spatial_hash(okeys) & mask
    perm = torch.sort(torch.where(oct_valid, bucket, nb), stable=True).indices
    sb, sv = bucket[perm], oct_valid[perm]
    pos = torch.arange(m, device=dev)
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = sb[1:] != sb[:-1]
    slot = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    ok = sv & (slot < RUN_SLOTS)

    width = 16
    dump = nb * width
    base = sb * width + slot * 3
    lane = torch.arange(nb * width, device=dev) % width
    flat = torch.where((lane % 3 == 1) & (lane < 15), -1, 0)
    flat = torch.cat([flat, flat.new_zeros(1)])
    for off, values in ((0, h2), (1, firsts), (2, zmask)):
        flat[torch.where(ok, base + off, dump)] = values[perm]
    return RunTable(coords=coords, valid=valid,
                    rows=flat[:dump].reshape(nb, width), mask=mask)


def _popcount8(v: torch.Tensor) -> torch.Tensor:
    """Population count of values below 256 (zmask bits)."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _run_rows(table: RunTable, okeys: torch.Tensor):
    """Bucket rows and query tags of (M, 4) octant keys."""
    h2 = _spatial_hash2(okeys)
    h2 = torch.where(h2 >= 1 << 31, h2 - (1 << 32), h2)
    return table.rows[_spatial_hash(okeys) & table.mask], h2


def _run_extract(table: RunTable, rows, qh2, zq, okeys):
    """Row of the voxel at z == ``zq`` in the octant ``okeys`` whose bucket
    rows and tags are given, or -1. Every slot whose tag matches is also
    checked against its first row's octant, so the answer is exact (the JAX
    package's ``verify_coords`` mode)."""
    j = zq & 7
    low = (1 << j) - 1
    found = torch.zeros(qh2.shape, dtype=torch.int64, device=qh2.device)
    last = table.coords.shape[0] - 1
    for s in range(RUN_SLOTS):
        tag, f, zm = (rows[..., 3 * s + i] for i in range(3))
        stored = table.coords[f.clamp(0, last)].to(torch.int64)
        stored_ok = torch.cat([stored[..., :3], stored[..., 3:4] >> 3], -1)
        match = (f >= 0) & (tag == qh2) & (stored_ok == okeys).all(dim=-1)
        present = ((zm >> j) & 1) == 1
        found = found + torch.where(match & present,
                                    f + _popcount8(zm & low) + 1, 0)
    return found - 1


def build_rulebook_runs(coords: torch.Tensor, valid: torch.Tensor,
                        kernel_size: int = 3,
                        table: RunTable | None = None) -> torch.Tensor:
    """(M, K) rulebook through the octant-run table: equal to
    :func:`build_rulebook` on lex-sorted duplicate-free voxels whose
    octants the table keeps, with 2 bucket-row gathers per (dx, dy) column
    (the dz span crosses at most one octant boundary) instead of k
    lookups."""
    m = coords.shape[0]
    if kernel_size % 2 != 1:
        raise ValueError("submanifold rulebooks need odd kernels")
    if table is None:
        table = build_run_table(coords, valid)
    dev = coords.device
    c = coords.to(torch.int64)
    r = (kernel_size - 1) // 2
    b, z = c[:, 0], c[:, 3]
    oct_lo, oct_hi = (z - r) >> 3, (z + r) >> 3
    arange_m = torch.arange(m, device=dev)
    columns = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            x, y = c[:, 1] + dx, c[:, 2] + dy
            ok_lo = torch.stack([b, x, y, oct_lo], dim=1)
            ok_hi = torch.stack([b, x, y, oct_hi], dim=1)
            rows_lo, qh2_lo = _run_rows(table, ok_lo)
            rows_hi, qh2_hi = _run_rows(table, ok_hi)
            xy_ok = valid & (x >= 0) & (y >= 0)
            for dz in range(-r, r + 1):
                if dx == 0 and dy == 0 and dz == 0:
                    columns.append(torch.where(valid, arange_m, m))
                    continue
                zq = z + dz
                use_lo = (zq >> 3) == oct_lo
                idx = _run_extract(
                    table, torch.where(use_lo[:, None], rows_lo, rows_hi),
                    torch.where(use_lo, qh2_lo, qh2_hi), zq,
                    torch.where(use_lo[:, None], ok_lo, ok_hi))
                good = xy_ok & (zq >= 0) & (idx >= 0)
                columns.append(torch.where(good, idx, m))
    return torch.stack(columns, dim=1)
