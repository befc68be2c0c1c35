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


def build_rulebook(
    coords: torch.Tensor,
    valid: torch.Tensor,
    kernel_size: int = 3,
) -> torch.Tensor:
    """(M, K) int64 neighbor indices for a submanifold conv; M marks
    'missing'. ``coords`` is (M, 4) (b, x, y, z). The center column is the
    row itself; another offset looks its coordinate up among the rows the
    JAX hash table keeps (:func:`table_rows`) and finds the largest of
    their indices there (a stable sort keeps equal keys in index order,
    and the right-side ``searchsorted`` lands on the last), or M when the
    table kept none."""
    m = coords.shape[0]
    if kernel_size % 2 != 1:
        raise ValueError("submanifold rulebooks need odd kernels")
    dev = coords.device
    keys = pack_keys(coords, table_rows(coords, valid))
    s_key, perm = torch.sort(keys, stable=True)
    offs = kernel_offsets(kernel_size, dev)
    k = offs.shape[0]
    half = k // 2
    c = coords.to(torch.int64)
    limit = 1 << COORD_BITS
    columns = []
    for j in range(k):
        if j == half:  # identity center column
            columns.append(
                torch.where(valid, torch.arange(m, device=dev), m)
            )
            continue
        q = c.clone()
        q[:, 1:] += offs[j]
        in_range = ((q[:, 1:] >= 0) & (q[:, 1:] < limit)).all(dim=1)
        qkey = (
            (q[:, 0] << (3 * COORD_BITS))
            | (q[:, 1] << (2 * COORD_BITS))
            | (q[:, 2] << COORD_BITS)
            | q[:, 3]
        )
        pos = (torch.searchsorted(s_key, qkey, right=True) - 1).clamp(min=0)
        hit = (s_key[pos] == qkey) & in_range & valid
        columns.append(torch.where(hit, perm[pos], m))
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
    rulebook,  # (M, K) rulebook, a BandPlan or a ZBandPlan
    valid: torch.Tensor,  # (M,)
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold conv: out[i] = sum_k W[k] @ feats[nbr_k(i)].

    ``rulebook`` may be a :class:`~.bandconv.BandPlan` or a
    :class:`~.bandconv.ZBandPlan`, selecting the band or the z-packed band
    engine (same weights layout). ``compute_dtype=torch.bfloat16`` rounds
    features (and, on the gather engine, weights) to bf16; accumulation
    stays float32 (float64 for ``torch.float64``, gather engine only)."""
    from .bandconv import (
        BandPlan,
        ZBandPlan,
        band_subm_conv_apply,
        zband_subm_conv_apply,
    )

    dtype = compute_dtype or feats.dtype
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
