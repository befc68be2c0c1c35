"""Point-set sampling and grouping for PointNet++, in plain PyTorch.

Port of ``treemorph_tpu/ops/sampling.py`` (the reference's
``Modules/PointNet2/pointnet2_utils.py``). The JAX package has no Pallas
kernel here: these are tensor ops on padded (B, N, ...) batches with a
``valid`` mask, and they stay tensor ops on the card.

- :func:`square_distance`: pairwise squared distances by the matmul
  identity, in full f32 whatever the process's TF32 setting: the three
  coordinate products are elementwise, not a matmul, because TF32 would
  move distances near a ball's radius across it. The dot products and
  norms are rounded as the JAX package's compiled program rounds them
  (a product, then two fused multiply-adds, :func:`_dot3`), so the port
  gives its distances bit for bit: the identity's rounding (a few ulps of
  |p|^2) decides which points sit on a ball's edge, and a point that
  coincides with a 3-NN source gets the inverse of its rounded distance as
  its weight.
- :func:`farthest_point_sample`: the exact sequential recurrence, one step
  per sample, padded points never selected; :func:`bucketed_farthest_point_sample`
  the JAX package's blocked variant.
- :func:`query_ball_point`: the ``nsample`` lowest-index valid points
  within the radius (not the nearest), empty balls filled with the globally
  nearest point.
- :func:`three_nn_interpolate`: inverse-squared-distance 3-NN
  interpolation for feature propagation.

Ties: ``jnp.argmax`` / ``argmin`` and ``lax.top_k`` break them toward the
lower index. ``torch.argmax`` / ``argmin`` return the first extreme too;
``torch.topk`` promises no order among ties, so the port picks the 3
nearest sources by three first-minimum passes over keys that order like
the distances (:func:`_nearest3`), and the ball's lowest indices as the
smallest of ``where(in_ball, index, n)`` (no ties among in-ball points).
"""

from __future__ import annotations

import torch


#: elements of the float64 temporaries of one :func:`square_distance`
#: chunk (~270 MB each)
_CHUNK_ELEMENTS = 2**25


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add rounds it:
    the product of two f32 values is exact in float64, so one float64 sum
    and the cast round it (twice only where the float64 sum lands on an
    f32 tie, about one sum in 2^29). Separate elementwise ops, so no
    compiler contracts or reorders them on either device."""
    return (a.double() * b.double() + c.double()).float()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 dot products over a last axis of 3 (broadcast):
    ``fma(a2, b2, fma(a1, b1, a0 * b0))``, the order XLA's CPU program of
    the JAX package evaluates them in."""
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, M) squared euclidean distances of (B, N, 3) and (B, M, 3)
    points, ``(-2 src.dst + |src|^2) + |dst|^2`` in f32, each dot product
    by :func:`_dot3`; computed over chunks of N to bound the float64
    temporaries."""
    src, dst = src.float(), dst.float()
    b, n, m = src.shape[0], src.shape[1], dst.shape[1]
    ss, dd = _dot3(src, src), _dot3(dst, dst)
    out = torch.empty((b, n, m), dtype=torch.float32, device=src.device)
    step = max(1, _CHUNK_ELEMENTS // max(b * m, 1))
    for n0 in range(0, n, step):
        part = out[:, n0:n0 + step]
        part.copy_(_dot3(src[:, n0:n0 + step, None, :], dst[:, None, :, :]))
        part.mul_(-2.0).add_(ss[:, n0:n0 + step, None]).add_(dd[:, None, :])
    return out


class _Gather(torch.autograd.Function):
    """``points.gather(1, flat)`` whose backward sums the gradients of
    repeated indices in a fixed order. On the card ``gather``'s own
    backward (``scatter_add_``) adds them with atomics, in whatever order
    the threads land, so a seeded PointNet2 training did not repeat bit
    for bit; here the sum runs under ``torch.use_deterministic_algorithms``
    (a sort by index, then each index's gradients in their order)."""

    @staticmethod
    def forward(ctx, points, flat):
        ctx.save_for_backward(flat)
        ctx.rows = points.shape[1]
        return points.gather(1, flat)

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        out = grad.new_zeros((grad.shape[0], ctx.rows, grad.shape[2]))
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            out.scatter_add_(1, flat, grad)
        finally:
            torch.use_deterministic_algorithms(was)
        return out, None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, C) by (B, ...) indices -> (B, ..., C); the gradient
    of repeated indices is summed deterministically (:class:`_Gather`)."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    if points.requires_grad:
        return _Gather.apply(points, flat).reshape(*idx.shape, c)
    return points.gather(1, flat).reshape(*idx.shape, c)


def _first_valid(valid: torch.Tensor) -> torch.Tensor:
    """(B,) index of each row's first valid point (0 if none)."""
    return valid.to(torch.uint8).argmax(dim=1)


def farthest_point_sample(
    xyz: torch.Tensor,  # (B, N, 3)
    valid: torch.Tensor,  # (B, N) bool
    npoint: int,
    scores: torch.Tensor | None = None,
) -> torch.Tensor:
    """Iterative farthest-point sampling over valid points: (B, npoint)
    int64 indices, one dependent step per sample. The first centroid is a
    random valid point when (B, N) uniform ``scores`` are given (reference
    behavior): the valid point of the largest score. Without them it is
    the first valid point. If npoint exceeds the valid points, selections
    repeat."""
    b, n, _ = xyz.shape
    dev = xyz.device
    dist = torch.where(valid, 1e10, -1.0).float()
    if scores is not None:
        farthest = torch.where(valid, scores.to(dev), -1.0).argmax(dim=1)
    else:
        farthest = _first_valid(valid)
    centroids = torch.empty((b, npoint), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(npoint):
        centroids[:, i] = farthest
        diff = xyz - xyz[rows, farthest][:, None, :]
        d = _dot3(diff, diff)
        dist = torch.minimum(dist, torch.where(valid, d, -1.0))
        farthest = dist.argmax(dim=1)
    return centroids


def fps_score_shape(b: int, n: int, npoint: int, buckets: int) -> tuple:
    """The shape of the uniform draw that picks the first centroids of
    :func:`bucketed_farthest_point_sample`: one score per point, (B, N),
    or per point of each bucket, (B * buckets, ceil(N / buckets))."""
    g = max(1, min(buckets, npoint, n))
    return (b, n) if g == 1 else (b * g, -(-n // g))


def bucketed_farthest_point_sample(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    npoint: int,
    buckets: int = 16,
    scores: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blocked approximate FPS (the JAX package's
    ``bucketed_farthest_point_sample``): point ``i`` goes to bucket ``i %
    buckets``, exact FPS runs in every bucket at once for
    ``ceil(npoint / buckets)`` steps, and the buckets' selections are
    interleaved in FPS order; selections on padded rows become the first
    valid point. ``buckets=1`` is exact FPS. ``scores``, of
    :func:`fps_score_shape`, pick the first centroids as in
    :func:`farthest_point_sample`."""
    b, n, _ = xyz.shape
    g = max(1, min(buckets, npoint, n))
    if g == 1:
        return farthest_point_sample(xyz, valid, npoint, scores)
    npad = -(-n // g) * g
    if npad != n:
        xyz = torch.nn.functional.pad(xyz, (0, 0, 0, npad - n))
        valid = torch.nn.functional.pad(valid, (0, npad - n))
    m = npad // g
    xb = xyz.reshape(b, m, g, 3).transpose(1, 2).reshape(b * g, m, 3)
    vb = valid.reshape(b, m, g).transpose(1, 2).reshape(b * g, m)
    q = -(-npoint // g)  # per-bucket quota
    sub = farthest_point_sample(xb, vb, q, scores).reshape(b, g, q)
    glob = sub * g + torch.arange(g, device=xyz.device)[None, :, None]
    glob = glob.transpose(1, 2).reshape(b, g * q)[:, :npoint]
    ok = valid.gather(1, glob)
    return torch.where(ok, glob, _first_valid(valid)[:, None])


def query_ball_point(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,  # (B, N, 3)
    new_xyz: torch.Tensor,  # (B, S, 3)
    valid: torch.Tensor,  # (B, N) bool
) -> torch.Tensor:
    """(B, S, nsample) int64 indices of up to ``nsample`` lowest-index valid
    points in each ball (squared distance <= radius^2); the rest of a row,
    and an empty ball, repeat its first point, the globally nearest valid
    point for an empty ball."""
    n = xyz.shape[1]
    sqr = square_distance(new_xyz, xyz)
    sqr.masked_fill_(~valid[:, None, :], torch.inf)
    iota = torch.arange(n, device=xyz.device)
    k_eff = min(nsample, n)
    # the k smallest of (index if in the ball, else n): in-ball indices
    # are distinct, so no tie decides the result
    keys = torch.where(sqr <= radius**2, iota, n)
    top = keys.topk(k_eff, dim=-1, largest=False, sorted=True).values
    del keys
    got = top < n
    nearest = sqr.argmin(dim=-1)
    first = torch.where(got[..., 0], top[..., 0], nearest)
    out = torch.where(got, top, first[..., None])
    if k_eff < nsample:
        out = torch.cat(
            [out, first[..., None].expand(*first.shape, nsample - k_eff)],
            dim=-1,
        )
    return out


def _order_keys(d: torch.Tensor) -> torch.Tensor:
    """int32 keys that order as the f32 values ``d`` do (+inf the largest
    value key; -0.0 just below +0.0)."""
    bits = d.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _nearest3(d: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) indices of the k smallest entries of ``d`` along its last
    axis, ties toward the lower index (``lax.top_k`` of ``-d``), by k
    first-minimum passes, each taking its pick out of the next."""
    keys = _order_keys(d)
    taken = torch.iinfo(torch.int32).max  # above every value's key
    picks = []
    for j in range(k):
        idx = keys.argmin(dim=-1, keepdim=True)
        picks.append(idx)
        if j + 1 < k:
            keys.scatter_(-1, idx, taken)
    return torch.cat(picks, dim=-1)


def three_nn_interpolate(
    xyz_to: torch.Tensor,  # (B, N, 3) targets
    xyz_from: torch.Tensor,  # (B, S, 3) sources
    feats_from: torch.Tensor,  # (B, S, C)
    valid_from: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    """Inverse-squared-distance weighted 3-NN interpolation -> (B, N, C):
    weights are reciprocals of squared distances clamped at 1e-6, over
    k = min(3, S) nearest valid sources; a target with no valid source
    gets zeros."""
    s = xyz_from.shape[1]
    if s == 1:
        return feats_from[:, :1, :].expand(
            xyz_to.shape[0], xyz_to.shape[1], feats_from.shape[-1])
    k = min(3, s)
    d = square_distance(xyz_to, xyz_from)
    d.masked_fill_(~valid_from[:, None, :], torch.inf)
    idx = _nearest3(d, k)  # (B, N, k)
    dk = d.gather(-1, idx).clamp(min=1e-6)
    del d
    recip = 1.0 / dk
    recip = torch.where(torch.isfinite(recip), recip, 0.0)
    weight = recip / recip.sum(dim=-1, keepdim=True).clamp(min=1e-12)
    out = index_points(feats_from, idx[..., 0]) * weight[..., 0, None]
    for j in range(1, k):
        out = out + index_points(feats_from, idx[..., j]) * weight[..., j, None]
    return out


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor | None,
    valid: torch.Tensor,
    scores: torch.Tensor | None = None,
):
    """FPS + ball grouping: ``(new_xyz (B, S, 3), grouped (B, S, K, 3+C),
    new_valid (B, S))``, grouped features ``[relative xyz, point feats]``;
    ``scores`` pick the first centroids as in :func:`farthest_point_sample`."""
    fps_idx = farthest_point_sample(xyz, valid, npoint, scores)
    new_xyz = index_points(xyz, fps_idx)
    new_valid = valid.gather(1, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz, valid)
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, index_points(feats, idx)], dim=-1)
    return new_xyz, grouped, new_valid
