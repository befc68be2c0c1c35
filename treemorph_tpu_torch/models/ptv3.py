"""PointTransformerV3 with offset/semantic heads, as torch modules.

Port of ``treemorph_tpu/models/ptv3.py`` (reference
``Modules/PointTransformerV3/PointTransformerV3.py`` + ``blocks.py``):
points are grid-quantized and serialized along 4 curve orders (z, z-trans,
hilbert, hilbert-trans); a k=5 submanifold conv stem; 5 encoder stages of
pre-norm blocks (xCPE submanifold conv, window attention over one curve
order, GELU MLP), joined by stride-2 serialized pooling (clusters of
``code >> 3`` on the first order); 4 decoder stages joined by unpooling
onto the encoder's levels; MLP heads on the 64-channel decoder output.

As in the JAX package, attention packs windows of ``patch`` consecutive
rows of the sorted order across batch elements and masks pairs of
different elements (:func:`treemorph_tpu_torch.ops.attention.window_attention`,
the CUDA kernel on the card, the plain version on the CPU); every level's
row count is a static capacity rounded up to the patch. Convs run over exact
rulebooks, built once per level and shared by its xCPEs; level 0 holds
points, not voxels, so points of one voxel share neighbors (the largest row
index among them, as the JAX lookup returns).

The options of the JAX package's fast configuration (``bench.py``'s PTv3):

- ``dedup_tokens`` (with ``dedup_divisor``): the whole backbone runs on one
  token per occupied voxel (its first point by row), quantized against the
  full cloud's minimum; predictions go back to points through
  ``token_v2u`` at the end.
- ``dedup_divisor`` alone: level 0 stays points, but its convs (stem and
  xCPEs) run once per unique voxel (:class:`~..ops.sparse.DedupMap`) and
  broadcast to the voxel's points.
- ``stem_engine="band"``: the convs over lex-sorted rows take the band
  engine (:mod:`treemorph_tpu_torch.ops.bandconv`, the CUDA kernel on the
  card): the k=5 stem and level 0's xCPEs over unique voxels or tokens, and
  every pooled level, which is re-stored in lex order for it
  (:func:`_lex_permute_level`). Level 0 over plain points keeps the gather
  engine. The port's own ``band_viable`` routes each conv: it admits every
  width, where the JAX package sends deep wide levels to the gather engine
  by its VMEM budget; both engines compute the same function.
- ``stem_engine="zpack"``: the same convs take the z-pack engine
  (:class:`~..ops.sparse.ZPlan`) where the band engine would take its
  plans, with the JAX package's rule: the k=5 stem over unique voxels or
  tokens, level 0's xCPEs over unique voxels or tokens, and every pooled
  level. Over plain points level 0 keeps the gather engine. Any other
  engine name takes the gather engine everywhere, as in the JAX package.

Module and parameter names follow the flax tree (``backbone.enc0_block0.
attn.qkv``, ``cpe.LayerNorm_0``, ``enc1_down.norm``, ...), so
:func:`treemorph_tpu_torch.models.convert.flax_to_state_dict` maps one to
the other. Sort keys are one int64 ``batch << 48 | code``, whose stable
sort is the JAX package's lexsort of ``(batch, hi, lo)``.

The options of the reference's own partitioning (off by default, as there):

- ``pad_per_element`` (with ``num_elements``): attention windows never
  straddle batch elements (:func:`element_pad_layout`, the reference's
  ``get_padding_and_inverse``); the hand kernels run on that layout.
- ``enable_rpe``: a relative positional bias per window and head from the
  ``rpe_table`` parameter. Attention with a bias takes the plain version
  (:func:`_rpe_attention`), on every device, as the JAX package routes it:
  the kernels take no bias.
- ``pdnorm`` (:class:`PDNormSpec`): the stem, pooling and unpooling
  BatchNorms (``bn``) and the blocks' and xCPEs' LayerNorms (``ln``) become
  :class:`PDNorm`, which selects one norm per ``condition`` and, with
  ``adaptive``, scales and shifts it from a ``context`` vector.

Training (``model.train()``) takes its randomness from the caller, as the
JAX model takes rngs: one permutation of the four orders per stage
(``order_perms``, drawn by :func:`draw_order_perms`), applied where the
level is serialized, and a ``torch.Generator`` on the model's device for
the blocks' stochastic depth (:class:`DropPath`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention
from ..ops.bandconv import choose_band_plan
from ..ops.serialization import encode
from ..ops.sparse import (
    build_dedup,
    build_rulebook,
    build_zplan,
    dedup_sort_perm,
    rulebook_subset_columns,
    subm_conv_apply,
)
from .loss import point_wise_loss
from .treelearn import MaskedBatchNorm, MLPHead, _conv_dtype, _fan_in_normal_

DEFAULT_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
INVALID_BATCH = 0x7FFF
#: static serialization depth and the bits of its curve codes
DEPTH = 16
CODE_BITS = 3 * DEPTH
#: hidden width of the blocks' MLPs over their channels
MLP_RATIO = 4

#: the ``stem_engine`` values with a path of their own, which re-store the
#: pooled levels in lex order; the JAX model checks no name, and any other
#: takes the gather engine
LEX_ENGINES = ("band", "zpack")


def _bn(channels: int) -> MaskedBatchNorm:
    """PTv3's stem/pool BatchNorm: flax momentum 0.99 (torch 0.01), eps
    1e-3."""
    return MaskedBatchNorm(channels, momentum=0.01, eps=1e-3)


def _ln(channels: int) -> nn.LayerNorm:
    """flax ``LayerNorm``: eps 1e-6."""
    return nn.LayerNorm(channels, eps=1e-6)


def _dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """A flax ``Dense(dtype=...)`` whose output goes on in f32. In bf16 the
    product takes bf16 operands and is rounded to bf16, and the bf16 bias
    is added in f32, as XLA compiles ``Dense(dtype=bf16)(x).astype(f32)``
    (it drops the rounding of a sum that is widened at once)."""
    if dtype == torch.float32:
        return linear(x)
    return (F.linear(x.to(dtype), linear.weight.to(dtype)).float()
            + linear.bias.to(dtype).float())


def _gelu(x):
    """Exact GELU. On bf16 it rounds as XLA's ``nn.gelu`` does:
    ``x/2 * erfc(-x * bf16(2**-0.5))`` in f32 with only ``erfc`` rounded
    to bf16, then the result."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    x = x.float()
    erfc = torch.erfc(-x * 0.70703125).to(torch.bfloat16).float()
    return (0.5 * x * erfc).to(torch.bfloat16)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax ``lecun_normal`` (the ``Dense`` default): a normal truncated at
    +-2 std, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class PDNormSpec(NamedTuple):
    """Point-Prompt-Training conditional norms (reference ``PDNorm``,
    blocks.py:272-311; the ``pdnorm_*`` flags of PointTransformerV3.py:
    288-330, off in the reference's defaults)."""

    bn: bool = False  # wrap the stem, pooling and unpooling BatchNorms
    ln: bool = False  # wrap the blocks' and xCPEs' LayerNorms
    conditions: tuple = ("ScanNet", "S3DIS", "Structured3D")
    decouple: bool = True  # one norm per condition
    adaptive: bool = False  # SiLU + Linear modulation from a context
    context_channels: int = 256


class PDNorm(nn.Module):
    """Conditional norm (reference blocks.py:272-311): with ``decouple``
    one norm per condition (``norm{i}``, all in the ``state_dict``), of
    which only the one of ``condition`` runs and, a BatchNorm, updates its
    running statistics; else one ``norm``. With ``adaptive`` a
    ``modulation`` Linear on ``silu(context)`` gives a shift and a scale:
    ``y * (1 + scale) + shift``, masked to the valid rows. ``context`` is
    (context_channels,) or rows of it that broadcast against (P, C)."""

    def __init__(self, num_features: int, kind: str = "bn",
                 conditions=PDNormSpec.conditions, decouple: bool = True,
                 adaptive: bool = False, context_channels: int = 256):
        super().__init__()
        make = _bn if kind == "bn" else _ln
        self.kind = kind
        self.decouple = decouple
        self.adaptive = adaptive
        self.num_conditions = len(conditions)
        if decouple:
            for i in range(len(conditions)):
                self.add_module(f"norm{i}", make(num_features))
        else:
            self.norm = make(num_features)
        if adaptive:
            self.modulation = nn.Linear(context_channels, 2 * num_features)

    def forward(self, x, valid, condition: int = 0, context=None):
        if self.decouple:
            if not 0 <= condition < self.num_conditions:
                raise ValueError(f"PDNorm condition {condition} of "
                                 f"{self.num_conditions}")
            norm = getattr(self, f"norm{condition}")
        else:
            norm = self.norm
        y = norm(x, valid) if self.kind == "bn" else norm(x)
        if self.adaptive:
            if context is None:
                raise ValueError("adaptive PDNorm needs a context")
            shift, scale = self.modulation(F.silu(context)).chunk(2, dim=-1)
            y = (y * (1.0 + scale) + shift) * valid[:, None]
        return y


def _norm(kind: str, channels: int, pdnorm: PDNormSpec | None):
    """A BatchNorm (``kind="bn"``) or LayerNorm (``"ln"``), a
    :class:`PDNorm` where ``pdnorm`` wraps that kind."""
    if pdnorm is not None and getattr(pdnorm, kind):
        return PDNorm(channels, kind, pdnorm.conditions, pdnorm.decouple,
                      pdnorm.adaptive, pdnorm.context_channels)
    return _bn(channels) if kind == "bn" else _ln(channels)


def _run_norm(norm, x, valid, cond):
    """Apply a norm of :func:`_norm`; ``cond`` is (condition, context)."""
    if isinstance(norm, PDNorm):
        return norm(x, valid, *cond)
    if isinstance(norm, MaskedBatchNorm):
        return norm(x, valid)
    return norm(x)


class PointSet(NamedTuple):
    """One serialized level, padded to a static row count P."""

    coord: torch.Tensor  # (P, 3) float32
    grid_coord: torch.Tensor  # (P, 3) int64
    feat: torch.Tensor  # (P, C) float32
    batch: torch.Tensor  # (P,) int64 (INVALID_BATCH on padding)
    valid: torch.Tensor  # (P,) bool
    orders: torch.Tensor  # (O, P) int64 permutations
    inverses: torch.Tensor  # (O, P) int64 inverse permutations
    code: torch.Tensor  # (O, P) int64 curve codes


def _batched_order_sort(batch: torch.Tensor, code: torch.Tensor):
    """Orders and inverses of all curve orders at once: one stable sort of
    ``batch << 48 | code`` per row of the (O, P) codes (equal keys keep
    their index order, as ``jnp.lexsort`` does)."""
    key = (batch.to(torch.int64) << CODE_BITS) | code
    perm = torch.sort(key, dim=-1, stable=True).indices
    inv = torch.empty_like(perm)
    arange = torch.arange(perm.shape[1], device=perm.device)
    inv.scatter_(1, perm, arange.expand_as(perm).contiguous())
    return perm, inv


def quantize_grid(coord, valid, grid_size: float):
    """Grid coords against the global (valid) min (reference
    ``Point.serialization``, blocks.py:114-118)."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=coord.device)
    mins = torch.where(valid[:, None], coord, big).amin(dim=0)
    mins = torch.where(torch.isfinite(mins), mins, 0.0)
    # a 0-dim tensor divisor: PyTorch multiplies by the reciprocal of a
    # Python scalar divisor, which floors differently at voxel faces
    size = torch.tensor(grid_size, dtype=torch.float32, device=coord.device)
    grid = torch.floor((coord - mins) / size).to(torch.int64)
    return torch.where(valid[:, None], grid.clamp(min=0), 0)


def draw_order_perms(generator: torch.Generator, num_stages: int):
    """One permutation of the curve orders per stage (the JAX model's
    ``jax.random.permutation`` of each stage's key), on the CPU."""
    return [torch.randperm(len(DEFAULT_ORDERS), generator=generator)
            for _ in range(num_stages)]


def _shuffled(orders, inverses, code, perm):
    """The level's orders, inverses and codes in the order ``perm`` (None:
    unshuffled)."""
    if perm is None:
        return orders, inverses, code
    perm = perm.to(orders.device)
    return orders[perm], inverses[perm], code[perm]


def make_pointset(coord, feat, batch, valid, grid_size: float,
                  order_perm=None, grid_coord=None) -> PointSet:
    """Grid-quantize and serialize a flat padded batch along the four curve
    orders (reference ``Point.serialization``, blocks.py:98-153), shuffled
    by ``order_perm`` when one is given. ``grid_coord`` skips the
    quantization (token mode quantizes the full cloud before compressing
    it: the tokens' own minimum could differ)."""
    if grid_coord is None:
        grid_coord = quantize_grid(coord, valid, grid_size)
    batch = torch.where(valid, batch.to(torch.int64), INVALID_BATCH)
    code = torch.stack([
        encode(grid_coord, batch, depth=DEPTH, order=name)[1]
        for name in DEFAULT_ORDERS
    ])
    orders, inverses = _batched_order_sort(batch.expand_as(code), code)
    orders, inverses, code = _shuffled(orders, inverses, code, order_perm)
    return PointSet(coord, grid_coord, feat, batch, valid, orders, inverses,
                    code)


class DropPath(nn.Module):
    """Per-row stochastic depth (timm's DropPath on (P, C) rows, the JAX
    model's ``DropPath``): in train mode each row is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, or zeroed; the mask comes
    from ``generator``, which lives on the rows' device. The identity in
    eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode draws its mask from a "
                             "generator; none was given")
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0], 1), generator=generator,
                          device=x.device) < keep
        return x * mask / keep


def element_pad_layout(batch: torch.Tensor, valid: torch.Tensor,
                       num_elements: int, patch: int):
    """Per-element window layout (the reference's
    ``get_padding_and_inverse``, blocks.py:400-455), over rows in a
    serialized order, where each element's valid rows are contiguous.

    Element b with n_b rows gets ``ceil(n_b / K) * K`` of the P + B*K
    slots. When n_b > K its tail window's slots past n_b copy the previous
    window's rows at the same positions (blocks.py:429-438) and attend as
    real keys; when n_b <= K they stay dead (the reference's short varlen
    sequence: the same attention). A slot's element is the first whose
    range holds it (``argmax`` of a (P + B*K, B) mask, as in the JAX
    package). Returns ``(pad_src, slot_seg, unpad)``: the row feeding each
    slot (clipped; dead slots have ``slot_seg == -1``), the element of each
    slot (int32), and the slot of each row (valid rows)."""
    p = batch.shape[0]
    dev = batch.device
    seg_ids = torch.where(valid & (batch < num_elements), batch,
                          num_elements).to(torch.int64)
    n = torch.zeros(num_elements + 1, dtype=torch.int64, device=dev)
    n = n.index_add_(0, seg_ids, valid.to(torch.int64))[:num_elements]
    m = -(-n // patch) * patch  # K-aligned allotment, 0 for an empty one
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start_src = torch.cat([zero, torch.cumsum(n, 0)[:-1]])
    start_pad = torch.cat([zero, torch.cumsum(m, 0)[:-1]])

    p_pad = p + num_elements * patch
    j = torch.arange(p_pad, device=dev)
    within = (j[:, None] >= start_pad[None]) & (
        j[:, None] < (start_pad + m)[None])
    owned = within.any(dim=1)
    ele = torch.argmax(within.to(torch.int32), dim=1)
    r = j - start_pad[ele]
    n_e = n[ele]
    real = r < n_e
    replicated = owned & ~real & (n_e > patch)
    src = torch.where(real, start_src[ele] + r,
                      torch.where(replicated, start_src[ele] + r - patch, 0))
    alive = owned & (real | replicated)
    pad_src = src.clamp(0, p - 1)
    slot_seg = torch.where(alive, ele, -1).to(torch.int32)

    pos = torch.arange(p, device=dev)
    # each row's element: the number of element ends at or before it
    pe = (pos[:, None] >= (start_src + n)[None]).sum(dim=1)
    pe = pe.clamp(0, num_elements - 1)
    unpad = (pos - start_src[pe] + start_pad[pe]).clamp(0, p_pad - 1)
    return pad_src, slot_seg, unpad


def rpe_bound(patch: int) -> int:
    """The reference RPE table's bound (blocks.py:318-321), its expression
    kept as written: 31 at K = 1024 (float rounding), not 32."""
    return int((4 * patch) ** (1 / 3) * 2)


class _RPEBias(torch.autograd.Function):
    """The RPE bias ``table[idx_x] + table[idx_y] + table[idx_z]`` (w, K, K,
    H) of the index tensor (w, K, K, 3). Its gradient sums the cotangent
    into each table row with one ``bincount`` per head and axis (autograd
    of the gathers would scatter-add through ``index_put``, ~9x slower on
    the CPU for a table of ~100 rows)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return (table[idx[..., 0]] + table[idx[..., 1]]) + table[idx[..., 2]]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        d = 0
        for a in range(3):
            flat = idx[..., a].reshape(-1)
            d = d + torch.stack([
                torch.bincount(flat, weights=g[:, h], minlength=ctx.rows)
                for h in range(g.shape[1])], dim=1)
        return d, None


def _rpe_attention(q, k, v, seg, grid_w, table, pos_bnd):
    """Window attention with the RPE score bias (JAX :416-438): for each
    pair of a window the clipped relative grid offset indexes one row of
    ``table`` (3 * rpe_num, H) per axis, and the three rows sum to the
    pair's bias per head (:class:`_RPEBias`). The plain version takes it,
    chunk by chunk over windows (the plain attention's chunks), since
    neither hand kernel takes a bias: the JAX package routes RPE attention
    to its plain version on every backend too."""
    w_count, h, kk, _ = q.shape
    rpe_num = 2 * pos_bnd + 1
    axis = torch.arange(3, dtype=torch.int32, device=q.device) * rpe_num
    step = max(1, attention._PLAIN_CHUNK_ELEMENTS // (h * kk * kk))
    outs = []
    for w0 in range(0, w_count, step):
        sl = slice(w0, w0 + step)
        gw = grid_w[sl].to(torch.int32)  # int32 indices: half the memory
        rel = gw[:, :, None, :] - gw[:, None, :, :]  # (w, K, K, 3)
        idx = rel.clamp(-pos_bnd, pos_bnd) + pos_bnd + axis
        bias = _RPEBias.apply(table, idx)
        outs.append(attention.window_attention_reference(
            q[sl], k[sl], v[sl], seg[sl], bias=bias.permute(0, 3, 1, 2)))
    return torch.cat(outs)


class SerializedAttention(nn.Module):
    """Masked window attention over one serialized order (reference
    blocks.py:336-507): windows of ``patch_size`` consecutive rows of the
    sorted order, pairs of different batch elements (or padding) masked.
    With ``pad_per_element`` the windows are those of
    :func:`element_pad_layout`; with ``enable_rpe`` the scores take the
    relative positional bias (:func:`_rpe_attention`)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int, compute_dtype: str = "float32",
                 pad_per_element: bool = False, num_elements=None,
                 enable_rpe: bool = False):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.order_index = order_index
        self.compute_dtype = compute_dtype
        self.pad_per_element = pad_per_element
        self.num_elements = num_elements
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)
        if enable_rpe:
            self.rpe_bound = rpe_bound(patch_size)
            self.rpe_table = nn.Parameter(
                torch.zeros(3 * (2 * self.rpe_bound + 1), num_heads))
        else:
            self.rpe_table = None

    def forward(self, ps: PointSet):
        c, h, k = self.channels, self.num_heads, self.patch_size
        p = ps.feat.shape[0]
        if p % k:
            raise ValueError(f"point count {p} not divisible by patch {k}")
        d = c // h
        dt = _conv_dtype(self.compute_dtype)
        order = ps.orders[self.order_index]
        inverse = ps.inverses[self.order_index]

        qkv = _dense(self.qkv, ps.feat, dt).to(dt)[order]
        grid = ps.grid_coord[order] if self.rpe_table is not None else None
        if self.pad_per_element:
            pad_src, seg, unpad = element_pad_layout(
                ps.batch[order], ps.valid[order], self.num_elements, k)
            qkv = qkv[pad_src]
            if grid is not None:
                grid = grid[pad_src]
        else:
            seg = torch.where(ps.valid[order], ps.batch[order], -1)
            seg = seg.to(torch.int32)
        p_eff = qkv.shape[0]
        seg = seg.reshape(p_eff // k, k)
        qkv = qkv.reshape(p_eff // k, k, 3, h, d)
        q, kk, v = (qkv[:, :, i].transpose(1, 2).contiguous()
                    for i in range(3))  # (W, H, K, D) each
        if self.rpe_table is not None:
            out = _rpe_attention(q, kk, v, seg, grid.reshape(p_eff // k, k, 3),
                                 self.rpe_table, self.rpe_bound)
        else:
            out = attention.window_attention(q, kk, v, seg)
        out = out.transpose(1, 2).reshape(p_eff, c)
        if self.pad_per_element:
            # invalid rows read clipped slots: zero them, as the packed
            # layout leaves them
            out = out[unpad] * ps.valid[order][:, None]
        return _dense(self.proj, out[inverse], dt)


class FeedForward(nn.Module):
    def __init__(self, channels: int, compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(channels, MLP_RATIO * channels)
        self.Dense_1 = nn.Linear(MLP_RATIO * channels, channels)

    def forward(self, x):
        dt = _conv_dtype(self.compute_dtype)
        x = _gelu(_dense(self.Dense_0, x, dt).to(dt))
        return _dense(self.Dense_1, x, dt)


def _lex_permute_level(ps: PointSet, cluster):
    """A pooled level re-stored in lex (b, x, y, z) order, for the band
    engine's premise; and the fine level's ``cluster`` map into it.
    Attention reads rows through ``orders`` / ``inverses`` and (un)pooling
    through ``cluster``, so composing all of them (and the codes) with the
    permutation leaves the model's function unchanged; padding rows stay
    last."""
    cap = ps.feat.shape[0]
    coords4 = torch.cat([ps.batch[:, None], ps.grid_coord], dim=1)
    perm = dedup_sort_perm(coords4, ps.valid)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(cap, device=perm.device)
    new_ps = PointSet(
        coord=ps.coord[perm], grid_coord=ps.grid_coord[perm],
        feat=ps.feat[perm], batch=ps.batch[perm], valid=ps.valid[perm],
        orders=inv[ps.orders], inverses=ps.inverses[:, perm],
        code=ps.code[:, perm],
    )
    new_cluster = torch.where(cluster < cap, inv[cluster.clamp(0, cap - 1)],
                              cap)
    return new_ps, new_cluster


def _level_conv(feat, kernel, rulebook, valid, dt, dedup=None):
    """Submanifold conv over the level's rows; with ``dedup``, once per
    unique voxel (``rulebook`` is then the unique voxels') and broadcast
    back to the rows (those whose voxel overflowed the cap get 0)."""
    if dedup is None:
        return subm_conv_apply(feat, kernel, rulebook, valid,
                               compute_dtype=dt)
    u_feat = feat[dedup.rows] * dedup.valid[:, None]
    x_u = subm_conv_apply(u_feat, kernel, rulebook, dedup.valid,
                          compute_dtype=dt)
    cap = dedup.rows.shape[0]
    return x_u[dedup.v2u.clamp(max=cap - 1)] * (dedup.v2u < cap)[:, None]


class CPE(nn.Module):
    """xCPE: submanifold conv (k=3, bias) + linear + LayerNorm (reference
    Block.cpe, blocks.py:562-572). The conv's engine follows its
    ``rulebook`` (a rulebook: gather; a ``BandPlan``: band; a ``ZPlan``:
    zpack). With ``dedup`` the conv runs once per unique voxel and
    broadcasts to the voxel's points; the linear and the LayerNorm stay per
    point."""

    def __init__(self, channels: int, compute_dtype: str = "float32",
                 pdnorm: PDNormSpec | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(27, channels, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.Dense_0 = nn.Linear(channels, channels)
        self.LayerNorm_0 = _norm("ln", channels, pdnorm)

    def forward(self, feat, rulebook, valid, dedup=None, cond=(0, None)):
        dt = _conv_dtype(self.compute_dtype)
        x = _level_conv(feat, self.kernel, rulebook, valid, dt, dedup)
        x = x + self.bias * valid[:, None]
        return _run_norm(self.LayerNorm_0, _dense(self.Dense_0, x, dt),
                         valid, cond)


class PTv3Block(nn.Module):
    """Pre-norm transformer block with xCPE (reference blocks.py:536-623)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int, drop_path: float = 0.0,
                 compute_dtype: str = "float32", pad_per_element=False,
                 num_elements=None, enable_rpe=False, pdnorm=None):
        super().__init__()
        self.cpe = CPE(channels, compute_dtype, pdnorm)
        self.norm1 = _norm("ln", channels, pdnorm)
        self.attn = SerializedAttention(
            channels, num_heads, patch_size, order_index, compute_dtype,
            pad_per_element, num_elements, enable_rpe)
        self.norm2 = _norm("ln", channels, pdnorm)
        self.mlp = FeedForward(channels, compute_dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, ps: PointSet, rulebook, generator=None,
                dedup=None, cond=(0, None)) -> PointSet:
        feat = ps.feat + self.cpe(ps.feat, rulebook, ps.valid, dedup, cond)
        x = self.attn(ps._replace(
            feat=_run_norm(self.norm1, feat, ps.valid, cond)))
        feat = feat + self.drop_path(x, generator)
        x = self.mlp(_run_norm(self.norm2, feat, ps.valid, cond))
        return ps._replace(feat=feat + self.drop_path(x, generator))


def _segment_amax(values, index, n, fill):
    """Max of ``values`` rows per segment ``index`` (0..n-1); empty
    segments hold ``fill``."""
    shape = (n,) + tuple(values.shape[1:])
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    idx = index.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, "amax", include_self=True)


def _segment_sum(values, index, n):
    shape = (n,) + tuple(values.shape[1:])
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


class SerializedPooling(nn.Module):
    """Stride-2 pooling by curve-code clustering (reference
    blocks.py:626-729), max reduction. The pooled level is compacted to
    ``cap`` rows (cluster ids are contiguous from 0; clusters past the cap
    are dropped, masked, and counted in the returned overflow)."""

    def __init__(self, in_channels: int, out_channels: int, pdnorm=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels)
        self.norm = _norm("bn", out_channels, pdnorm)

    def forward(self, ps: PointSet, cap: int, order_perm=None,
                cond=(0, None)):
        p = ps.feat.shape[0]
        dev = ps.feat.device
        order0 = ps.orders[0]
        # cluster key: code >> 3 (one curve level) on the first order
        s_key = ps.code[0][order0] >> 3
        s_batch = ps.batch[order0]
        s_valid = ps.valid[order0]
        new = torch.ones(p, dtype=torch.bool, device=dev)
        new[1:] = (s_key[1:] != s_key[:-1]) | (s_batch[1:] != s_batch[:-1])
        new |= ~s_valid
        s_cluster = torch.cumsum(new, 0) - 1
        s_cluster_c = s_cluster.clamp(max=cap)
        cluster = s_cluster_c[ps.inverses[0]]

        proj_s = self.proj(ps.feat)[order0]
        w_s = s_valid.float()[:, None]
        feat = _segment_amax(
            torch.where(s_valid[:, None], proj_s, -3.4e38), s_cluster_c,
            cap + 1, float("-inf"),
        )[:cap]
        feat = torch.where(torch.isfinite(feat), feat, 0.0)
        n_clusters = (new & s_valid).sum()
        overflow = (n_clusters - cap).clamp(min=0)

        counts = _segment_sum(w_s[:, 0], s_cluster_c, cap + 1)[:cap]
        coarse_valid = counts > 0
        feat = feat * coarse_valid[:, None]  # clear sentinel rows
        coord = _segment_sum(ps.coord[order0] * w_s, s_cluster_c,
                             cap + 1)[:cap] / counts.clamp(min=1.0)[:, None]
        grid = _segment_amax(
            torch.where(s_valid[:, None], ps.grid_coord[order0], -1),
            s_cluster_c, cap + 1, -1,
        )[:cap] >> 1
        grid = grid.clamp(min=0)
        batch = _segment_amax(torch.where(s_valid, s_batch, -1),
                              s_cluster_c, cap + 1, -1)[:cap]
        batch = torch.where(coarse_valid, batch, INVALID_BATCH)

        feat = _run_norm(self.norm, feat, coarse_valid, cond)
        feat = _gelu(feat) * coarse_valid[:, None]

        # pooled curve codes: the cluster head's codes one level up
        first = torch.searchsorted(s_cluster, torch.arange(cap, device=dev))
        head = order0[first.clamp(max=p - 1)]
        code = ps.code[:, head] >> 3
        orders, inverses = _batched_order_sort(batch.expand_as(code), code)
        orders, inverses, code = _shuffled(orders, inverses, code,
                                           order_perm)
        coarse = PointSet(coord, grid, feat, batch, coarse_valid, orders,
                          inverses, code)
        return coarse, cluster, overflow


class SerializedUnpooling(nn.Module):
    """Skip-join unpooling (reference blocks.py:732-767)."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, pdnorm=None):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels)
        self.norm = _norm("bn", out_channels, pdnorm)
        self.proj_skip = nn.Linear(skip_channels, out_channels)
        self.norm_skip = _norm("bn", out_channels, pdnorm)

    def forward(self, coarse_feat, coarse_valid, fine: PointSet, cluster,
                cond=(0, None)):
        x = _gelu(_run_norm(self.norm, self.proj(coarse_feat), coarse_valid,
                            cond))
        skip = _gelu(_run_norm(self.norm_skip, self.proj_skip(fine.feat),
                               fine.valid, cond))
        cap = x.shape[0]
        up = x[cluster.clamp(max=cap - 1)] * (cluster < cap)[:, None]
        return fine._replace(feat=(skip + up) * fine.valid[:, None])


class Embedding(nn.Module):
    """k=5 submanifold conv stem + BN + GELU (reference blocks.py:770-800).
    ``engine="band"`` builds a band plan over the prebuilt k=5 rulebook
    (:func:`~..ops.bandconv.choose_band_plan`), ``engine="zpack"`` a
    :class:`~..ops.sparse.ZPlan` over the rows (both need lex-sorted rows:
    unique voxels or tokens); the gather engine takes the rulebook, or
    builds one when none is given. With ``dedup`` the conv runs once per
    unique voxel and broadcasts to the voxel's points."""

    def __init__(self, in_channels: int, channels: int,
                 compute_dtype: str = "float32", engine: str = "gather",
                 pdnorm=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.engine = engine
        self.kernel = nn.Parameter(torch.empty(125, in_channels, channels))
        self.MaskedBatchNorm_0 = _norm("bn", channels, pdnorm)

    def forward(self, ps: PointSet, rulebook, dedup=None,
                cond=(0, None)) -> PointSet:
        dt = _conv_dtype(self.compute_dtype)
        if dedup is not None:
            rows, valid = dedup.coords, dedup.valid
        else:
            rows = torch.cat([ps.batch[:, None], ps.grid_coord], dim=1)
            valid = ps.valid
        if self.engine == "zpack":
            rulebook = build_zplan(rows, valid, 5)
        elif rulebook is None:
            rulebook = build_rulebook(rows, valid, 5)
        if self.engine == "band":
            _, cin, cout = self.kernel.shape
            rulebook = choose_band_plan(rulebook, valid, cin, cout, dt)
        x = _level_conv(ps.feat, self.kernel, rulebook, ps.valid, dt, dedup)
        x = _run_norm(self.MaskedBatchNorm_0, x, ps.valid, cond)
        return ps._replace(feat=_gelu(x) * ps.valid[:, None])


def level_capacity(p_now: int, patch: int, pool_shrink: int) -> int:
    """Rows of the pooled level below one of ``p_now`` rows: halved (by
    ``pool_shrink``), rounded up to the attention patch, at most
    ``p_now``."""
    cap = max(-(-(p_now // pool_shrink) // patch) * patch, patch)
    return min(cap, p_now)


def token_capacity(p_in: int, divisor: int, patch: int) -> int:
    """Rows of token mode's level 0 for ``p_in`` points: ``p_in //
    divisor`` rounded up to the attention patch, at least one patch, at
    most the points rounded up to it."""
    cap = max(-(-(p_in // divisor) // patch) * patch, patch)
    return min(cap, -(-p_in // patch) * patch)


class PointTransformerV3(nn.Module):
    """The backbone (reference PointTransformerV3.py:261-457), with the
    dedup, conv-engine and reference-partitioning options of the module
    docstring."""

    def __init__(self, in_channels=4, enc_depths=(2, 2, 2, 6, 2),
                 enc_channels=(32, 64, 128, 256, 512),
                 enc_num_head=(2, 4, 8, 16, 32),
                 enc_patch_size=(1024,) * 5, dec_depths=(2, 2, 2, 2),
                 dec_channels=(64, 64, 128, 256), dec_num_head=(4, 4, 8, 16),
                 dec_patch_size=(1024,) * 4, drop_path=0.3, grid_size=0.02,
                 pool_shrink=2, compute_dtype="float32", dedup_divisor=None,
                 dedup_tokens=False, stem_engine="gather",
                 pad_per_element=False, num_elements=None, enable_rpe=False,
                 pdnorm=None):
        super().__init__()
        if dedup_tokens and not dedup_divisor:
            raise ValueError("dedup_tokens needs dedup_divisor")
        if dedup_tokens and pad_per_element:
            raise ValueError(
                "dedup_tokens changes window partitioning; use one of "
                "pad_per_element (parity) or dedup_tokens (speed)")
        if pad_per_element and num_elements is None:
            raise ValueError("pad_per_element needs num_elements")
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.enc_channels = tuple(enc_channels)
        self.dec_channels = tuple(dec_channels)
        self.enc_patch_size = tuple(enc_patch_size)
        self.grid_size = grid_size
        self.pool_shrink = pool_shrink
        self.compute_dtype = compute_dtype
        self.dedup_divisor = dedup_divisor
        self.dedup_tokens = dedup_tokens
        self.stem_engine = stem_engine
        n_orders = len(DEFAULT_ORDERS)
        num_stages = len(self.enc_depths)
        attn = dict(pad_per_element=pad_per_element,
                    num_elements=num_elements, enable_rpe=enable_rpe,
                    pdnorm=pdnorm)
        # the stem takes the chosen engine over unique voxels or tokens
        # (lex-sorted rows); over plain points, the gather engine
        self.embedding = Embedding(
            in_channels, enc_channels[0], compute_dtype,
            stem_engine if dedup_divisor or dedup_tokens else "gather",
            pdnorm)
        total_enc = sum(self.enc_depths)
        enc_dp = [drop_path * i / max(total_enc - 1, 1)
                  for i in range(total_enc)]
        dp_i = 0
        for s in range(num_stages):
            if s > 0:
                self.add_module(f"enc{s}_down", SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], pdnorm))
            for i in range(self.enc_depths[s]):
                self.add_module(f"enc{s}_block{i}", PTv3Block(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s],
                    i % n_orders, enc_dp[dp_i], compute_dtype, **attn))
                dp_i += 1
        total_dec = sum(self.dec_depths)
        dec_dp = [drop_path * i / max(total_dec - 1, 1)
                  for i in range(total_dec)]
        for s in reversed(range(num_stages - 1)):
            coarse_ch = (enc_channels[-1] if s == num_stages - 2
                         else dec_channels[s + 1])
            self.add_module(f"dec{s}_up", SerializedUnpooling(
                coarse_ch, enc_channels[s], dec_channels[s], pdnorm))
            dp_slice = dec_dp[sum(self.dec_depths[:s]):
                              sum(self.dec_depths[:s + 1])][::-1]
            for i in range(self.dec_depths[s]):
                self.add_module(f"dec{s}_block{i}", PTv3Block(
                    dec_channels[s], dec_num_head[s], dec_patch_size[s],
                    i % n_orders, dp_slice[i], compute_dtype, **attn))

    def _tokens(self, coord, feat, batch, valid):
        """Token mode's inputs: one token per occupied voxel (the voxel's
        first point by row, lex-sorted), quantized against the full cloud's
        minimum; and the :class:`~..ops.sparse.DedupMap` from points to
        tokens."""
        grid = quantize_grid(coord, valid, self.grid_size)
        batch = torch.where(valid, batch.to(torch.int64), INVALID_BATCH)
        cap = token_capacity(coord.shape[0], self.dedup_divisor,
                             self.enc_patch_size[0])
        dd = build_dedup(torch.cat([batch[:, None], grid], dim=1), valid,
                         cap=cap)
        keep = dd.valid[:, None]
        return (coord[dd.rows] * keep, feat[dd.rows] * keep,
                torch.where(dd.valid, dd.coords[:, 0].to(torch.int64),
                            INVALID_BATCH),
                dd.valid, dd.coords[:, 1:].to(torch.int64), dd)

    def _level_rulebook(self, s, ps, rb5, dd):
        """Level ``s``'s k=3 xCPE structure over lex-sorted rows (unique
        voxels or tokens at level 0, every pooled level): a ``ZPlan`` for
        the zpack engine, a band plan over the rulebook for the band
        engine; else the rulebook (level 0: the stem's, sliced, where it
        built one)."""
        dt = _conv_dtype(self.compute_dtype)
        lex = s > 0 or self.dedup_tokens or dd is not None
        rows = (dd.coords if dd is not None
                else torch.cat([ps.batch[:, None], ps.grid_coord], dim=1))
        valid = dd.valid if dd is not None else ps.valid
        if self.stem_engine == "zpack" and lex:
            return build_zplan(rows, valid, 3)
        if s == 0 and rb5 is not None:
            rulebook = rb5[:, rulebook_subset_columns(5, 3)]
        else:
            rulebook = build_rulebook(rows, valid, 3)
        if self.stem_engine != "band" or not lex:
            return rulebook
        # the level's widest xCPE: its encoder's, or its decoder's
        width = max(self.enc_channels[s],
                    self.dec_channels[s] if s < len(self.dec_channels)
                    else 0)
        return choose_band_plan(rulebook, valid, width, width, dt)

    def forward(self, coord, feat, batch, valid, order_perms=None,
                generator=None, condition: int = 0, context=None):
        """``order_perms``: one permutation of the orders per stage (or
        None: unshuffled); ``generator``: the stochastic depth's, needed in
        train mode when ``drop_path`` > 0; ``condition`` and ``context``:
        the PDNorms' (:class:`PDNorm`). Returns the last level and the
        diagnostics ``dedup_overflow`` (points whose voxel missed the dedup
        cap), ``token_v2u`` (token mode: each point's token, the cap where
        it has none; else None) and ``pool_overflow``."""
        cond = (condition, context)
        num_stages = len(self.enc_depths)
        perms = (list(order_perms) if order_perms is not None
                 else [None] * num_stages)
        if len(perms) != num_stages:
            raise ValueError(f"{len(perms)} order permutations for "
                             f"{num_stages} stages")
        token_dd = grid = None
        if self.dedup_tokens:
            coord, feat, batch, valid, grid, token_dd = self._tokens(
                coord, feat, batch, valid)
        ps = make_pointset(coord, feat, batch, valid, self.grid_size,
                           perms[0], grid)
        coords4 = torch.cat([ps.batch[:, None], ps.grid_coord], dim=1)
        dd = None
        if self.dedup_divisor and not self.dedup_tokens:
            # level 0's convs run once per unique voxel
            p0 = ps.feat.shape[0]
            cap = max(p0 // self.dedup_divisor, min(p0, 1024))
            dd = build_dedup(coords4, ps.valid, cap=cap)
            coords4 = dd.coords
        # one k=5 rulebook serves the stem and, sliced to its central 3^3
        # columns, the level-0 xCPEs (the zpack engine builds plans)
        rb5 = None
        if self.stem_engine != "zpack":
            rb5 = build_rulebook(coords4,
                                 ps.valid if dd is None else dd.valid, 5)
        ps = self.embedding(ps, rb5, dd, cond)

        # (fine level, cluster, fine level's rulebook, its dedup)
        skips = []
        rulebook = level_dd = None
        pool_overflow = torch.zeros((), dtype=torch.int64,
                                    device=feat.device)
        for s in range(num_stages):
            if s > 0:
                cap = level_capacity(ps.feat.shape[0],
                                     self.enc_patch_size[s],
                                     self.pool_shrink)
                coarse, cluster, over = getattr(self, f"enc{s}_down")(
                    ps, cap, perms[s], cond)
                pool_overflow = pool_overflow + over
                if self.stem_engine in LEX_ENGINES:
                    coarse, cluster = _lex_permute_level(coarse, cluster)
                skips.append((ps, cluster, rulebook, level_dd))
                ps = coarse
            # pooled levels are duplicate-free: only level 0 carries dups
            level_dd = dd if s == 0 else None
            rulebook = self._level_rulebook(s, ps, rb5, level_dd)
            for i in range(self.enc_depths[s]):
                ps = getattr(self, f"enc{s}_block{i}")(
                    ps, rulebook, generator, level_dd, cond)
        for s in reversed(range(num_stages - 1)):
            fine, cluster, rulebook, level_dd = skips.pop()
            ps = getattr(self, f"dec{s}_up")(ps.feat, ps.valid, fine, cluster,
                                             cond)
            for i in range(self.dec_depths[s]):
                ps = getattr(self, f"dec{s}_block{i}")(
                    ps, rulebook, generator, level_dd, cond)
        zero = torch.zeros((), dtype=torch.int64, device=feat.device)
        overflow = next((d.overflow for d in (dd, token_dd) if d is not None),
                        zero)
        return ps, {
            "dedup_overflow": overflow,
            "token_v2u": token_dd.v2u if token_dd is not None else None,
            "pool_overflow": pool_overflow,
        }


class PointTransformerWithHeads(nn.Module):
    """Backbone + MLP heads (reference PointTransformerV3.py:19-110).

    Returns per-point predictions (padding rows are not zeroed, as in the
    JAX package) and the capacity diagnostics ``dedup_overflow`` (points
    whose voxel missed the level-0 or token dedup cap) and
    ``pool_overflow``. ``dedup_divisor``, ``dedup_tokens``,
    ``stem_engine``, ``pad_per_element`` (with ``num_elements``, the batch
    elements a forward holds at most), ``enable_rpe`` and ``pdnorm`` (a
    :class:`PDNormSpec`) are the backbone's options (module docstring); in
    token mode the heads run on the tokens and their predictions are
    broadcast to the points."""

    def __init__(self, dim_feat=4, use_feats=False, voxel_size=0.02,
                 enc_depths=(2, 2, 2, 6, 2),
                 enc_channels=(32, 64, 128, 256, 512),
                 enc_num_head=(2, 4, 8, 16, 32),
                 enc_patch_size=(1024,) * 5, dec_depths=(2, 2, 2, 2),
                 dec_channels=(64, 64, 128, 256), dec_num_head=(4, 4, 8, 16),
                 dec_patch_size=(1024,) * 4, drop_path=0.3, pool_shrink=2,
                 compute_dtype="float32", dedup_divisor=None,
                 dedup_tokens=False, stem_engine="gather", enable_rpe=False,
                 pad_per_element=False, num_elements=None, pdnorm=None):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        if pdnorm is not None:
            pdnorm = PDNormSpec(*pdnorm)
        self.config = dict(
            dim_feat=dim_feat, use_feats=use_feats, voxel_size=voxel_size,
            enc_depths=tuple(enc_depths), enc_channels=tuple(enc_channels),
            enc_num_head=tuple(enc_num_head),
            enc_patch_size=tuple(enc_patch_size),
            dec_depths=tuple(dec_depths), dec_channels=tuple(dec_channels),
            dec_num_head=tuple(dec_num_head),
            dec_patch_size=tuple(dec_patch_size), drop_path=drop_path,
            pool_shrink=pool_shrink, compute_dtype=compute_dtype,
            dedup_divisor=dedup_divisor, dedup_tokens=dedup_tokens,
            stem_engine=stem_engine, enable_rpe=enable_rpe,
            pad_per_element=pad_per_element, num_elements=num_elements,
            pdnorm=pdnorm,
        )
        self.use_feats = use_feats
        self.backbone = PointTransformerV3(
            dim_feat, enc_depths, enc_channels, enc_num_head,
            enc_patch_size, dec_depths, dec_channels, dec_num_head,
            dec_patch_size, drop_path=drop_path, grid_size=voxel_size,
            pool_shrink=pool_shrink, compute_dtype=compute_dtype,
            dedup_divisor=dedup_divisor, dedup_tokens=dedup_tokens,
            stem_engine=stem_engine, pad_per_element=pad_per_element,
            num_elements=num_elements, enable_rpe=enable_rpe, pdnorm=pdnorm,
        )
        head = dec_channels[0] if len(enc_depths) > 1 else enc_channels[0]
        self.semantic_head = MLPHead(head, 2)
        self.offset_head = MLPHead(head, 3)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: fan-in normals for the conv kernels,
        lecun normals for ``Dense`` kernels with zero biases, LayerNorm and
        BN scale 1, bias 0, statistics (0, 1), the RPE tables' normal of
        std 0.02 truncated at +-2 std, and the MLP heads' inits."""
        with torch.no_grad():
            for mod in self.backbone.modules():
                if isinstance(mod, (Embedding, CPE)):
                    _fan_in_normal_(mod.kernel, generator)
                    if isinstance(mod, CPE):
                        mod.bias.zero_()
                elif isinstance(mod, nn.Linear):
                    _lecun_normal_(mod.weight, mod.in_features, generator)
                    mod.bias.zero_()
                elif isinstance(mod, (MaskedBatchNorm, nn.LayerNorm)):
                    mod.reset_parameters()
                elif (isinstance(mod, SerializedAttention)
                      and mod.rpe_table is not None):
                    nn.init.trunc_normal_(mod.rpe_table, std=0.02, a=-0.04,
                                          b=0.04, generator=generator)
            self.semantic_head.reset_parameters(generator)
            self.offset_head.reset_parameters(generator)
        return self

    def clone(self, **overrides) -> "PointTransformerWithHeads":
        """A model with this one's configuration, ``overrides`` applied,
        and a copy of its weights (weights do not depend on capacities)."""
        model = PointTransformerWithHeads(**dict(self.config, **overrides))
        model.load_state_dict(self.state_dict())
        ref = next(self.parameters())
        return model.to(ref.device).train(self.training)

    def forward(self, coords, feats, batch_ids, valid, order_perms=None,
                generator=None, condition: int = 0, context=None) -> dict:
        """``order_perms`` and ``generator``: the training randomness, as
        :meth:`PointTransformerV3.forward` takes it; ``condition`` and
        ``context``: the PDNorms'."""
        if not self.use_feats:
            feats = torch.ones_like(feats)
        ps, diag = self.backbone(coords, feats, batch_ids, valid,
                                 order_perms, generator, condition, context)
        feat = ps.feat
        sem = self.semantic_head(feat, ps.valid)
        off = self.offset_head(feat, ps.valid)
        v2u = diag["token_v2u"]
        if v2u is not None:
            # the heads ran on tokens: broadcast to the points
            cap = feat.shape[0]
            ok = ((v2u < cap) & valid)[:, None]
            idx = v2u.clamp(max=cap - 1)
            feat, sem, off = feat[idx] * ok, sem[idx] * ok, off[idx] * ok
        return {
            "backbone_feats": feat,
            "semantic_prediction_logits": sem,
            "offset_predictions": off,
            "dedup_overflow": diag["dedup_overflow"],
            "pool_overflow": diag["pool_overflow"],
        }


def ptv3_loss(
    output: dict,
    flat_batch: dict,
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    group=None,
):
    """Masked loss (reference PointTransformerV3.py:102-110):
    ``(loss, {"semantic_loss", "offset_loss"})``."""
    sem_loss, off_loss = point_wise_loss(
        output["semantic_prediction_logits"],
        output["offset_predictions"],
        flat_batch["semantic_labels"],
        flat_batch["offset_labels"],
        semantic_mask=flat_batch["mask_valid"],
        offset_mask=flat_batch["mask_valid"] & flat_batch["mask_off"],
        group=group,
    )
    loss_dict = {
        "semantic_loss": sem_loss * loss_multiplier_semantic,
        "offset_loss": off_loss * loss_multiplier_offset,
    }
    return sum(loss_dict.values()), loss_dict
