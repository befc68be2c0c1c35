"""Plain PyTorch PointTransformerV3 with offset and semantic heads: a frozen
copy of the port's plain CPU path (``models/ptv3.py`` with its gather
engine, ``ops/serialization.py``, ``ops/sparse.py``'s rulebook and gather
conv, ``ops/attention.py``'s plain attention), cut to the configuration
the benchmark runs: float32, gather convs over points, packed windows, no
RPE, no PDNorm, no dedup.

The model (reference ``PointTransformerV3/PointTransformerV3.py``,
``blocks.py``; Wu et al., arXiv:2312.10035): points quantized against the
batch's minimum and serialized along four curves (z, z-trans, Hilbert,
Hilbert-trans; one permutation of them per stage in training); a 5x5x5
submanifold conv stem; five encoder stages of pre-norm blocks (xCPE, window
attention over 1,024 consecutive rows of one curve order, pairs of two
clouds masked, GELU MLP; stochastic depth in training) joined by stride-2
pooling over curve-code clusters; four decoder stages joined by unpooling
with skips; BatchNorm-ReLU MLP heads. Where the port keeps the JAX
package's conventions, so does this copy: level 0 holds points, so the
neighbor a kernel offset finds is the largest row among the points of that
voxel that the JAX hash table keeps, and the conv's gradient through its
features gathers the output gradient through the mirrored rulebook column
(the JAX package's custom VJP, not the exact transpose where points share
a voxel). Training draws its order permutations and drop-path masks from
the step's generator exactly as the port does, so both see the same ones.
Parameters are a flat ``{name: tensor}`` dict in the port's names.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import treelearn
from .rounding import EXACT

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
INVALID_BATCH = 0x7FFF
DEPTH = 16
CODE_BITS = 3 * DEPTH
MLP_RATIO = 4
COORD_BITS = 19
SLOTS_PER_BUCKET = 16
KEY_SENTINEL = torch.iinfo(torch.int64).max
_U32 = 0xFFFFFFFF
LN_EPS = 1e-6
#: BatchNorms of the stem, pooling and unpooling (flax momentum 0.99)
PTV3_BN_EPS = 1e-3
HEAD_BN_EPS = 1e-4


def arch(cfg: dict) -> dict:
    """The published widths, with ``cfg``'s overrides."""
    a = dict(enc_depths=(2, 2, 2, 6, 2), enc_channels=(32, 64, 128, 256, 512),
             enc_num_head=(2, 4, 8, 16, 32), enc_patch_size=(1024,) * 5,
             dec_depths=(2, 2, 2, 2), dec_channels=(64, 64, 128, 256),
             dec_num_head=(4, 4, 8, 16), dec_patch_size=(1024,) * 4,
             drop_path=0.3, pool_shrink=2)
    a.update({k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.items() if k in a})
    return a


# --- parameters -------------------------------------------------------------


def state_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter and BatchNorm statistic
    (inits as :func:`benchmark.reference.treelearn.state_specs` names
    them)."""
    a = arch(cfg)
    specs = []

    def linear(prefix, cin, cout):
        specs.extend([(f"{prefix}.weight", (cout, cin), "linear"),
                      (f"{prefix}.bias", (cout,), "zeros")])

    def norm(prefix, ch, stats=False):
        specs.extend([(f"{prefix}.weight", (ch,), "ones"),
                      (f"{prefix}.bias", (ch,), "zeros")])
        if stats:
            specs.extend([(f"{prefix}.running_mean", (ch,), "stat_mean"),
                          (f"{prefix}.running_var", (ch,), "stat_var")])

    def block(prefix, c):
        specs.append((f"{prefix}.cpe.kernel", (27, c, c), "fan_in"))
        specs.append((f"{prefix}.cpe.bias", (c,), "zeros"))
        linear(f"{prefix}.cpe.Dense_0", c, c)
        norm(f"{prefix}.cpe.LayerNorm_0", c)
        norm(f"{prefix}.norm1", c)
        linear(f"{prefix}.attn.qkv", c, 3 * c)
        linear(f"{prefix}.attn.proj", c, c)
        norm(f"{prefix}.norm2", c)
        linear(f"{prefix}.mlp.Dense_0", c, MLP_RATIO * c)
        linear(f"{prefix}.mlp.Dense_1", MLP_RATIO * c, c)

    enc, dec = a["enc_channels"], a["dec_channels"]
    specs.append(("backbone.embedding.kernel", (125, cfg["dim_feat"], enc[0]),
                  "fan_in"))
    norm("backbone.embedding.MaskedBatchNorm_0", enc[0], True)
    for s, depth in enumerate(a["enc_depths"]):
        if s > 0:
            linear(f"backbone.enc{s}_down.proj", enc[s - 1], enc[s])
            norm(f"backbone.enc{s}_down.norm", enc[s], True)
        for i in range(depth):
            block(f"backbone.enc{s}_block{i}", enc[s])
    n = len(a["enc_depths"])
    for s in reversed(range(n - 1)):
        coarse = enc[-1] if s == n - 2 else dec[s + 1]
        linear(f"backbone.dec{s}_up.proj", coarse, dec[s])
        norm(f"backbone.dec{s}_up.norm", dec[s], True)
        linear(f"backbone.dec{s}_up.proj_skip", enc[s], dec[s])
        norm(f"backbone.dec{s}_up.norm_skip", dec[s], True)
        for i in range(a["dec_depths"][s]):
            block(f"backbone.dec{s}_block{i}", dec[s])
    c = dec[0]
    for head, out in (("semantic_head", 2), ("offset_head", 3)):
        linear(f"{head}.Dense_0", c, c)
        norm(f"{head}.MaskedBatchNorm_0", c, True)
        specs.append((f"{head}.Dense_1.weight", (out, c), "head"))
        specs.append((f"{head}.Dense_1.bias", (out,), "zeros"))
    return specs


is_parameter = treelearn.is_parameter


# --- serialization ----------------------------------------------------------


def _interleave(x, y, z, depth):
    code = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(depth):
        for dim, c in enumerate((x, y, z)):
            code |= ((c >> i) & 1) << (3 * i + (2 - dim))
    return code


def _hilbert(grid, depth):
    X = [grid[:, d].to(torch.int64) for d in range(3)]
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


def curve_code(grid, order: str):
    if order.endswith("-trans"):
        grid = grid[:, [1, 0, 2]]
    g = grid.to(torch.int64)
    if order.startswith("z"):
        return _interleave(g[:, 0], g[:, 1], g[:, 2], DEPTH)
    return _hilbert(g, DEPTH)


class PointSet(NamedTuple):
    coord: torch.Tensor
    grid_coord: torch.Tensor
    feat: torch.Tensor
    batch: torch.Tensor
    valid: torch.Tensor
    orders: torch.Tensor
    inverses: torch.Tensor
    code: torch.Tensor


def _order_sort(batch, code):
    key = (batch.to(torch.int64) << CODE_BITS) | code
    perm = torch.sort(key, dim=-1, stable=True).indices
    inv = torch.empty_like(perm)
    arange = torch.arange(perm.shape[1], device=perm.device)
    inv.scatter_(1, perm, arange.expand_as(perm).contiguous())
    return perm, inv


def _shuffled(orders, inverses, code, perm):
    if perm is None:
        return orders, inverses, code
    perm = perm.to(orders.device)
    return orders[perm], inverses[perm], code[perm]


def quantize_grid(coord, valid, grid_size: float):
    big = torch.tensor(3.4e38, dtype=torch.float32, device=coord.device)
    mins = torch.where(valid[:, None], coord, big).amin(dim=0)
    mins = torch.where(torch.isfinite(mins), mins, 0.0)
    size = torch.tensor(grid_size, dtype=torch.float32, device=coord.device)
    grid = torch.floor((coord - mins) / size).to(torch.int64)
    return torch.where(valid[:, None], grid.clamp(min=0), 0)


def make_pointset(coord, feat, batch, valid, grid_size, perm):
    grid = quantize_grid(coord, valid, grid_size)
    batch = torch.where(valid, batch.to(torch.int64), INVALID_BATCH)
    code = torch.stack([curve_code(grid, o) for o in ORDERS])
    orders, inverses = _order_sort(batch.expand_as(code), code)
    orders, inverses, code = _shuffled(orders, inverses, code, perm)
    return PointSet(coord, grid, feat, batch, valid, orders, inverses, code)


# --- rulebook and conv ------------------------------------------------------


def _pack(key4, valid):
    k = key4.to(torch.int64)
    key = ((k[:, 0] << (3 * COORD_BITS)) | (k[:, 1] << (2 * COORD_BITS))
           | (k[:, 2] << COORD_BITS) | k[:, 3])
    return torch.where(valid, key, KEY_SENTINEL)


def _spatial_hash(c):
    c = c.to(torch.int64)
    return (((c[:, 0] * 2654435761) & _U32) ^ ((c[:, 1] * 73856093) & _U32)
            ^ ((c[:, 2] * 19349663) & _U32) ^ ((c[:, 3] * 83492791) & _U32))


def _table_rows(coords, valid):
    """The valid rows the JAX hash table keeps: the first 16 by index of
    each of its ``2^bitlen(max(8M-1, 127)) / 16`` buckets."""
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


def rulebook(coords, valid, kernel_size):
    """(M, K) neighbor rows (M: none), the center column the row itself."""
    m = coords.shape[0]
    dev = coords.device
    s_key, perm = torch.sort(_pack(coords, _table_rows(coords, valid)),
                             stable=True)
    offs = treelearn.kernel_offsets(kernel_size, dev)
    c = coords.to(torch.int64)
    limit = 1 << COORD_BITS
    cols = []
    for j in range(offs.shape[0]):
        if j == offs.shape[0] // 2:
            cols.append(torch.where(valid, torch.arange(m, device=dev), m))
            continue
        q = c.clone()
        q[:, 1:] += offs[j]
        inside = ((q[:, 1:] >= 0) & (q[:, 1:] < limit)).all(dim=-1)
        qkey = _pack(q, torch.ones_like(valid))
        pos = (torch.searchsorted(s_key, qkey, right=True) - 1).clamp(min=0)
        hit = (s_key[pos] == qkey) & inside
        idx = torch.where(hit, perm[pos], -1)
        cols.append(torch.where(valid & (idx >= 0), idx, m))
    return torch.stack(cols, dim=1)


def subset_columns(k_from, k_to):
    rf, rt = (k_from - 1) // 2, (k_to - 1) // 2
    return [((dx + rf) * k_from + (dy + rf)) * k_from + (dz + rf)
            for dx in range(-rt, rt + 1) for dy in range(-rt, rt + 1)
            for dz in range(-rt, rt + 1)]


class _Conv(torch.autograd.Function):
    """out = sum_k feats[rb[:, k]] @ W[k] over valid rows; the features'
    gradient through the mirrored columns (the JAX package's VJP)."""

    @staticmethod
    def forward(ctx, feats, weights, rb, valid):
        ctx.save_for_backward(feats, weights, rb, valid)
        m, cin = feats.shape
        pad = torch.cat([feats * valid[:, None], feats.new_zeros((1, cin))])
        w = weights
        out = feats.new_zeros((m, weights.shape[-1]))
        for j in range(weights.shape[0]):
            out = out + pad[rb[:, j]] @ w[j]
        return out * valid[:, None]

    @staticmethod
    def backward(ctx, grad):
        feats, weights, rb, valid = ctx.saved_tensors
        k = weights.shape[0]
        g = grad * valid[:, None]
        g_pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        pad = torch.cat([feats * valid[:, None],
                         feats.new_zeros((1, feats.shape[1]))])
        w = weights
        d_feats = torch.zeros_like(feats)
        d_w = []
        for j in range(k):
            d_feats = d_feats + g_pad[rb[:, k - 1 - j]] @ w[j].T
            d_w.append(pad[rb[:, j]].T @ g)
        return d_feats * valid[:, None], torch.stack(d_w), None, None


def conv(feats, weights, rb, valid, precision):
    return precision.output(_Conv.apply(
        precision.operand(feats), precision.operand(weights), rb, valid))


# --- layers -----------------------------------------------------------------


def linear(x, params, prefix):
    return F.linear(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"])


def layer_norm(x, params, prefix):
    return F.layer_norm(x, (x.shape[-1],), params[f"{prefix}.weight"],
                        params[f"{prefix}.bias"], LN_EPS)


def batch_norm(x, valid, params, prefix, train, eps):
    if train:
        w = valid.to(x.dtype)[:, None]
        cnt = w.sum().clamp(min=1.0)
        mean = torch.where(valid[:, None], x, 0.0).sum(dim=0) / cnt
        var = torch.where(valid[:, None], x - mean, 0.0).square().sum(
            dim=0) / cnt
    else:
        mean = params[f"{prefix}.running_mean"]
        var = params[f"{prefix}.running_var"]
    return ((x - mean) * torch.rsqrt(var + eps) * params[f"{prefix}.weight"]
            + params[f"{prefix}.bias"])


def attention(q, k, v, seg):
    """Plain masked window attention, (W, H, K, D) f32; rows with no
    allowed key 0."""
    scale = q.shape[-1] ** -0.5
    s = (q * scale) @ k.transpose(-1, -2)
    ok = ((seg[:, :, None] == seg[:, None, :])
          & (seg >= 0)[:, :, None])[:, None]
    s = torch.where(ok, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0).detach()
    e = torch.where(ok, torch.exp(s - m), 0.0)
    return (e / e.sum(dim=-1, keepdim=True).clamp(min=1e-20)) @ v


def windowed_attention(ps, params, prefix, heads, patch, order_index):
    p, c = ps.feat.shape
    d = c // heads
    order, inverse = ps.orders[order_index], ps.inverses[order_index]
    qkv = linear(ps.feat, params, f"{prefix}.qkv")[order]
    seg = torch.where(ps.valid[order], ps.batch[order], -1).reshape(
        p // patch, patch)
    qkv = qkv.reshape(p // patch, patch, 3, heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.cat([attention(q[w:w + 8], k[w:w + 8], v[w:w + 8],
                               seg[w:w + 8])
                     for w in range(0, q.shape[0], 8)])
    out = out.transpose(1, 2).reshape(p, c)
    return linear(out[inverse], params, f"{prefix}.proj")


def drop_path(x, rate, train, generator):
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0], 1), generator=generator,
                      device=x.device) < keep
    return x * mask / keep


def block(ps, params, prefix, rb, heads, patch, order_index, rate, train,
          generator, precision):
    valid = ps.valid
    x = conv(ps.feat, params[f"{prefix}.cpe.kernel"], rb, valid, precision)
    x = x + params[f"{prefix}.cpe.bias"] * valid[:, None]
    x = layer_norm(linear(x, params, f"{prefix}.cpe.Dense_0"), params,
                   f"{prefix}.cpe.LayerNorm_0")
    feat = ps.feat + x
    normed = ps._replace(feat=layer_norm(feat, params, f"{prefix}.norm1"))
    x = windowed_attention(normed, params, f"{prefix}.attn", heads, patch,
                           order_index)
    feat = feat + drop_path(x, rate, train, generator)
    x = layer_norm(feat, params, f"{prefix}.norm2")
    x = linear(F.gelu(linear(x, params, f"{prefix}.mlp.Dense_0")), params,
               f"{prefix}.mlp.Dense_1")
    return ps._replace(feat=feat + drop_path(x, rate, train, generator))


def _segment_amax(values, index, n, fill):
    shape = (n,) + tuple(values.shape[1:])
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    idx = index.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)


def _segment_sum(values, index, n):
    shape = (n,) + tuple(values.shape[1:])
    return torch.zeros(shape, dtype=values.dtype,
                       device=values.device).index_add(0, index, values)


def pool(ps, params, prefix, cap, perm, train):
    """Stride-2 pooling over clusters of ``code >> 3`` on the first order,
    max of the projected features, to ``cap`` rows; ``params=None`` builds
    the pooled level's structure alone."""
    p = ps.feat.shape[0]
    dev = ps.feat.device
    order0 = ps.orders[0]
    s_key = ps.code[0][order0] >> 3
    s_batch, s_valid = ps.batch[order0], ps.valid[order0]
    new = torch.ones(p, dtype=torch.bool, device=dev)
    new[1:] = (s_key[1:] != s_key[:-1]) | (s_batch[1:] != s_batch[:-1])
    new |= ~s_valid
    s_cluster = torch.cumsum(new, 0) - 1
    s_cluster_c = s_cluster.clamp(max=cap)
    cluster = s_cluster_c[ps.inverses[0]]
    w_s = s_valid.float()[:, None]
    counts = _segment_sum(w_s[:, 0], s_cluster_c, cap + 1)[:cap]
    valid = counts > 0
    coord = _segment_sum(ps.coord[order0] * w_s, s_cluster_c,
                         cap + 1)[:cap] / counts.clamp(min=1.0)[:, None]
    grid = _segment_amax(torch.where(s_valid[:, None], ps.grid_coord[order0],
                                     -1), s_cluster_c, cap + 1, -1)[:cap] >> 1
    grid = grid.clamp(min=0)
    batch = _segment_amax(torch.where(s_valid, s_batch, -1), s_cluster_c,
                          cap + 1, -1)[:cap]
    batch = torch.where(valid, batch, INVALID_BATCH)
    if params is None:
        feat = ps.feat.new_zeros((cap, 1))
    else:
        proj_s = linear(ps.feat, params, f"{prefix}.proj")[order0]
        feat = _segment_amax(torch.where(s_valid[:, None], proj_s, -3.4e38),
                             s_cluster_c, cap + 1, float("-inf"))[:cap]
        feat = torch.where(torch.isfinite(feat), feat, 0.0) * valid[:, None]
        feat = batch_norm(feat, valid, params, f"{prefix}.norm", train,
                          PTV3_BN_EPS)
        feat = F.gelu(feat) * valid[:, None]
    first = torch.searchsorted(s_cluster, torch.arange(cap, device=dev))
    head = order0[first.clamp(max=p - 1)]
    code = ps.code[:, head] >> 3
    orders, inverses = _order_sort(batch.expand_as(code), code)
    orders, inverses, code = _shuffled(orders, inverses, code, perm)
    n_clusters = (new & s_valid).sum()
    return (PointSet(coord, grid, feat, batch, valid, orders, inverses,
                     code), cluster, n_clusters)


def unpool(coarse, fine, cluster, params, prefix, train):
    x = F.gelu(batch_norm(linear(coarse.feat, params, f"{prefix}.proj"),
                          coarse.valid, params, f"{prefix}.norm", train,
                          PTV3_BN_EPS))
    skip = F.gelu(batch_norm(linear(fine.feat, params, f"{prefix}.proj_skip"),
                             fine.valid, params, f"{prefix}.norm_skip", train,
                             PTV3_BN_EPS))
    cap = x.shape[0]
    up = x[cluster.clamp(max=cap - 1)] * (cluster < cap)[:, None]
    return fine._replace(feat=(skip + up) * fine.valid[:, None])


def level_capacity(p_now, patch, shrink):
    cap = max(-(-(p_now // shrink) // patch) * patch, patch)
    return min(cap, p_now)


def drop_rates(a):
    total = sum(a["enc_depths"])
    enc = [a["drop_path"] * i / max(total - 1, 1) for i in range(total)]
    total_d = sum(a["dec_depths"])
    dec = [a["drop_path"] * i / max(total_d - 1, 1) for i in range(total_d)]
    return enc, dec


def split_step_generator(generator, device):
    seeds = torch.randint(0, 2**62, (2,), generator=generator)
    shuffle = torch.Generator().manual_seed(int(seeds[0]))
    drop = torch.Generator(device=device).manual_seed(int(seeds[1]))
    return shuffle, drop


def forward(params, cfg, coord, feat, batch, valid, train: bool,
            step_generator=None, precision=EXACT):
    """``(semantic logits, offsets)`` of every row of the flat padded batch
    (padding rows included); ``step_generator``: the train step's."""
    a = arch(cfg)
    n_stages = len(a["enc_depths"])
    perms, drop_gen = [None] * n_stages, None
    if train:
        shuffle, drop_gen = split_step_generator(step_generator, coord.device)
        perms = [torch.randperm(len(ORDERS), generator=shuffle)
                 for _ in range(n_stages)]
    ps = make_pointset(coord, feat, batch, valid, cfg["voxel_size"], perms[0])
    coords4 = torch.cat([ps.batch[:, None], ps.grid_coord], dim=1)
    rb5 = rulebook(coords4, ps.valid, 5)
    x = conv(ps.feat, params["backbone.embedding.kernel"], rb5, ps.valid,
             precision)
    x = batch_norm(x, ps.valid, params, "backbone.embedding.MaskedBatchNorm_0",
                   train, PTV3_BN_EPS)
    ps = ps._replace(feat=F.gelu(x) * ps.valid[:, None])
    enc_dp, dec_dp = drop_rates(a)
    skips, rb, dp_i, overflow = [], None, 0, 0
    for s in range(n_stages):
        if s > 0:
            cap = level_capacity(ps.feat.shape[0], a["enc_patch_size"][s],
                                 a["pool_shrink"])
            coarse, cluster, n_clusters = pool(
                ps, params, f"backbone.enc{s}_down", cap, perms[s], train)
            overflow = overflow + (n_clusters - cap).clamp(min=0)
            skips.append((ps, cluster, rb))
            ps = coarse
        if s == 0:
            rb = rb5[:, subset_columns(5, 3)]
        else:
            rb = rulebook(torch.cat([ps.batch[:, None], ps.grid_coord], 1),
                          ps.valid, 3)
        for i in range(a["enc_depths"][s]):
            ps = block(ps, params, f"backbone.enc{s}_block{i}", rb,
                       a["enc_num_head"][s], a["enc_patch_size"][s],
                       i % len(ORDERS), enc_dp[dp_i], train, drop_gen,
                       precision)
            dp_i += 1
    for s in reversed(range(n_stages - 1)):
        fine, cluster, rb = skips.pop()
        ps = unpool(ps, fine, cluster, params, f"backbone.dec{s}_up", train)
        depths = a["dec_depths"]
        rates = dec_dp[sum(depths[:s]):sum(depths[:s + 1])][::-1]
        for i in range(depths[s]):
            ps = block(ps, params, f"backbone.dec{s}_block{i}", rb,
                       a["dec_num_head"][s], a["dec_patch_size"][s],
                       i % len(ORDERS), rates[i], train, drop_gen, precision)
    out = []
    for head in ("semantic_head", "offset_head"):
        x = linear(ps.feat, params, f"{head}.Dense_0")
        x = torch.relu(batch_norm(x, ps.valid, params,
                                  f"{head}.MaskedBatchNorm_0", train,
                                  HEAD_BN_EPS))
        out.append(linear(x, params, f"{head}.Dense_1"))
    return out[0], out[1], int(overflow)


# --- what the benchmark hands the reference ---------------------------------


def cloud_batch(clouds, model_cfg: dict, noise_distance: float, device):
    """A batch of labeled clouds ((n, 11) arrays) as the flat layout the
    model takes (all rows valid: the clouds fill whole buckets), with
    their labels."""
    dim = model_cfg["dim_feat"]
    arrays = [torch.as_tensor(c, device=device) for c in clouds]
    data = torch.cat(arrays)
    length = data[:, 3:6].norm(dim=1)
    return {"cfg": model_cfg, "coord": data[:, :3],
            "feat": data[:, 7:7 + dim].contiguous(),
            "batch": torch.cat([torch.full((len(a),), i, device=device)
                                for i, a in enumerate(arrays)]),
            "valid": torch.ones(len(data), dtype=torch.bool, device=device),
            "semantic": (length > noise_distance).long(),
            "offsets": data[:, 3:6],
            "offset_mask": length <= noise_distance}


def batch_loss(params: dict, batch: dict, precision=EXACT):
    """The training loss of ``batch`` (:func:`cloud_batch`) under the
    step generator seeded ``batch["step_seed"]``."""
    generator = torch.Generator().manual_seed(batch["step_seed"])
    sem, off, _ = forward(params, batch["cfg"], batch["coord"], batch["feat"],
                          batch["batch"], batch["valid"], True, generator,
                          precision)
    return treelearn.loss(sem, off, batch["semantic"], batch["offsets"],
                          batch["offset_mask"])


def _pairs(rb, valid):
    return int((rb[valid] < rb.shape[0]).sum())


def _window_pairs(ps, order_index, patch):
    """Allowed (query, key) pairs of the windows of one order: per window,
    the squares of its clouds' row counts."""
    order = ps.orders[order_index]
    seg = torch.where(ps.valid[order], ps.batch[order], -1)
    window = torch.arange(seg.numel(), device=seg.device) // patch
    keys = window[seg >= 0] * (INVALID_BATCH + 1) + seg[seg >= 0]
    return int(torch.bincount(keys).square().sum())


def step_layers(cfg: dict, coord, batch, valid, step_seed) -> list[dict]:
    """Every matmul-shaped layer of one training forward over this batch
    under the step generator seeded ``step_seed`` (the permutations it
    draws decide the windows and the pooling; ``None``: an eval forward,
    unshuffled): ``{"kind", "pairs", "cin",
    "cout", ...}`` as :func:`benchmark.reference.treelearn.conv_layers`
    gives them, ``subm`` and ``stem`` convs over present rulebook entries of
    valid rows, linears over valid rows, and ``attn`` (``pairs`` allowed
    query-key pairs, ``heads``, ``head_dim``)."""
    a = arch(cfg)
    n_stages = len(a["enc_depths"])
    perms = [None] * n_stages
    if step_seed is not None:
        shuffle, _ = split_step_generator(
            torch.Generator().manual_seed(step_seed), coord.device)
        perms = [torch.randperm(len(ORDERS), generator=shuffle)
                 for _ in range(n_stages)]
    feat = coord.new_zeros((coord.shape[0], 1))
    ps = make_pointset(coord, feat, batch, valid, cfg["voxel_size"], perms[0])
    rb5 = rulebook(torch.cat([ps.batch[:, None], ps.grid_coord], 1),
                   ps.valid, 5)
    enc, dec = a["enc_channels"], a["dec_channels"]
    rows0 = int(ps.valid.sum())
    layers = [dict(kind="stem", pairs=_pairs(rb5, ps.valid), rows=rows0,
                   cin=cfg["dim_feat"], cout=enc[0], k=125)]
    levels = []
    for s in range(n_stages):
        if s > 0:
            fine_rows = int(ps.valid.sum())
            cap = level_capacity(ps.feat.shape[0], a["enc_patch_size"][s],
                                 a["pool_shrink"])
            ps, _, _ = pool(ps, None, None, cap, perms[s], False)
            layers.append(dict(kind="linear", pairs=fine_rows,
                               cin=enc[s - 1], cout=enc[s]))
        rb = (rb5[:, subset_columns(5, 3)] if s == 0 else rulebook(
            torch.cat([ps.batch[:, None], ps.grid_coord], 1), ps.valid, 3))
        levels.append((ps, _pairs(rb, ps.valid), int(ps.valid.sum())))

    def blocks(level, c, heads, patch, depth):
        ps, pairs, rows = level
        for i in range(depth):
            layers.append(dict(kind="subm", pairs=pairs, rows=rows, cin=c,
                               cout=c, k=27))
            for cin, cout in ((c, c), (c, 3 * c), (c, c), (c, MLP_RATIO * c),
                              (MLP_RATIO * c, c)):
                layers.append(dict(kind="linear", pairs=rows, cin=cin,
                                   cout=cout))
            layers.append(dict(kind="attn", rows=rows, heads=heads,
                               head_dim=c // heads,
                               pairs=_window_pairs(ps, i % len(ORDERS),
                                                   patch)))

    for s in range(n_stages):
        blocks(levels[s], enc[s], a["enc_num_head"][s],
               a["enc_patch_size"][s], a["enc_depths"][s])
    for s in reversed(range(n_stages - 1)):
        coarse = enc[-1] if s == n_stages - 2 else dec[s + 1]
        layers.append(dict(kind="linear", pairs=levels[s + 1][2],
                           cin=coarse, cout=dec[s]))
        layers.append(dict(kind="linear", pairs=levels[s][2], cin=enc[s],
                           cout=dec[s]))
        blocks(levels[s], dec[s], a["dec_num_head"][s],
               a["dec_patch_size"][s], a["dec_depths"][s])
    for out in (2, 3):
        for cin, cout in ((dec[0], dec[0]), (dec[0], out)):
            layers.append(dict(kind="linear", pairs=rows0, cin=cin,
                               cout=cout))
    return layers


def window_layers(clouds, steps, step_seeds, model_cfg: dict,
                  device) -> list:
    """:func:`step_layers` of each step of a window: ``steps[i]`` holds the
    indices into ``clouds`` of step ``i``'s trees, ``step_seeds[i]`` its
    generator's seed."""
    out = []
    for idx, step_seed in zip(steps, step_seeds):
        b = cloud_batch([clouds[i] for i in idx], model_cfg, 0.0, device)
        out.append(step_layers(model_cfg, b["coord"], b["batch"], b["valid"],
                               step_seed))
    return out


def padded_cloud(cloud, model_cfg: dict, device, bucket: int = 1024):
    """One raw cloud as the pipeline pads it for a forward: rows rounded
    up to ``bucket``, the padding invalid and zero."""
    n = len(cloud)
    p = max(-(-n // bucket) * bucket, bucket)
    dim = model_cfg["dim_feat"]
    coord = torch.zeros((p, 3), device=device)
    feat = torch.zeros((p, dim), device=device)
    coord[:n] = torch.as_tensor(cloud[:, :3], device=device)
    feat[:n] = torch.as_tensor(cloud[:, 7:7 + dim], device=device)
    return (coord, feat, torch.zeros(p, dtype=torch.int64, device=device),
            torch.arange(p, device=device) < n)


def serve_forward(params: dict, cloud, model_cfg: dict, device,
                  precision=EXACT):
    """``(semantic logits, offsets)`` of every point of one raw cloud, the
    model in eval mode (no order shuffles, no stochastic depth, BatchNorm
    on its running statistics)."""
    n = len(cloud)
    sem, off, _ = forward(params, model_cfg, *padded_cloud(
        cloud, model_cfg, device), False, None, precision)
    return sem[:n], off[:n]


def cloud_layers(cloud, model_cfg: dict, device) -> list:
    """:func:`step_layers` of one eval forward over one raw cloud."""
    coord, _, batch, valid = padded_cloud(cloud, model_cfg, device)
    return step_layers(model_cfg, coord, batch, valid, None)
