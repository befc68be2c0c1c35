"""Plain PyTorch TreeLearn: the sparse U-Net with offset and semantic heads,
its loss, and the work its layers do.

Written from the published model (reference ``Modules/TreeLearn/
TreeLearn.py``, ``blocks.py``): voxelize each cloud against its own minimum
corner, average ``[features, ones]`` per voxel, a submanifold input conv,
a recursive U-Net of pre-activation residual pairs joined by stride-2
convs (2x2x2 kernels, one filter per child octant) and skip concatenation,
BatchNorm and ReLU, each point reading its voxel's features, and two
Linear-BatchNorm-ReLU-Linear heads. Submanifold convs are explicit
neighbor gathers over exact lookups of the occupied voxels; nothing is
capped or padded. Every tensor is float32 and the matmuls run with TF32
off; ``precision`` (:mod:`.rounding`) rounds the convs' operands and
their gradients to a lower precision (the control). Parameters are a flat ``{name: tensor}`` dict in the published
flax tree's names (``backbone.unet.block0.SubMConv_0.kernel``,
``offset_head.Dense_1.weight``, ...); kernels are ``(K, Cin, Cout)`` with
the kernel offsets in (dx, dy, dz) order, dz fastest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rounding import EXACT

BN_EPS = 1e-4
COORD_BITS = 19


def n_planes(cfg: dict) -> list[int]:
    return [cfg["channels"] * (i + 1) for i in range(cfg["num_blocks"])]


def state_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter and BatchNorm statistic,
    in a fixed order. ``init``: ``fan_in`` (normal, variance 1/fan-in over
    all dims but the last), ``linear`` (a Linear's weight, normal with
    variance 1/in), ``head`` (normal, std 0.01), ``ones``, ``zeros``;
    ``stat_mean`` and ``stat_var`` mark running statistics."""
    k = cfg.get("kernel_size", 3) ** 3
    c = cfg["channels"]
    specs = []

    def bn(prefix, ch):
        specs.extend([(f"{prefix}.weight", (ch,), "ones"),
                      (f"{prefix}.bias", (ch,), "zeros"),
                      (f"{prefix}.running_mean", (ch,), "stat_mean"),
                      (f"{prefix}.running_var", (ch,), "stat_var")])

    def block(prefix, cin, cout):
        if cin != cout:
            specs.append((f"{prefix}.shortcut", (cin, cout), "fan_in"))
        bn(f"{prefix}.MaskedBatchNorm_0", cin)
        specs.append((f"{prefix}.SubMConv_0.kernel", (k, cin, cout),
                      "fan_in"))
        bn(f"{prefix}.MaskedBatchNorm_1", cout)
        specs.append((f"{prefix}.SubMConv_1.kernel", (k, cout, cout),
                      "fan_in"))

    specs.append(("backbone.input_conv.kernel",
                  (k, cfg["dim_feat"] + 3, c), "fan_in"))
    planes = n_planes(cfg)
    prefix = "backbone.unet"
    for depth, c0 in enumerate(planes):
        for i in range(2):
            block(f"{prefix}.block{i}", c0, c0)
        if depth + 1 < len(planes):
            c1 = planes[depth + 1]
            bn(f"{prefix}.MaskedBatchNorm_0", c0)
            specs.append((f"{prefix}.down_kernel", (8, c0, c1), "fan_in"))
            bn(f"{prefix}.MaskedBatchNorm_1", c1)
            specs.append((f"{prefix}.up_kernel", (8, c1, c0), "fan_in"))
            for i in range(2):
                block(f"{prefix}.tail{i}", 2 * c0 if i == 0 else c0, c0)
            prefix += ".u"
    bn("backbone.output_norm", c)
    for head, out in (("semantic_head", 2), ("offset_head", 3)):
        specs.append((f"{head}.Dense_0.weight", (c, c), "linear"))
        specs.append((f"{head}.Dense_0.bias", (c,), "zeros"))
        bn(f"{head}.MaskedBatchNorm_0", c)
        specs.append((f"{head}.Dense_1.weight", (out, c), "head"))
        specs.append((f"{head}.Dense_1.bias", (out,), "zeros"))
    return specs


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def kernel_offsets(kernel_size: int, device) -> torch.Tensor:
    r = (kernel_size - 1) // 2
    rng = range(-r, r + 1)
    return torch.tensor([(dx, dy, dz) for dx in rng for dy in rng
                         for dz in rng], dtype=torch.int64, device=device)


def pack(b: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """One int64 key per (batch, x, y, z); coordinates in [0, 2^19)."""
    return ((b << (3 * COORD_BITS)) | (xyz[:, 0] << (2 * COORD_BITS))
            | (xyz[:, 1] << COORD_BITS) | xyz[:, 2])


class Level(NamedTuple):
    """The occupied voxels of one resolution: sorted keys, their batch
    element and grid coordinates, and each voxel's neighbor under every
    kernel offset (-1: none)."""

    keys: torch.Tensor  # (M,) int64, ascending
    b: torch.Tensor  # (M,) int64
    xyz: torch.Tensor  # (M, 3) int64
    nbr: torch.Tensor  # (M, K) int64


class Structure(NamedTuple):
    """What a batch of clouds makes of the network's sparse structure."""

    point_voxel: torch.Tensor  # (P_valid,) level-0 voxel of each point
    voxel_feats: torch.Tensor  # (M0, dim_feat + 3) float32
    levels: list  # Level per resolution, finest first
    parents: list  # (M_l,) voxel of level l+1 holding each voxel of level l
    octants: list  # (M_l,) that voxel's child octant in [0, 8)


def neighbors(keys, b, xyz, kernel_size):
    offs = kernel_offsets(kernel_size, keys.device)
    q = xyz[:, None, :] + offs[None]  # (M, K, 3)
    inside = ((q >= 0) & (q < (1 << COORD_BITS))).all(dim=-1)
    qk = pack(b[:, None].expand(-1, offs.shape[0]).reshape(-1),
              q.clamp(min=0).reshape(-1, 3)).reshape(q.shape[:2])
    pos = torch.searchsorted(keys, qk).clamp(max=keys.numel() - 1)
    hit = (keys[pos] == qk) & inside
    return torch.where(hit, pos, -1)


def level_of(b, xyz, kernel_size):
    keys, inverse = torch.unique(pack(b, xyz), return_inverse=True)
    first = torch.full((keys.numel(),), b.numel(), dtype=torch.int64,
                       device=b.device)
    first.scatter_reduce_(0, inverse, torch.arange(b.numel(),
                                                   device=b.device), "amin")
    lb, lxyz = b[first], xyz[first]
    return Level(keys, lb, lxyz, neighbors(keys, lb, lxyz, kernel_size)), \
        inverse


def structure(coords, feats, batch_ids, voxel_size: float, n_levels: int,
              kernel_size: int = 3) -> Structure:
    """Voxels, voxel features and every level's neighbors of the valid
    points ``coords`` (P, 3), ``feats`` (P, F), ``batch_ids`` (P,)."""
    dev = coords.device
    b = batch_ids.to(torch.int64)
    n_b = int(b.max()) + 1
    mins = torch.full((n_b, 3), float("inf"), device=dev)
    mins = mins.scatter_reduce(0, b[:, None].expand(-1, 3), coords, "amin")
    size = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    xyz = torch.floor((coords - mins[b]) / size).to(torch.int64).clamp(min=0)
    level, p2v = level_of(b, xyz, kernel_size)
    m = level.keys.numel()
    sums = torch.zeros((m, feats.shape[1]), device=dev).index_add_(
        0, p2v, feats)
    counts = torch.zeros(m, device=dev).index_add_(
        0, p2v, torch.ones_like(p2v, dtype=torch.float32))
    vfeats = torch.cat([sums / counts[:, None],
                        torch.ones((m, 3), device=dev)], dim=1)
    levels, parents, octants = [level], [], []
    for _ in range(n_levels - 1):
        fine = levels[-1]
        octants.append(((fine.xyz[:, 0] & 1) << 2)
                       | ((fine.xyz[:, 1] & 1) << 1) | (fine.xyz[:, 2] & 1))
        coarse, parent = level_of(fine.b, fine.xyz >> 1, kernel_size)
        levels.append(coarse)
        parents.append(parent)
    return Structure(p2v, vfeats, levels, parents, octants)


def batch_norm(x, params, prefix, train: bool):
    if train:
        mean = x.mean(dim=0)
        var = (x - mean).square().mean(dim=0)
    else:
        mean = params[f"{prefix}.running_mean"]
        var = params[f"{prefix}.running_var"]
    return ((x - mean) * torch.rsqrt(var + BN_EPS) * params[f"{prefix}.weight"]
            + params[f"{prefix}.bias"])


class _SubmConv(torch.autograd.Function):
    """out[i] = sum_k x[nbr(i, k)] @ w[k]. Its gradient gathers too: the
    voxel j = nbr(i, k) sees i as nbr(j, K-1-k) (the offsets are
    enumerated so that offset K-1-k is minus offset k), so
    dx[j] = sum_k g[nbr(j, K-1-k)] @ w[k]^T, the exact transpose."""

    @staticmethod
    def forward(ctx, x, w, nbr):
        ctx.save_for_backward(x, w, nbr)
        k, cin, cout = w.shape
        return _gathered(x, nbr).reshape(-1, k * cin) @ w.reshape(
            k * cin, cout)

    @staticmethod
    def backward(ctx, g):
        x, w, nbr = ctx.saved_tensors
        k, cin, cout = w.shape
        dx = _gathered(g, nbr.flip(1)).reshape(-1, k * cout) @ w.transpose(
            1, 2).reshape(k * cout, cin)
        dw = torch.einsum("mkc,md->kcd", _gathered(x, nbr), g)
        return dx, dw, None


def _gathered(x, nbr):
    """(M, K, C): row nbr(i, k) of ``x`` at [i, k], zeros where none."""
    padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return padded[torch.where(nbr >= 0, nbr, x.shape[0])]


def subm_conv(x, w, level: Level, precision):
    """out[i] = sum_k x[nbr(i, k)] @ w[k] over the neighbors present."""
    return precision.output(_SubmConv.apply(
        precision.operand(x), precision.operand(w), level.nbr))


def down_conv(x, w, parent, octant, n_coarse, precision):
    """coarse[j] = sum over children i of j of x[i] @ w[octant(i)]."""
    x, w = precision.operand(x), precision.operand(w)
    return precision.output(x.new_zeros((n_coarse, w.shape[-1])).index_add(
        0, parent, by_octant(x, w, octant)))


def up_conv(x, w, parent, octant, precision):
    """fine[i] = x[parent(i)] @ w[octant(i)]."""
    x, w = precision.operand(x), precision.operand(w)
    return precision.output(by_octant(x.index_select(0, parent), w, octant))


def by_octant(x, w, octant):
    """Row i of ``x`` times ``w[octant(i)]``."""
    return sum((x * (octant == o)[:, None]) @ w[o] for o in range(8))


def residual_block(x, params, prefix, level, train, precision):
    identity = x
    if f"{prefix}.shortcut" in params:
        identity = x @ params[f"{prefix}.shortcut"]
    y = torch.relu(batch_norm(x, params, f"{prefix}.MaskedBatchNorm_0", train))
    y = subm_conv(y, params[f"{prefix}.SubMConv_0.kernel"], level, precision)
    y = torch.relu(batch_norm(y, params, f"{prefix}.MaskedBatchNorm_1", train))
    y = subm_conv(y, params[f"{prefix}.SubMConv_1.kernel"], level, precision)
    return y + identity


def unet(x, params, st: Structure, depth: int, prefix: str, train, precision):
    level = st.levels[depth]
    for i in range(2):
        x = residual_block(x, params, f"{prefix}.block{i}", level, train,
                           precision)
    if depth + 1 == len(st.levels):
        return x
    identity = x
    parent, octant = st.parents[depth], st.octants[depth]
    d = torch.relu(batch_norm(x, params, f"{prefix}.MaskedBatchNorm_0", train))
    d = down_conv(d, params[f"{prefix}.down_kernel"], parent, octant,
                  st.levels[depth + 1].keys.numel(), precision)
    d = unet(d, params, st, depth + 1, f"{prefix}.u", train, precision)
    u = torch.relu(batch_norm(d, params, f"{prefix}.MaskedBatchNorm_1", train))
    u = up_conv(u, params[f"{prefix}.up_kernel"], parent, octant, precision)
    x = torch.cat([identity, u], dim=1)
    for i in range(2):
        x = residual_block(x, params, f"{prefix}.tail{i}", level, train,
                           precision)
    return x


def head(x, params, prefix, train):
    x = x @ params[f"{prefix}.Dense_0.weight"].T + params[f"{prefix}.Dense_0.bias"]
    x = torch.relu(batch_norm(x, params, f"{prefix}.MaskedBatchNorm_0", train))
    return x @ params[f"{prefix}.Dense_1.weight"].T + params[f"{prefix}.Dense_1.bias"]


def forward(params: dict, st: Structure, train: bool, precision=EXACT):
    """``(semantic logits (P, 2), offsets (P, 3))`` of the valid points
    that ``st`` was built from."""
    x = subm_conv(st.voxel_feats, params["backbone.input_conv.kernel"],
                  st.levels[0], precision)
    x = unet(x, params, st, 0, "backbone.unet", train, precision)
    x = torch.relu(batch_norm(x, params, "backbone.output_norm", train))
    points = x.index_select(0, st.point_voxel)
    return (head(points, params, "semantic_head", train),
            head(points, params, "offset_head", train))


def loss(semantic_logits, offsets, semantic_labels, offset_labels,
         offset_mask):
    """The reference's ``Loss.py``: cross-entropy averaged over the points
    plus the mean over the offset-supervised points of
    ``sqrt(max(|pred - label|^2, 1e-8))``."""
    ce = torch.nn.functional.cross_entropy(semantic_logits,
                                           semantic_labels.long())
    dist = (offsets - offset_labels).square().sum(dim=1).clamp(
        min=1e-8).sqrt()
    w = offset_mask.float()
    return ce + (dist * w).sum() / w.sum().clamp(min=1.0)


# --- work of a forward ------------------------------------------------------


def level_counts(st: Structure) -> list[tuple[int, int]]:
    """``(voxels, present neighbor pairs)`` of each level."""
    return [(lv.keys.numel(), int((lv.nbr >= 0).sum())) for lv in st.levels]


def conv_layers(cfg: dict, counts: list, points: int) -> list[dict]:
    """Every matmul-shaped layer of one forward over clouds whose levels
    hold ``counts`` (:func:`level_counts`, summed over the clouds) and
    ``points`` points: ``{"kind", "rows", "pairs", "cin", "cout", "k",
    "level"}``. ``kind``: ``subm`` (a submanifold conv, ``pairs`` present
    (output, input) voxel pairs), ``stem`` (the input conv, a submanifold
    conv whose input needs no gradient), ``down``/``up`` (stride-2 convs,
    one product per fine voxel), ``linear``."""
    k = cfg.get("kernel_size", 3) ** 3
    planes = n_planes(cfg)
    layers = [dict(kind="stem", level=0, rows=counts[0][0],
                   pairs=counts[0][1], cin=cfg["dim_feat"] + 3,
                   cout=cfg["channels"], k=k)]
    for depth, c0 in enumerate(planes):
        m, pairs = counts[depth]
        widths = [(c0, c0)] * 4
        if depth + 1 < len(planes):
            c1 = planes[depth + 1]
            widths += [(2 * c0, c0)] + [(c0, c0)] * 3
            layers.append(dict(kind="linear", level=depth, rows=m, pairs=m,
                               cin=2 * c0, cout=c0, k=1))
            for kind, cin, cout in (("down", c0, c1), ("up", c1, c0)):
                layers.append(dict(kind=kind, level=depth, rows=m, pairs=m,
                                   cin=cin, cout=cout, k=8))
        for cin, cout in widths:
            layers.append(dict(kind="subm", level=depth, rows=m,
                               pairs=pairs, cin=cin, cout=cout, k=k))
    c = cfg["channels"]
    for out in (2, 3):
        for cin, cout in ((c, c), (c, out)):
            layers.append(dict(kind="linear", level=None, rows=points,
                               pairs=points, cin=cin, cout=cout, k=1))
    return layers


# --- what the benchmark hands the reference ---------------------------------


def cloud_batch(clouds, model_cfg: dict, noise_distance: float, device):
    """A batch of labeled clouds ((n, 11) arrays: x, y, z, the offset back
    to the surface, a cylinder id, features) as the reference's inputs:
    the valid points' coordinates, features and batch ids, their labels
    (noise where the offset is longer than ``noise_distance``; offsets
    supervised where it is not) and the batch's :class:`Structure`."""
    dim = model_cfg["dim_feat"]
    arrays = [torch.as_tensor(c, device=device) for c in clouds]
    data = torch.cat(arrays)
    batch_ids = torch.cat([torch.full((len(a),), i, device=device)
                           for i, a in enumerate(arrays)])
    offsets = data[:, 3:6]
    length = offsets.norm(dim=1)
    st = structure(data[:, :3], data[:, 7:7 + dim], batch_ids,
                   model_cfg["voxel_size"], model_cfg["num_blocks"],
                   model_cfg.get("kernel_size", 3))
    return {"structure": st, "semantic": (length > noise_distance).long(),
            "offsets": offsets, "offset_mask": length <= noise_distance}


def batch_loss(params: dict, batch: dict, precision=EXACT):
    """The training loss of ``batch`` (:func:`cloud_batch`)."""
    sem, off = forward(params, batch["structure"], True, precision)
    return loss(sem, off, batch["semantic"], batch["offsets"],
                batch["offset_mask"])


def tree_counts(cloud, model_cfg: dict, device) -> list:
    """:func:`level_counts` of one labeled cloud alone (the levels of a
    batch are its clouds' levels side by side)."""
    c = torch.as_tensor(cloud, device=device)
    st = structure(c[:, :3], c[:, 7:7 + model_cfg["dim_feat"]],
                   torch.zeros(len(c), dtype=torch.int64, device=device),
                   model_cfg["voxel_size"], model_cfg["num_blocks"],
                   model_cfg.get("kernel_size", 3))
    return level_counts(st)


def window_layers(clouds, steps, step_seeds, model_cfg: dict,
                  device) -> list:
    """:func:`conv_layers` of each step of a window: ``steps[i]`` holds the
    indices into ``clouds`` of step ``i``'s trees (TreeLearn draws nothing
    at random, so ``step_seeds`` does not matter)."""
    counts = [tree_counts(c, model_cfg, device) for c in clouds]
    return [conv_layers(model_cfg, summed([counts[i] for i in idx]),
                        sum(len(clouds[i]) for i in idx)) for idx in steps]


def summed(counts: list) -> list:
    """Per-level ``(voxels, pairs)`` of a batch from its clouds' own."""
    return [tuple(sum(c[level][i] for c in counts) for i in range(2))
            for level in range(len(counts[0]))]


def serve_forward(params: dict, cloud, model_cfg: dict, device,
                  precision=EXACT):
    """``(semantic logits, offsets)`` of every point of one raw cloud
    ((n, >= 11): x, y, z, ..., features in columns 7 on), the model in
    eval mode (BatchNorm on its running statistics)."""
    c = torch.as_tensor(cloud[:, :7 + model_cfg["dim_feat"]], device=device)
    st = structure(c[:, :3], c[:, 7:], torch.zeros(len(c), dtype=torch.int64,
                                                  device=device),
                   model_cfg["voxel_size"], model_cfg["num_blocks"],
                   model_cfg.get("kernel_size", 3))
    return forward(params, st, False, precision)


def cloud_layers(cloud, model_cfg: dict, device) -> list:
    """:func:`conv_layers` of one forward over one raw cloud."""
    return conv_layers(model_cfg, tree_counts(cloud, model_cfg, device),
                       len(cloud))
