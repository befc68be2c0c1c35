"""TreeLearn: submanifold sparse U-Net with offset/semantic heads, as torch
modules.

Port of ``treemorph_tpu/models/treelearn.py`` (reference
``Modules/TreeLearn/TreeLearn.py`` + ``blocks.py``): voxelize -> input
submanifold conv -> recursive U-Net (channels i*C, stride-2 down / inverse
up convs, pairs of residual blocks, skip concat) -> BN+ReLU -> per-point
unprojection -> MLP heads. Every resolution level builds one rulebook (or
band plan) shared by all its submanifold convs (the reference's
``indice_key``).

Module and parameter names follow the flax tree (``block0``,
``MaskedBatchNorm_0``, ``SubMConv_1``, ``down_kernel``, ``u``, ...) so
:func:`treemorph_tpu_torch.models.convert.flax_to_state_dict` maps one to
the other by path. Submanifold kernels keep the JAX layout
``(K, Cin, Cout)`` in kernel-offset order (dz fastest).

Engines (``engine``), as the JAX package's:

- ``"gather"``: rulebook gather-matmul convs (:mod:`..ops.sparse`);
- ``"band"``: the band conv kernel (:mod:`..ops.bandconv`);
- ``"zpack"``: z-packed rows over the same blocks (:class:`..ops.sparse.
  ZPlan`);
- ``"pencil"``: z-pencil rows, 9 row gathers and banded matmuls per conv
  (:mod:`..ops.pencil`), the level's features held in the pencil layout
  through its residual blocks; pencils capped at ``3 M //
  pencil_divisor``;
- ``"brick"``: dense 4^3 bricks (:mod:`..ops.bricks`, ``brick_impl``
  ``"conv"`` or ``"xslab"``), bricks capped at ``M // brick_divisor``.

zpack, pencil and brick serve 3x3x3 kernels; at another ``kernel_size``
they take the gather engine, as in the JAX package. Voxels that the pencil
and brick caps drop are counted in the outputs' ``dropped_voxels``. The
pencil blocks' parameters carry the gather blocks' names (one checkpoint
serves gather, band, zpack and pencil); the brick blocks' are the JAX
package's own (``bn0``, ``conv0``, ``bn1``, ``conv1``). Rulebook lookups
are exact, so there is no ``verify_coords`` switch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.bandconv import choose_band_plan
from ..ops.bricks import brick_subm_conv, brickize, from_dense, to_dense
from ..ops.pencil import (
    build_pencils,
    from_pencil,
    pencil_conv_apply,
    to_pencil,
)
from ..ops.sparse import (
    build_downsample,
    build_rulebook,
    build_zplan,
    down_conv_apply,
    inverse_conv_apply,
    subm_conv_apply,
)
from ..ops.voxelize import voxelize_treelearn_features
from .loss import point_wise_loss

ENGINES = ("gather", "band", "zpack", "pencil", "brick")
BRICK_IMPLS = ("conv", "xslab")


def _conv_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}[name]


def _fan_in_normal_(w: torch.Tensor, generator) -> None:
    """flax ``variance_scaling(1.0, "fan_in", "normal")``: a normal (not
    truncated) with variance 1/fan_in, fan_in = product of all dims but the
    last."""
    fan_in = math.prod(w.shape[:-1])
    nn.init.normal_(w, std=math.sqrt(1.0 / fan_in), generator=generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows only (padding excluded from statistics).
    Momentum 0.1 (new = 0.9 old + 0.1 batch), eps 1e-4 (the reference's
    norm_fn); eval uses the running statistics."""

    def __init__(self, channels: int, momentum: float = 0.1,
                 eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, mask):
        if self.training:
            w = mask.to(x.dtype)[:, None]
            cnt = w.sum().clamp(min=1.0)
            xw = torch.where(mask[:, None], x, 0.0)
            mean = xw.sum(dim=0) / cnt
            centered = torch.where(mask[:, None], x - mean, 0.0)
            var = centered.square().sum(dim=0) / cnt
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean
                )
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class SubMConv(nn.Module):
    """Submanifold conv layer over a precomputed rulebook or band plan
    (no bias)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, conv_dtype: str = "float32"):
        super().__init__()
        self.conv_dtype = conv_dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size**3, in_channels, out_channels)
        )

    def forward(self, feats, ctx, valid):
        return subm_conv_apply(
            feats, self.kernel, ctx, valid,
            compute_dtype=_conv_dtype(self.conv_dtype),
        )


class ResidualBlock(nn.Module):
    """Pre-activation residual pair of submanifold convs
    (reference TreeLearn/blocks.py:44-81)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, conv_dtype: str = "float32"):
        super().__init__()
        if in_channels != out_channels:
            self.shortcut = nn.Parameter(
                torch.empty(in_channels, out_channels)
            )
        else:
            self.shortcut = None
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels)
        self.SubMConv_0 = SubMConv(in_channels, out_channels, kernel_size,
                                   conv_dtype)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels)
        self.SubMConv_1 = SubMConv(out_channels, out_channels, kernel_size,
                                   conv_dtype)

    def forward(self, feats, ctx, valid):
        identity = feats if self.shortcut is None else feats @ self.shortcut
        x = torch.relu(self.MaskedBatchNorm_0(feats, valid))
        x = self.SubMConv_0(x, ctx, valid)
        x = torch.relu(self.MaskedBatchNorm_1(x, valid))
        x = self.SubMConv_1(x, ctx, valid)
        return x + identity


class PencilSubMConv(SubMConv):
    """A submanifold conv on the pencil engine, flat rows in and out (the
    input conv); the parameter is :class:`SubMConv`'s ``kernel``."""

    def forward(self, feats, ps, valid):
        core = to_pencil(feats * valid[:, None], ps)
        out = pencil_conv_apply(core, self.kernel, ps,
                                compute_dtype=_conv_dtype(self.conv_dtype))
        return from_pencil(out, ps) * valid[:, None]


class PencilResidualBlock(ResidualBlock):
    """:class:`ResidualBlock` on the pencil layout (the same parameters):
    its BatchNorms run over the level's cells, masked to the active ones."""

    def forward(self, core, ps, flat_mask):
        cap1 = core.shape[0]
        cells = ps.cell_active.shape[1]
        cin = core.shape[1] // cells
        identity = core if self.shortcut is None else (
            core.reshape(-1, cin) @ self.shortcut).reshape(cap1, -1)
        dtype = _conv_dtype(self.SubMConv_0.conv_dtype)

        def bn_relu(x, bn):
            flat = x.reshape(-1, x.shape[1] // cells)
            return torch.relu(bn(flat, flat_mask)).reshape(cap1, -1)

        x = bn_relu(core, self.MaskedBatchNorm_0)
        x = pencil_conv_apply(x, self.SubMConv_0.kernel, ps, dtype)
        x = bn_relu(x, self.MaskedBatchNorm_1)
        x = pencil_conv_apply(x, self.SubMConv_1.kernel, ps, dtype)
        return x + identity


class BrickSubMConv(SubMConv):
    """A submanifold conv on the brick engine, flat rows in and out (the
    input conv)."""

    def __init__(self, in_channels, out_channels, conv_dtype="float32",
                 impl="conv"):
        super().__init__(in_channels, out_channels, 3, conv_dtype)
        self.impl = impl

    def forward(self, feats, bs, active, valid):
        dense = to_dense(feats * valid[:, None], bs)
        out = brick_subm_conv(dense, self.kernel, bs, active, self.impl,
                              _conv_dtype(self.conv_dtype))
        return from_dense(out, bs) * valid[:, None]


class BrickResidualBlock(nn.Module):
    """:class:`ResidualBlock` on the dense-brick layout (the JAX package's
    names: ``shortcut``, ``bn0``, ``conv0``, ``bn1``, ``conv1``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 conv_dtype: str = "float32", impl: str = "conv"):
        super().__init__()
        self.conv_dtype = conv_dtype
        self.impl = impl
        self.shortcut = (nn.Parameter(torch.empty(in_channels, out_channels))
                         if in_channels != out_channels else None)
        self.bn0 = MaskedBatchNorm(in_channels)
        self.conv0 = nn.Parameter(torch.empty(27, in_channels, out_channels))
        self.bn1 = MaskedBatchNorm(out_channels)
        self.conv1 = nn.Parameter(torch.empty(27, out_channels, out_channels))

    def forward(self, dense, bs, active, flat_mask):
        shape = dense.shape
        identity = dense if self.shortcut is None else (
            dense.reshape(-1, shape[-1]) @ self.shortcut).reshape(
                *shape[:-1], -1)
        dtype = _conv_dtype(self.conv_dtype)

        def bn_relu(x, bn):
            flat = bn(x.reshape(-1, x.shape[-1]), flat_mask)
            return torch.relu(flat).reshape(x.shape) * active

        x = bn_relu(dense, self.bn0)
        x = brick_subm_conv(x, self.conv0, bs, active, self.impl, dtype)
        x = bn_relu(x, self.bn1)
        x = brick_subm_conv(x, self.conv1, bs, active, self.impl, dtype)
        return x + identity


def brick_context(coords, valid, divisor: int):
    """The brick engine's structure of one level: ``(bs, active,
    flat_mask)`` with bricks capped at ``max(M // divisor, 64)``, and the
    voxels the cap dropped."""
    cap = max(coords.shape[0] // divisor, 64)
    bs = brickize(coords, valid, cap)
    active = to_dense(valid.float()[:, None], bs)
    dropped = (valid & (bs.brick_id >= cap)).sum()
    return (bs, active, (active > 0).reshape(-1)), dropped


def pencil_capacity(m: int, divisor: int) -> int:
    """Pencil rows of a level of ``m`` voxels: ``max(3m // divisor, 64)``
    (reals and ghosts)."""
    return max(3 * m // divisor, 64)


class UBlock(nn.Module):
    """Recursive U-Net over voxel levels (reference blocks.py:83-151).

    ``level_shrink`` divides the capacity of each coarser level (real
    clouds coarsen >= 2x per stride-2 level); voxels beyond it, and beyond
    the pencil or brick caps, are dropped and counted in the returned
    ``dropped``."""

    def __init__(self, n_planes, block_reps: int = 2, kernel_size: int = 3,
                 level_shrink: int = 2, min_capacity: int = 256,
                 engine: str = "gather", conv_dtype: str = "float32",
                 brick_divisor: int = 4, pencil_divisor: int = 1,
                 pencil_cells: int = 4, brick_impl: str = "conv"):
        super().__init__()
        self.n_planes = list(n_planes)
        self.block_reps = block_reps
        self.kernel_size = kernel_size
        self.level_shrink = level_shrink
        self.min_capacity = min_capacity
        self.engine = engine
        self.conv_dtype = conv_dtype
        self.brick_divisor = brick_divisor
        self.pencil_divisor = pencil_divisor
        self.pencil_cells = pencil_cells
        layout = engine if kernel_size == 3 else "gather"

        def block(cin, cout):
            if layout == "brick":
                return BrickResidualBlock(cin, cout, conv_dtype, brick_impl)
            cls = PencilResidualBlock if layout == "pencil" else ResidualBlock
            return cls(cin, cout, kernel_size, conv_dtype)

        c0 = self.n_planes[0]
        for i in range(block_reps):
            self.add_module(f"block{i}", block(c0, c0))
        if len(self.n_planes) > 1:
            c1 = self.n_planes[1]
            self.MaskedBatchNorm_0 = MaskedBatchNorm(c0)
            self.down_kernel = nn.Parameter(torch.empty(8, c0, c1))
            self.u = UBlock(
                self.n_planes[1:], block_reps, kernel_size, level_shrink,
                min_capacity, engine, conv_dtype, brick_divisor,
                pencil_divisor, pencil_cells, brick_impl,
            )
            self.MaskedBatchNorm_1 = MaskedBatchNorm(c1)
            self.up_kernel = nn.Parameter(torch.empty(8, c1, c0))
            for i in range(block_reps):
                self.add_module(f"tail{i}",
                                block(2 * c0 if i == 0 else c0, c0))

    def _make_ctx(self, coords, valid):
        """Per-level conv context shared by head and tail blocks (the
        reference's ``indice_key``) and the voxels the engine's cap
        dropped: ``("pencil", structure, flat_mask)``, ``("brick", bricks,
        active, flat_mask)``, or ``("gather", rulebook)`` where the
        rulebook may be a ``ZPlan`` or a band plan (sized for the level's
        widest conv, the tail's first, 2C -> C after the skip concat)."""
        zero = torch.zeros((), dtype=torch.int64, device=coords.device)
        k3 = self.kernel_size == 3
        if self.engine == "pencil" and k3:
            ps = build_pencils(
                coords, valid, pencil_capacity(coords.shape[0],
                                               self.pencil_divisor),
                cells=self.pencil_cells)
            return ("pencil", ps, ps.cell_active.reshape(-1) > 0), ps.overflow
        if self.engine == "brick" and k3:
            ctx, dropped = brick_context(coords, valid, self.brick_divisor)
            return ("brick", *ctx), dropped
        if self.engine == "zpack" and k3:
            return ("gather", build_zplan(coords, valid, 3)), zero
        rb = build_rulebook(coords, valid, self.kernel_size)
        if self.engine == "band":
            c0 = self.n_planes[0]
            rb = choose_band_plan(rb, valid, 2 * c0, c0,
                                  _conv_dtype(self.conv_dtype))
        return ("gather", rb), zero

    def _run_blocks(self, x, ctx, valid, prefix: str):
        blocks = [getattr(self, f"{prefix}{i}")
                  for i in range(self.block_reps)]
        if ctx[0] == "pencil":
            _, ps, flat_mask = ctx
            core = to_pencil(x * valid[:, None], ps)
            for blk in blocks:
                core = blk(core, ps, flat_mask)
            return from_pencil(core, ps) * valid[:, None]
        if ctx[0] == "brick":
            _, bs, active, flat_mask = ctx
            dense = to_dense(x * valid[:, None], bs)
            for blk in blocks:
                dense = blk(dense, bs, active, flat_mask)
            return from_dense(dense, bs) * valid[:, None]
        for blk in blocks:
            x = blk(x, ctx[1], valid)
        return x

    def forward(self, feats, coords, valid):
        """Returns (features, dropped) — ``dropped`` totals the voxels
        lost to level and engine caps across this and all coarser
        levels."""
        ctx, dropped = self._make_ctx(coords, valid)
        x = self._run_blocks(feats, ctx, valid, "block")
        if len(self.n_planes) > 1:
            identity = x
            d = torch.relu(self.MaskedBatchNorm_0(x, valid))
            m = coords.shape[0]
            cap = min(max(m // self.level_shrink, self.min_capacity), m)
            ds = build_downsample(coords, valid, cap)
            dtype = _conv_dtype(self.conv_dtype)
            d = down_conv_apply(d, self.down_kernel, ds, valid,
                                compute_dtype=dtype)
            dropped = dropped + (valid & (ds.parent >= cap)).sum()
            d, d_dropped = self.u(d, ds.coarse_coords, ds.coarse_valid)
            dropped = dropped + d_dropped
            u = torch.relu(self.MaskedBatchNorm_1(d, ds.coarse_valid))
            u = inverse_conv_apply(u, self.up_kernel, ds, valid,
                                   compute_dtype=dtype)
            x = torch.cat([identity, u], dim=-1)
            x = self._run_blocks(x, ctx, valid, "tail")
        return x, dropped


class MLPHead(nn.Module):
    """Linear/BN/ReLU head with a small-variance final layer
    (reference TreeLearn/blocks.py:10-28)."""

    def __init__(self, channels: int, out_channels: int,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers - 1):
            self.add_module(f"Dense_{i}", nn.Linear(channels, channels))
            self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(channels))
        self.add_module(
            f"Dense_{num_layers - 1}", nn.Linear(channels, out_channels)
        )

    def reset_parameters(self, generator=None) -> None:
        """flax's inits: Xavier-uniform hidden layers, N(0, 0.01) final
        layer, zero biases; BN scale 1, bias 0, statistics (0, 1)."""
        last = self.num_layers - 1
        with torch.no_grad():
            for i in range(self.num_layers):
                lin = getattr(self, f"Dense_{i}")
                if i < last:
                    nn.init.xavier_uniform_(lin.weight, generator=generator)
                    getattr(self, f"MaskedBatchNorm_{i}").reset_parameters()
                else:
                    nn.init.normal_(lin.weight, std=0.01, generator=generator)
                lin.bias.zero_()

    def forward(self, x, mask):
        for i in range(self.num_layers - 1):
            x = getattr(self, f"Dense_{i}")(x)
            x = torch.relu(getattr(self, f"MaskedBatchNorm_{i}")(x, mask))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


class TreeLearnBackbone(nn.Module):
    """Voxelize -> sparse U-Net -> per-point features.

    The level-0 voxel capacity is ``voxel_capacity`` or
    ``max(P // voxel_capacity_divisor, 256)``; overflow voxels are dropped
    and their points masked (``dropped_points``)."""

    def __init__(self, channels=32, num_blocks=7, kernel_size=3,
                 use_feats=True, use_coords=False, voxel_size=0.1,
                 batch_size=1, voxel_capacity_divisor=1, engine="gather",
                 conv_dtype="float32", voxel_capacity=None, dim_feat=1,
                 brick_divisor=4, pencil_divisor=1, pencil_cells=4,
                 brick_impl="conv"):
        super().__init__()
        self.channels = channels
        self.kernel_size = kernel_size
        self.use_feats = use_feats
        self.use_coords = use_coords
        self.voxel_size = voxel_size
        self.batch_size = batch_size
        self.voxel_capacity_divisor = voxel_capacity_divisor
        self.engine = engine
        self.conv_dtype = conv_dtype
        self.voxel_capacity = voxel_capacity
        self.brick_divisor = brick_divisor
        self.pencil_divisor = pencil_divisor
        self.pencil_cells = pencil_cells
        layout = engine if kernel_size == 3 else "gather"
        if layout == "pencil":
            self.input_conv = PencilSubMConv(dim_feat + 3, channels, 3,
                                             conv_dtype)
        elif layout == "brick":
            self.input_conv = BrickSubMConv(dim_feat + 3, channels,
                                            conv_dtype, brick_impl)
        else:
            self.input_conv = SubMConv(dim_feat + 3, channels, kernel_size,
                                       conv_dtype)
        n_planes = [channels * (i + 1) for i in range(num_blocks)]
        self.unet = UBlock(n_planes, 2, kernel_size, engine=engine,
                           conv_dtype=conv_dtype,
                           brick_divisor=brick_divisor,
                           pencil_divisor=pencil_divisor,
                           pencil_cells=pencil_cells, brick_impl=brick_impl)
        self.output_norm = MaskedBatchNorm(channels)

    def _input_conv(self, feats, v_coords, v_valid):
        """The input conv on the level-0 voxels, on the model's engine."""
        if isinstance(self.input_conv, PencilSubMConv):
            ps = build_pencils(
                v_coords, v_valid,
                pencil_capacity(v_coords.shape[0], self.pencil_divisor),
                cells=self.pencil_cells)
            return self.input_conv(feats, ps, v_valid)
        if isinstance(self.input_conv, BrickSubMConv):
            (bs, active, _), _ = brick_context(v_coords, v_valid,
                                               self.brick_divisor)
            return self.input_conv(feats, bs, active, v_valid)
        if self.engine == "zpack" and self.kernel_size == 3:
            rulebook = build_zplan(v_coords, v_valid, 3)
        else:
            rulebook = build_rulebook(v_coords, v_valid, self.kernel_size)
        if self.engine == "band":
            rulebook = choose_band_plan(
                rulebook, v_valid, feats.shape[-1], self.channels,
                _conv_dtype(self.conv_dtype),
            )
        return self.input_conv(feats, rulebook, v_valid)

    def forward(self, coords, feats, batch_ids, valid):
        p = coords.shape[0]
        capacity = self.voxel_capacity or max(
            p // self.voxel_capacity_divisor, 256
        )
        vox = voxelize_treelearn_features(
            coords, feats, batch_ids, valid, self.voxel_size,
            self.batch_size, use_coords=self.use_coords,
            use_feats=self.use_feats, capacity=min(capacity, p),
        )
        v_coords, v_valid = vox.voxel_coords, vox.voxel_valid
        x = self._input_conv(vox.voxel_feats, v_coords, v_valid)
        x, dropped_voxels = self.unet(x, v_coords, v_valid)
        x = torch.relu(self.output_norm(x, v_valid))

        # voxel -> point unprojection (reference forward_head,
        # TreeLearn.py:132-144); p2v == capacity marks overflow points
        cap = vox.voxel_feats.shape[0]
        p2v = vox.point_to_voxel
        in_range = p2v < cap
        dropped_points = (valid & ~in_range).sum()
        point_feats = x[p2v.clamp(0, cap - 1)] * (valid & in_range)[:, None]
        return point_feats, vox, dropped_points, dropped_voxels


class TreeLearn(nn.Module):
    """Sparse U-Net backbone + per-point heads.

    Input is the flat voxel-model layout: (P,) concatenated clouds with
    batch ids and validity. Returns per-point predictions (padding rows
    zeroed). With a separate noise cloud, the semantic head reads a second
    backbone pass over it with shared weights (reference
    TreeLearn.py:98-105, 137-141). ``engine`` and its caps and schedule
    (``brick_divisor``, ``pencil_divisor``, ``pencil_cells``,
    ``brick_impl``) are those of the module docstring."""

    def __init__(self, channels=32, num_blocks=7, kernel_size=3, dim_feat=1,
                 use_feats=True, use_coords=False, voxel_size=0.1,
                 batch_size=1, voxel_capacity_divisor=1, engine="gather",
                 conv_dtype="float32", voxel_capacity=None, brick_divisor=4,
                 pencil_divisor=1, pencil_cells=4, brick_impl="conv"):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError(f"unknown TreeLearn engine {engine!r}; use one "
                             f"of {ENGINES}")
        if brick_impl not in BRICK_IMPLS:
            raise ValueError(f"unknown brick_impl {brick_impl!r}")
        self.config = dict(
            channels=channels, num_blocks=num_blocks,
            kernel_size=kernel_size, dim_feat=dim_feat, use_feats=use_feats,
            use_coords=use_coords, voxel_size=voxel_size,
            batch_size=batch_size,
            voxel_capacity_divisor=voxel_capacity_divisor, engine=engine,
            conv_dtype=conv_dtype, voxel_capacity=voxel_capacity,
            brick_divisor=brick_divisor, pencil_divisor=pencil_divisor,
            pencil_cells=pencil_cells, brick_impl=brick_impl,
        )
        self.backbone = TreeLearnBackbone(
            channels, num_blocks, kernel_size, use_feats, use_coords,
            voxel_size, batch_size, voxel_capacity_divisor, engine,
            conv_dtype, voxel_capacity, dim_feat, brick_divisor,
            pencil_divisor, pencil_cells, brick_impl,
        )
        self.semantic_head = MLPHead(channels, 2)
        self.offset_head = MLPHead(channels, 3)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: fan-in truncated normals for conv kernels
        and shortcuts, Xavier-uniform hidden Dense layers, N(0, 0.01) final
        Dense layers with zero bias; BN scale 1, bias 0, statistics (0, 1).
        """
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, MaskedBatchNorm):
                    mod.reset_parameters()
                elif isinstance(mod, SubMConv):
                    _fan_in_normal_(mod.kernel, generator)
                elif isinstance(mod, (ResidualBlock, BrickResidualBlock)):
                    if mod.shortcut is not None:
                        _fan_in_normal_(mod.shortcut, generator)
                    if isinstance(mod, BrickResidualBlock):
                        _fan_in_normal_(mod.conv0, generator)
                        _fan_in_normal_(mod.conv1, generator)
                elif isinstance(mod, UBlock) and len(mod.n_planes) > 1:
                    _fan_in_normal_(mod.down_kernel, generator)
                    _fan_in_normal_(mod.up_kernel, generator)
                elif isinstance(mod, MLPHead):
                    mod.reset_parameters(generator)
        return self

    def clone(self, **overrides) -> "TreeLearn":
        """A model with this one's configuration, ``overrides`` applied, and
        a copy of its weights (weights do not depend on capacities)."""
        cfg = dict(self.config, **overrides)
        model = TreeLearn(**cfg)
        model.load_state_dict(self.state_dict())
        ref = next(self.parameters())
        return model.to(ref.device).train(self.training)

    def forward(self, coords, feats, batch_ids, valid, noise_coords=None,
                noise_feats=None, noise_batch_ids=None, noise_valid=None):
        point_feats, vox, dropped_points, dropped_voxels = self.backbone(
            coords, feats, batch_ids, valid
        )
        if noise_coords is not None:
            noise_point_feats, _, n_dp, n_dv = self.backbone(
                noise_coords, noise_feats, noise_batch_ids, noise_valid
            )
            dropped_points = dropped_points + n_dp
            dropped_voxels = dropped_voxels + n_dv
            sem = self.semantic_head(noise_point_feats, noise_valid)
        else:
            sem = self.semantic_head(point_feats, valid)
        off = self.offset_head(point_feats, valid)
        return {
            "backbone_feats": point_feats,
            "semantic_prediction_logits": sem,
            "offset_predictions": off,
            "point_to_voxel": vox.point_to_voxel,
            "num_voxels": vox.num_voxels,
            # static-cap overflow diagnostics (both 0 in healthy configs):
            # points past the voxel capacity, and voxels dropped by level,
            # pencil and brick caps
            "dropped_points": dropped_points,
            "dropped_voxels": dropped_voxels,
        }


def treelearn_loss(
    output: dict,
    flat_batch: dict,
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    n_points: int | None = None,
    generator: torch.Generator | None = None,
    group=None,
):
    """Masked loss over the flat layout (reference TreeLearn.py:147-155):
    ``(loss, {"semantic_loss", "offset_loss"})``."""
    sem_loss, off_loss = point_wise_loss(
        output["semantic_prediction_logits"],
        output["offset_predictions"],
        flat_batch["semantic_labels"],
        flat_batch["offset_labels"],
        semantic_mask=flat_batch["mask_valid"],
        offset_mask=flat_batch["mask_valid"] & flat_batch["mask_off"],
        n_points=n_points,
        generator=generator,
        group=group,
    )
    loss_dict = {
        "semantic_loss": sem_loss * loss_multiplier_semantic,
        "offset_loss": off_loss * loss_multiplier_offset,
    }
    return sum(loss_dict.values()), loss_dict
