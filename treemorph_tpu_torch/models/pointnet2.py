"""PointNet++ (PointNet2) with offset and semantic heads.

Port of ``treemorph_tpu/models/pointnet2.py`` (reference
``Modules/PointNet2/PointNet2.py``, ``blocks.py``): set-abstraction (SA)
and feature-propagation (FP) stacks at depths 2-6 (depth 6 groups its first
level at three scales), a 2-class semantic head and a 3-vector offset head,
with the same widths, radii and group sizes. Batches are padded (B, N, ...)
tensors with a validity mask threaded through sampling, grouping and
interpolation (:mod:`..ops.sampling`). The grouped-point MLPs are Linear
layers over the trailing channel axis. Everything is float32, as in the
reference, which runs this backbone without AMP.

Modules carry the flax names (``SetAbstraction_0``, ``SetAbstractionMsg_0``,
``PointwiseMLP_i``, ``Dense_i``, ``BatchNorm_i``, ``FeaturePropagation_j``,
``semantic_head``, ``offset_head``), so
:func:`~treemorph_tpu_torch.models.convert.flax_to_state_dict` carries the
JAX package's variables across unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.sampling import (
    bucketed_farthest_point_sample,
    fps_score_shape,
    index_points,
    query_ball_point,
    three_nn_interpolate,
)
from .loss import point_wise_loss

#: per depth, each SA level's (npoint, radius, nsample, MLP widths); depth
#: 6's first level has a radius, a group size and widths per scale
#: (reference PointNet2.py:38-100)
SA_CONFIGS: dict[int, list] = {
    2: [
        (1024, 0.02, 32, (32, 32, 64)),
        (256, 0.2, 32, (64, 64, 128)),
    ],
    3: [
        (1024, 0.1, 32, (32, 32, 64)),
        (256, 0.3, 32, (64, 64, 128)),
        (64, 0.6, 32, (128, 128, 256)),
    ],
    4: [
        (1024, 0.1, 32, (32, 32, 64)),
        (256, 0.2, 32, (64, 64, 128)),
        (64, 0.4, 32, (128, 128, 256)),
        (16, 0.8, 32, (256, 256, 512)),
    ],
    5: [
        (100, 0.1, 32, (32, 32, 64)),
        (50, 0.2, 32, (64, 64, 128)),
        (20, 0.4, 32, (128, 128, 256)),
        (8, 0.8, 32, (256, 256, 512)),
    ],
    6: [
        (
            500,
            (0.02, 0.04, 0.08),
            (16, 32, 32),
            ((16, 16, 32), (32, 32, 64), (64, 64, 64)),
        ),
        (100, 0.2, 32, (64, 64, 128)),
        (50, 0.4, 32, (128, 128, 256)),
        (20, 0.8, 32, (256, 256, 512)),
    ],
}

#: FP widths, coarsest to finest; the last gives the 128-channel backbone
#: features (reference PointNet2.py:45-97)
FP_CONFIGS: dict[int, list] = {
    2: [(128, 128, 128), (128, 128, 128)],
    3: [(256, 256), (256, 128), (128, 128, 128)],
    4: [(256, 256), (256, 256), (256, 128), (128, 128, 128)],
    5: [(256, 256), (256, 256), (256, 128), (128, 128, 128)],
    6: [(256, 256), (256, 256), (256, 128), (128, 128, 128)],
}

BN_EPS = 1e-5  # the MLPs' BatchNorm (torch's default)
HEAD_BN_EPS = 1e-4  # the heads' norm_fn (reference PointNet2.py:22)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the trailing channel axis: in training,
    the batch's mean and biased variance over every other axis (padding
    included, as in the JAX package), ``E[x^2] - E[x]^2`` clipped at 0,
    and running statistics updated with momentum 0.9 (new = 0.9 old + 0.1
    batch); in eval, the running statistics."""

    def __init__(self, channels: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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

    def forward(self, x):
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = (flat.square().mean(dim=0) - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class PointwiseMLP(nn.Module):
    """Dense -> BatchNorm -> ReLU stack over the trailing channel axis."""

    def __init__(self, in_channels: int, widths: Sequence[int],
                 eps: float = BN_EPS):
        super().__init__()
        self.n_layers = len(widths)
        for i, width in enumerate(widths):
            self.add_module(f"Dense_{i}", nn.Linear(in_channels, width))
            self.add_module(f"BatchNorm_{i}", BatchNorm(width, eps))
            in_channels = width

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class Head(nn.Module):
    """Per-point prediction head (reference ConvHead, blocks.py:7-35): a
    hidden Dense -> BatchNorm (eps 1e-4) -> ReLU, then the output Dense."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels)
        self.BatchNorm_0 = BatchNorm(channels, HEAD_BN_EPS)
        self.Dense_1 = nn.Linear(channels, out_channels)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.BatchNorm_0(self.Dense_0(x))))


def _group(xyz, feats, valid, new_xyz, radius, nsample):
    """(B, S, K, 3 + C) ball groups: relative xyz, then point features."""
    idx = query_ball_point(radius, nsample, xyz, new_xyz, valid)
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, index_points(feats, idx)], dim=-1)
    return grouped


def draw_fps_scores(generator: torch.Generator, level: int, shape: tuple,
                    device) -> torch.Tensor:
    """The uniform draw whose largest score over the valid points is SA
    level ``level``'s first FPS centroid (the JAX model draws
    ``jax.random.uniform`` from its level's split of ``fps_rng``); drawn
    from ``generator`` on the generator's device, level after level."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _sample(xyz, valid, npoint, generator, buckets, level):
    scores = None
    if generator is not None:
        shape = fps_score_shape(xyz.shape[0], xyz.shape[1], npoint, buckets)
        scores = draw_fps_scores(generator, level, shape, xyz.device)
    fps_idx = bucketed_farthest_point_sample(xyz, valid, npoint,
                                             buckets=buckets, scores=scores)
    return index_points(xyz, fps_idx), valid.gather(1, fps_idx)


class SetAbstraction(nn.Module):
    def __init__(self, npoint, radius, nsample, in_channels, mlp,
                 fps_buckets=1, level=0):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.fps_buckets, self.level = fps_buckets, level
        self.PointwiseMLP_0 = PointwiseMLP(in_channels, mlp)

    def forward(self, xyz, feats, valid, generator=None):
        new_xyz, new_valid = _sample(xyz, valid, self.npoint, generator,
                                     self.fps_buckets, self.level)
        grouped = _group(xyz, feats, valid, new_xyz, self.radius,
                         self.nsample)
        x = self.PointwiseMLP_0(grouped)  # (B, S, K, C)
        return new_xyz, x.amax(dim=2), new_valid


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA (reference blocks.py:103-160): one FPS,
    then a ball group and an MLP per scale, concatenated."""

    def __init__(self, npoint, radius_list, nsample_list, in_channels,
                 mlp_list, fps_buckets=1, level=0):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = radius_list, nsample_list
        self.fps_buckets, self.level = fps_buckets, level
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"PointwiseMLP_{i}",
                            PointwiseMLP(in_channels, mlp))

    def forward(self, xyz, feats, valid, generator=None):
        new_xyz, new_valid = _sample(xyz, valid, self.npoint, generator,
                                     self.fps_buckets, self.level)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                  self.nsample_list)):
            grouped = _group(xyz, feats, valid, new_xyz, radius, nsample)
            outs.append(getattr(self, f"PointwiseMLP_{i}")(grouped)
                        .amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), new_valid


class FeaturePropagation(nn.Module):
    def __init__(self, in_channels, mlp):
        super().__init__()
        self.PointwiseMLP_0 = PointwiseMLP(in_channels, mlp)

    def forward(self, xyz_to, xyz_from, feats_to, feats_from, valid_from):
        interp = three_nn_interpolate(xyz_to, xyz_from, feats_from,
                                      valid_from)
        if feats_to is not None:
            interp = torch.cat([feats_to, interp], dim=-1)
        return self.PointwiseMLP_0(interp)


def _width(mlp) -> int:
    """Output channels of an SA level's MLP (summed over MSG scales)."""
    if isinstance(mlp[0], (tuple, list)):
        return sum(m[-1] for m in mlp)
    return mlp[-1]


class PointNet2(nn.Module):
    """PointNet++ backbone and heads. Call with a padded batch ``(coords
    (B, N, 3), feats (B, N, F), valid (B, N))``; returns ``backbone_feats``
    (B, N, 128), ``semantic_prediction_logits`` (B, N, 2) and
    ``offset_predictions`` (B, N, 3). ``fps_buckets`` 1 is the reference's
    exact FPS; more is the JAX package's blocked FPS. ``use_coords`` is
    kept as a configuration entry only, as in the JAX package. A
    ``generator`` (training) picks each SA level's first FPS centroid at
    random (:func:`draw_fps_scores`); without one it is the first valid
    point."""

    def __init__(self, depth: int = 4, dim_feat: int = 4,
                 use_coords: bool = True, use_features: bool = True,
                 fps_buckets: int = 1):
        super().__init__()
        if depth not in SA_CONFIGS:
            raise ValueError(f"unsupported PointNet2 depth {depth}")
        self.config = dict(depth=depth, dim_feat=dim_feat,
                           use_coords=use_coords, use_features=use_features,
                           fps_buckets=fps_buckets)
        self.depth, self.use_features = depth, use_features
        in_ch = dim_feat if use_features else 0
        widths = [in_ch]
        self.sa_names = []
        n_sa = n_msg = 0
        for level, (npoint, radius, nsample, mlp) in enumerate(
                SA_CONFIGS[depth]):
            if isinstance(radius, tuple):
                name, n_msg = f"SetAbstractionMsg_{n_msg}", n_msg + 1
                module = SetAbstractionMsg(npoint, radius, nsample,
                                           3 + widths[-1], mlp, fps_buckets,
                                           level)
            else:
                name, n_sa = f"SetAbstraction_{n_sa}", n_sa + 1
                module = SetAbstraction(npoint, radius, nsample,
                                        3 + widths[-1], mlp, fps_buckets,
                                        level)
            self.add_module(name, module)
            self.sa_names.append(name)
            widths.append(_width(mlp))
        n_levels = len(SA_CONFIGS[depth])
        up = widths[-1]
        for j, mlp in enumerate(FP_CONFIGS[depth]):
            level = n_levels - 1 - j
            skip = widths[level] if level > 0 else 0
            self.add_module(f"FeaturePropagation_{j}",
                            FeaturePropagation(skip + up, mlp))
            up = mlp[-1]
        self.semantic_head = Head(up, 2)
        self.offset_head = Head(up, 3)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: every Dense kernel lecun-normal (a normal
        truncated at two standard deviations, variance 1/fan_in), but each
        head's output Dense N(0, 0.01); zero biases; BatchNorm scale 1,
        bias 0, statistics (0, 1)."""
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, BatchNorm):
                    mod.reset_parameters()
                elif isinstance(mod, nn.Linear):
                    if name.endswith("head.Dense_1"):
                        nn.init.normal_(mod.weight, std=0.01,
                                        generator=generator)
                    else:
                        # flax's truncated normal keeps the variance: its
                        # std is scaled by 1/0.8796 (the std of N(0, 1)
                        # truncated at +-2)
                        std = math.sqrt(1.0 / mod.in_features) / \
                            0.87962566103423978
                        nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                              b=2 * std, generator=generator)
                    mod.bias.zero_()
        return self

    def forward(self, coords, feats, valid, generator=None) -> dict:
        xyzs, valids = [coords.float()], [valid]
        featss = [feats.float() if self.use_features else None]
        for name in self.sa_names:
            new_xyz, new_feats, new_valid = getattr(self, name)(
                xyzs[-1], featss[-1], valids[-1], generator)
            xyzs.append(new_xyz)
            featss.append(new_feats)
            valids.append(new_valid)
        n_levels = len(self.sa_names)
        up = featss[-1]
        for j in range(len(FP_CONFIGS[self.depth])):
            level = n_levels - 1 - j  # target level; level 0 has no skip
            up = getattr(self, f"FeaturePropagation_{j}")(
                xyzs[level], xyzs[level + 1],
                featss[level] if level > 0 else None, up, valids[level + 1])
        return {
            "backbone_feats": up,
            "semantic_prediction_logits": self.semantic_head(up),
            "offset_predictions": self.offset_head(up),
        }


def pointnet2_loss(
    output: dict,
    batch,
    loss_multiplier_semantic: float = 1.0,
    loss_multiplier_offset: float = 1.0,
    n_points: int | None = None,
    generator: torch.Generator | None = None,
    group=None,
):
    """Masked loss over a padded batch (reference PointNet2.py:180-207):
    ``(total, {"semantic_loss", "offset_loss"})``."""
    sem_loss, off_loss = point_wise_loss(
        output["semantic_prediction_logits"],
        output["offset_predictions"],
        batch.semantic_labels,
        batch.offset_labels,
        semantic_mask=batch.mask_valid,
        offset_mask=batch.mask_valid & batch.mask_off,
        n_points=n_points,
        generator=generator,
        group=group,
    )
    loss_dict = {
        "semantic_loss": sem_loss * loss_multiplier_semantic,
        "offset_loss": off_loss * loss_multiplier_offset,
    }
    return sum(loss_dict.values()), loss_dict
