"""Shared point-wise loss.

Port of ``treemorph_tpu/models/loss.py`` (reference ``Modules/Loss.py:6-36``):

- semantic: cross-entropy summed over points / number of points (a mean),
  on 2-class logits;
- offset: mean over points of sqrt(clamp(sum((pred - label)^2), 1e-8)), an
  epsilon-clamped L2 distance.

The masks are weights in a masked mean over the static padded layout, which
equals the reference's boolean filtering. Under data parallelism (``group``)
each mean is taken over the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import count_collective

EPS = 1e-8


def point_wise_loss(
    semantic_logits: torch.Tensor,  # (..., 2) float
    offset_predictions: torch.Tensor,  # (..., 3) float
    semantic_labels: torch.Tensor,  # (...,) int
    offset_labels: torch.Tensor,  # (..., 3) float
    semantic_mask: torch.Tensor,  # (...,) bool: valid points
    offset_mask: torch.Tensor,  # (...,) bool: valid & near-surface points
    n_points: int | None = None,
    generator: torch.Generator | None = None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (semantic_loss, offset_loss) float32 scalars (float64 for
    float64 predictions).

    ``n_points``: a random subsample of the loss points (reference
    ``Loss.py:9-13``) as random mask thinning, drawn from ``generator``
    (required then).

    ``group``: the data-parallel :class:`~treemorph_tpu_torch.parallel.Mesh`
    (or a process group), ``None`` on one device. The four sums (numerator and denominator of each mean) go
    through one all-reduce, so the returned values are the global masked
    means over every rank's rows, as the JAX package's ``psum`` makes them.
    The gradient flows only through this rank's numerators, divided by the
    global denominators: summed over the ranks once, the gradients are
    those of the global loss. (Differentiating through the all-reduce, as
    the JAX mesh step does with ``psum``, would give the world size times
    that.)"""
    acc = torch.promote_types(semantic_logits.dtype, torch.float32)
    semantic_logits = semantic_logits.to(acc)
    offset_predictions = offset_predictions.to(acc)
    sem_w = semantic_mask.float().reshape(-1)
    off_w = offset_mask.float().reshape(-1)

    if n_points is not None:
        if generator is None:
            raise ValueError("n_points subsampling needs a generator")
        sem_w = _thin_mask(sem_w, n_points, generator)
        off_w = _thin_mask(off_w, n_points, generator)

    logits = semantic_logits.reshape(-1, semantic_logits.shape[-1])
    labels = semantic_labels.reshape(-1).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    ce = -log_probs.gather(1, labels[:, None])[:, 0]
    sem_num, sem_den = (ce * sem_w).sum(), sem_w.sum().to(acc)

    diff = offset_predictions.reshape(-1, 3) - offset_labels.reshape(-1, 3)
    distance = (diff * diff).sum(dim=-1).clamp(min=EPS).sqrt()
    off_num, off_den = (distance * off_w).sum(), off_w.sum().to(acc)

    if group is not None:
        sums = torch.stack([sem_num, sem_den, off_num, off_den]).detach()
        count_collective("all_reduce")
        dist.all_reduce(sums, group=getattr(group, "group", group))
        # the global sums as values, the local numerators' gradients
        sem_num = sem_num + (sums[0] - sem_num).detach()
        off_num = off_num + (sums[2] - off_num).detach()
        sem_den, off_den = sums[1], sums[3]
    semantic_loss = sem_num / sem_den.clamp(min=1.0)
    offset_loss = off_num / off_den.clamp(min=1.0)
    return semantic_loss, offset_loss


def _thin_mask(weights: torch.Tensor, n_points: int,
               generator: torch.Generator) -> torch.Tensor:
    """Keep at most ``n_points`` of the set weights, uniformly at random."""
    n = weights.shape[0]
    draws = torch.rand(n, generator=generator,
                       device=generator.device).to(weights.device)
    scores = torch.where(weights > 0, draws, torch.inf)
    threshold = torch.sort(scores).values[min(n_points, n) - 1]
    keep = (scores <= threshold) & (weights > 0)
    # only thin when more than n_points are set (parity with Loss.py:9)
    return torch.where(weights.sum() >= n_points, keep.to(weights.dtype),
                       weights)
