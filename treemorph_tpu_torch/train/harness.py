"""Training harness on one device: the JAX package's optax chain as a
global-norm clip and torch's AdamW, masked losses, per-epoch
train/validate loops.

Port of ``treemorph_tpu/train/harness.py`` (reference
``Modules/train_utils.py``): the x50 loss scaling at backward
(``train_utils.py:58``), global-norm gradient clipping at 1.0 (``:60``),
AdamW with decoupled weight decay, a per-epoch learning rate, early stopping
with best-checkpoint saves, and the same per-epoch history records.

The train state is the model itself (parameters and BatchNorm running
statistics, updated in place) with its optimizer and a step count.
Hierarchical raster training accumulates the gradients of a group of
minibatches into one optimizer step (:func:`make_accum_steps`).

Data parallelism (the JAX package's ``mesh`` path, harness.py:128-139):
with a :class:`~treemorph_tpu_torch.parallel.Mesh` each rank is a process
that holds its own rows of the batch and differentiates only them, with
per-rank BatchNorm statistics (torch DDP's default, not SyncBN). The family
is built with ``group=mesh``, so its loss is the global masked mean and its
gradient this rank's share of the global loss's; the gradients are summed
over the ranks once a step (once a minibatch under accumulation, as in
JAX), the BN running statistics averaged after the update, and every rank
takes the same optimizer step. Each rank's generator is derived from the
step's and the rank (the JAX step's ``fold_in(rng, axis_index)``). The
JAX mesh step differentiates through its ``psum`` and so gets the world
size times the global loss's gradient; the port's is the gradient its
docstrings promise, and the global-norm clip makes the two steps equal
where it bites.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ..parallel.mesh import (
    all_reduce_grads,
    average_buffers,
    broadcast_flag,
    pad_batch_to_multiple,
    rank_generator,
    replicate,
    shard_batch,
)

logger = logging.getLogger("treemorph_tpu_torch.train")

LOSS_BACKWARD_SCALE = 50.0  # reference train_utils.py:58
GRAD_CLIP_NORM = 1.0  # reference train_utils.py:60
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam


@torch.no_grad()
def optimizer_step(optimizer: torch.optim.AdamW, lr: float) -> None:
    """One update of the JAX harness's ``optax.chain(clip_by_global_norm(1.0),
    scale_by_adam(), add_decayed_weights(wd), scale(-1))`` followed by
    ``x lr``: the gradients of ``optimizer``'s parameters are scaled by
    ``min(1, max_norm / |g|)`` (optax's formula; ``clip_grad_norm_`` would
    add 1e-6 to ``|g|``), then AdamW takes its step at ``lr``. A parameter
    without a gradient counts as a zero gradient."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(GRAD_CLIP_NORM / norm, max=1.0))
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.step()


@dataclass
class TrainState:
    """What a train step updates: the model (parameters and BN running
    statistics, in place), its optimizer and the step count."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    step: int = 0


def _is_fixed(name: str, fixed_modules: tuple) -> bool:
    return name.split(".")[0] in fixed_modules


def make_optimizer(
    model: nn.Module,
    weight_decay: float = 1e-3,
    fixed_modules: tuple = (),
) -> torch.optim.AdamW:
    """AdamW with optax's defaults and decoupled weight decay over
    ``model``'s parameters; :func:`optimizer_step` clips and applies it.

    ``fixed_modules`` freezes the named top-level submodules for transfer
    learning (the reference's ``fixed_modules``,
    ``Modules/TreeLearn/TreeLearn.py:65-87``): their parameters stay out of
    the optimizer, so they take no update and no weight decay and stay out
    of the global-norm clip."""
    fixed = tuple(fixed_modules)
    params = [p for n, p in model.named_parameters()
              if not _is_fixed(n, fixed)]
    return torch.optim.AdamW(
        params, lr=0.0, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
        weight_decay=weight_decay, fused=True,
    )


def make_train_step(
    forward_fn: Callable,
    loss_fn: Callable,
    fixed_modules: tuple = (),
    mesh=None,
):
    """The train step ``(state, batch, lr, generator=None) -> (state,
    metrics)``; ``generator`` is the step's own (:func:`run_training`
    derives one per step from the run's seed).

    forward_fn(model, batch, train, generator) -> output dict
    loss_fn(output, batch) -> (loss, loss_dict)

    ``fixed_modules`` (pair it with the same argument of
    :func:`make_optimizer`) keeps the named top-level submodules' BN running
    statistics as they were (the reference forces fixed modules' BN to eval
    mode, TreeLearn.py:79-87); the forward still normalizes with batch
    statistics, as in the JAX package.

    With ``mesh`` (build the family with ``group=mesh``) ``batch`` is this
    rank's shard (:func:`~treemorph_tpu_torch.parallel.shard_batch`):
    the step differentiates it with this rank's generator, sums the
    gradients over the ranks, averages the BN running statistics (but the
    fixed modules') and steps; the metrics are the global masked means."""
    accumulate = _make_backward(forward_fn, loss_fn, fixed_modules)

    def train_step(state: TrainState, batch, lr: float, generator=None):
        state.model.zero_grad(set_to_none=True)
        if mesh is None:
            metrics = accumulate(state.model, batch, generator)
        else:
            metrics = accumulate(state.model, batch,
                                 rank_generator(generator, mesh))
            _reduce_step(state.model, mesh, fixed_modules)
        optimizer_step(state.optimizer, lr)
        state.step += 1
        return state, metrics

    return train_step


def _reduce_step(model: nn.Module, mesh, fixed_modules: tuple) -> None:
    """The data-parallel step's reductions: gradients summed over the
    ranks, floating buffers averaged but the fixed modules'."""
    all_reduce_grads(model, mesh)
    average_buffers(model, mesh,
                    keep=lambda name: _is_fixed(name, tuple(fixed_modules)))


def _make_backward(forward_fn: Callable, loss_fn: Callable,
                   fixed_modules: tuple):
    """``(model, batch, generator) -> metrics``: the train-mode forward,
    the loss and the backward of ``loss x 50``, which adds into each
    parameter's ``.grad``; the ``fixed_modules``' BN running statistics
    are put back as they were."""
    fixed = tuple(fixed_modules)

    def backward(model: nn.Module, batch, generator):
        model.train()
        pinned = {
            name: buf.clone() for name, buf in model.named_buffers()
            if _is_fixed(name, fixed)
        }
        out = forward_fn(model, batch, True, generator)
        loss, loss_dict = loss_fn(out, batch)
        (loss * LOSS_BACKWARD_SCALE).backward()
        with torch.no_grad():
            for name, value in pinned.items():
                model.get_buffer(name).copy_(value)
        metrics = {"loss": loss, **loss_dict}
        return {k: v.detach() for k, v in metrics.items()}

    return backward


def make_accum_steps(
    forward_fn: Callable,
    loss_fn: Callable,
    fixed_modules: tuple = (),
    mesh=None,
):
    """The gradient-accumulation step pair of hierarchical raster training
    (the JAX package's ``make_accum_steps``; the reference's one optimizer
    step per tree batch, ``train_utils.py:46-62``, ``PointNet2.py:296``).
    Returns ``(accum_step, apply_step)``:

    - ``accum_step(state, batch, generator=None) -> (state, metrics)``:
      forward and backward of one minibatch, its ``loss x 50`` gradient
      added into ``.grad`` (torch's own accumulation); BN running
      statistics update per minibatch, the ``fixed_modules``' stay pinned.
      Start a group with ``state.model.zero_grad(set_to_none=True)``.
    - ``apply_step(state, lr) -> state``: one :func:`optimizer_step` on the
      accumulated gradient (the global-norm clip sees the sum), then the
      gradients are cleared.

    :func:`run_training` drives the pair over groups of minibatches.

    With ``mesh`` ``accum_step`` works on this rank's shard as
    :func:`make_train_step` does: each minibatch's gradient is summed over
    the ranks before it is added to the accumulator (the JAX step's psum
    per minibatch), and the BN running statistics are averaged per
    minibatch; ``apply_step`` is the same on every rank."""
    accumulate = _make_backward(forward_fn, loss_fn, fixed_modules)

    def accum_step(state: TrainState, batch, generator=None):
        if mesh is None:
            return state, accumulate(state.model, batch, generator)
        params = list(state.model.parameters())
        held = [p.grad for p in params]
        for p in params:
            p.grad = None
        metrics = accumulate(state.model, batch,
                             rank_generator(generator, mesh))
        _reduce_step(state.model, mesh, fixed_modules)
        with torch.no_grad():
            for p, g in zip(params, held):
                if g is not None:
                    p.grad.add_(g)
        return state, metrics

    def apply_step(state: TrainState, lr: float):
        optimizer_step(state.optimizer, lr)
        state.model.zero_grad(set_to_none=True)
        state.step += 1
        return state

    return accum_step, apply_step


def make_eval_step(forward_fn: Callable, loss_fn: Callable, mesh=None):
    """The eval step ``(state, batch) -> metrics``: BN uses the running
    statistics, no gradients. With ``mesh`` (the family built with
    ``group=mesh``) ``batch`` is this rank's shard and the metrics are the
    global masked means, the same on every rank."""

    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        with torch.no_grad():
            out = forward_fn(model, batch, False)
            loss, loss_dict = loss_fn(out, batch)
        return {"loss": loss, **loss_dict}

    return eval_step


def to_device(batch, device):
    """A :class:`~treemorph_tpu_torch.data.PaddedBatch` of numpy arrays as
    tensors on ``device``."""
    return batch.map(lambda a: torch.as_tensor(a).to(device))


def run_training(
    state: TrainState,
    train_step,
    eval_step,
    train_batches: Callable,  # epoch -> iterator of PaddedBatch
    val_batches: Callable,  # epoch -> iterator of PaddedBatch
    epochs: int,
    lr_schedule: Callable,  # epoch -> float
    early_stopper=None,
    mesh=None,
    verbose: bool = False,
    accum_steps: Optional[tuple] = None,
    seed: int = 0,
):
    """Epoch loop with per-epoch validation, logging and early stopping
    (reference ``run_training``, train_utils.py:130-197). Each batch moves
    to the model's device once; each train step gets a generator of its
    own, seeded in turn from one seeded by ``seed`` (the JAX harness splits
    its key once per step). Returns ``(state, history)``.

    With ``accum_steps=(accum_step, apply_step)`` (:func:`make_accum_steps`)
    ``train_batches(epoch)`` yields groups, iterables of minibatches: each
    minibatch gets its own generator and adds its gradient, and each group
    that held a minibatch takes one optimizer step; ``train_step`` is then
    unused.

    With ``mesh`` (a :class:`~treemorph_tpu_torch.parallel.Mesh`, the steps
    built with it) every rank iterates the same global batches: each is
    padded to a multiple of the world size with all-invalid elements and
    this rank's rows go to its device; the state is broadcast from rank 0
    once. Every rank draws the same step generators. The early-stopping
    decision is rank 0's on every rank; only rank 0 logs (the caller's
    ``early_stopper`` should save only there)."""
    device = next(state.model.parameters()).device
    main = mesh is None or mesh.rank == 0
    if mesh is not None:
        replicate(state, mesh)

    def prepare(batch):
        if mesh is None:
            return to_device(batch, device)
        return shard_batch(pad_batch_to_multiple(batch, mesh.size), mesh)

    run_generator = torch.Generator().manual_seed(seed)

    def step_generator():
        step_seed = torch.randint(0, 2**62, (), generator=run_generator)
        return torch.Generator().manual_seed(int(step_seed))

    history = []
    for epoch in range(epochs):
        lr = float(lr_schedule(epoch))
        t0 = time.time()
        train_metrics = []
        if accum_steps is not None:
            accum_step, apply_step = accum_steps
            for group in train_batches(epoch):
                state.model.zero_grad(set_to_none=True)
                n_minibatches = 0
                for batch in group:
                    state, metrics = accum_step(state, prepare(batch),
                                                step_generator())
                    train_metrics.append(metrics)
                    n_minibatches += 1
                if n_minibatches:
                    state = apply_step(state, lr)
        else:
            for batch in train_batches(epoch):
                state, metrics = train_step(state, prepare(batch), lr,
                                            step_generator())
                train_metrics.append(metrics)
        val_metrics = [eval_step(state, prepare(batch))
                       for batch in val_batches(epoch)]

        def mean_of(ms, key):
            if not ms:
                return float("nan")
            return float(torch.stack([m[key] for m in ms]).mean())

        record = {
            "epoch": epoch,
            "lr": lr,
            "time": time.time() - t0,
            "train_loss": mean_of(train_metrics, "loss"),
            "train_offset_loss": mean_of(train_metrics, "offset_loss"),
            "train_semantic_loss": mean_of(train_metrics, "semantic_loss"),
            "val_loss": mean_of(val_metrics, "loss"),
            "val_offset_loss": mean_of(val_metrics, "offset_loss"),
            "val_semantic_loss": mean_of(val_metrics, "semantic_loss"),
        }
        history.append(record)
        if main:
            logger.info(
                "Epoch %d/%d | Train: %.4f Val: %.4f | Off: %.4f/%.4f | "
                "Sem: %.4f/%.4f | %.1fs",
                epoch + 1, epochs, record["train_loss"], record["val_loss"],
                record["train_offset_loss"], record["val_offset_loss"],
                record["train_semantic_loss"], record["val_semantic_loss"],
                record["time"],
            )
        if verbose and main:
            print(
                f"Epoch {epoch + 1}/{epochs}  "
                f"train {record['train_loss']:.4f}  "
                f"val {record['val_loss']:.4f}"
            )

        if early_stopper is not None:
            early_stopper(state, record["train_loss"], record["val_loss"])
            stop = early_stopper.early_stop
            if mesh is not None:
                stop = early_stopper.early_stop = broadcast_flag(stop, mesh)
            if stop:
                if main:
                    logger.info("Early stopping at epoch %d", epoch + 1)
                break

    return state, history
