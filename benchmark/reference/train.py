"""Plain training steps and the comparison that decides a training cell's
``correct``.

A step is the reference's (``Modules/train_utils.py:43-62``): the loss
times 50 differentiated, the gradients clipped to a global norm of 1.0
(``min(1, 1 / |g|)``), then AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled
weight decay) written out. Float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

LOSS_SCALE = 50.0
CLIP_NORM = 1.0
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_float32(tf32: bool = False):
    """TF32 off (``tf32``: on) for matmuls and convolutions while the
    block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def train_steps(params: dict, trainable: list, batches, loss_of, lr: float,
                weight_decay: float, moments=None) -> dict:
    """Steps over ``batches`` from ``params``; ``loss_of(params, batch)``
    is the forward's loss. ``moments``: AdamW's state to start from,
    ``(exp_avg, exp_avg_sq, steps taken)`` by name (default: fresh).
    Returns each step's ``losses``, the first step's clipped gradients
    (``grads``) and the parameters after the last step (``params``), by
    name."""
    params = {n: p.detach().clone() for n, p in params.items()}
    if moments is None:
        moments = ({n: torch.zeros_like(params[n]) for n in trainable},
                   {n: torch.zeros_like(params[n]) for n in trainable}, 0)
    m = {n: moments[0][n].clone() for n in trainable}
    v = {n: moments[1][n].clone() for n in trainable}
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=moments[2] + 1):
        leaves = [params[n].requires_grad_(True) for n in trainable]
        loss = loss_of(params, batch)
        grads = torch.autograd.grad(loss * LOSS_SCALE, leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = min(1.0, CLIP_NORM / float(norm))
        grads = [g * scale for g in grads]
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {n: g for n, g in zip(trainable, grads)}
        with torch.no_grad():
            for n, g in zip(trainable, grads):
                p = params[n].requires_grad_(False)
                m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[n].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                p.mul_(1 - lr * weight_decay)
                denom = (v[n].sqrt() / math.sqrt(1 - BETA2**t)).add_(EPS)
                p.addcdiv_(m[n], denom, value=-lr / (1 - BETA1**t))
        for n in trainable:
            params[n] = params[n].detach()
    return {"losses": losses, "grads": first_grads, "params": params}


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def gaps(program: dict, reference: dict, start: dict) -> dict:
    """The numbers a training cell compares, program against reference
    after the same steps from the same ``start``:

    - ``loss``: the relative gap of the first step's loss (the later
      steps' losses follow Adam's first steps, which move each element by
      about the learning rate whatever its gradient's size, so round-off
      in small gradients moves them by more than the precision does);
    - ``grad``: the worst leaf's gap between the norms of the first
      step's clipped gradient, over the larger of that leaf's reference
      norm and the median leaf's;
    - ``update``: the same of each leaf's change over the steps;
    - ``grad_diff``: the worst leaf's norm of the difference of the first
      clipped gradients, over the same: rounding errors that do not bias a
      leaf cancel in its norm (``grad`` is blind to them) but not in the
      difference, so this is the number a lower precision fails;
    - ``loss_later``: the largest relative gap of the later steps' losses,
      read beside ``loss`` and compared by no limit.

    A leaf the program's optimizer holds no gradient for counts as a zero
    gradient.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (round-off under Adam moves them) are left out of ``grad`` and
    ``update``; ``left_out`` counts them."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in
                 zip(program["losses"], reference["losses"])]
    names = list(reference["grads"])
    grads = {n: program["grads"].get(n, torch.zeros_like(
        reference["grads"][n])) for n in names}
    g_ref = {n: norm(reference["grads"][n]) for n in names}
    g_med = float(np.median(list(g_ref.values())))
    kept = [n for n in names if g_ref[n] >= 1e-3 * g_med]
    g_gap = max(abs(norm(grads[n]) - g_ref[n]) / max(g_ref[n], g_med)
                for n in kept)
    g_diff = max(norm(grads[n] - reference["grads"][n])
                 / max(g_ref[n], g_med) for n in kept)
    d_ref = {n: norm(reference["params"][n] - start[n]) for n in kept}
    d_med = float(np.median(list(d_ref.values())))
    d_gap = max(abs(norm(program["params"][n] - start[n]) - d_ref[n])
                / max(d_ref[n], d_med) for n in kept)
    return {"loss": loss_gaps[0], "grad": g_gap, "update": d_gap,
            "grad_diff": g_diff, "loss_later": max(loss_gaps[1:], default=0.0),
            "left_out": len(names) - len(kept)}
