"""Precision of the reference's convs, and the controls: the reference
computed one precision below the one the configuration states.

A :class:`Precision` rounds a conv's operands (features and weights) on
the way in and its output's gradient on the way back, so that the
forward product and both backward products (feature and weight gradient)
take rounded operands, as a conv computed in that type does. ``EXACT``
rounds nothing.

Controls: ``float8_e4m3`` (below a bfloat16 configuration) rounds with
:func:`fp8`; ``tf32`` (below a float32 configuration whose matmuls run with
TF32 off) rounds nothing and lets the reference's float32 matmuls run in
TF32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after its largest magnitude is scaled
    to the type's largest finite value (448), as a per-tensor-scaled fp8
    matmul feeds its operands, and scaled back."""
    scale = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad)


class Precision:
    """``operand(x)`` rounds a conv input on the way in (its gradient
    passes through); ``output(y)`` leaves a conv output and rounds the
    gradient that comes back to it."""

    def __init__(self, operand=None, output=None):
        self.operand = operand or (lambda x: x)
        self.output = output or (lambda y: y)


EXACT = Precision()
FP8 = Precision(_RoundForward.apply, _RoundBackward.apply)

#: control name -> (conv precision, TF32 allowed)
CONTROLS = {"float8_e4m3": (FP8, False), "tf32": (EXACT, True)}
