"""3^3 submanifold conv over halo'd bricks: a hand-written CUDA kernel.

Port of ``treemorph_tpu/ops/brick_conv.py``. The 6^3 halo'd brick
(:func:`.bricks._halo_pad`) flattens to 216 cells, f = x*36 + y*6 + z. For
an offset (dx, dy, dz) with flat delta D = dx*36 + dy*6 + dz, the conv is

    out[b, f] = sum_k h[b, (f + D_k) mod 216] @ W[k]

(the JAX kernel's ``roll(h, -D_k)``). For the 4^3 core cells no component
leaves [0, 6), so the flat arithmetic is exact there and the core is the
conv the brick engine needs. :func:`brick_conv_cells` computes it on the
core (``core_only``) or on all 216 cells, where the wraparound terms are
those of the roll: the backward runs the full variant on the core
cotangent embedded in the 216 cells, whose halo is zero, so the wrapped
terms vanish there.

On the card :func:`brick_conv_cells` launches ``csrc/brick_conv.cu`` (both
variants: an implicit GEMM on the TF32 tensor cores in three passes, which
writes zeros for a brick whose whole input is zero and skips its products);
on the CPU it takes its plain version, whose products on an all-zero brick
are exact zeros too. :class:`_BrickConvCore`
is the ``torch.autograd.Function`` of the JAX package's custom VJP:
``d_h`` is the full variant on the embedded cotangent with the
offset-flipped, channel-transposed kernel, ``d_w`` 27 slab products in
plain torch. Everything is float32. Weights are (27, Cin, Cout) in
kernel-offset order, the layout of every conv engine.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import flops
from .cuda import LAUNCHES, check_launch, load_library, stream_handle

SIDE = 6  # brick edge + halo
CELLS6 = SIDE**3  # 216

#: (dx, dy, dz) in kernel-offset order and each offset's flat cell delta
DIRS27 = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]
DELTAS = [dx * 36 + dy * 6 + dz for dx, dy, dz in DIRS27]


def core_cells(device=None) -> torch.Tensor:
    """(64,) flat indices of the 4^3 core cells in x, y, z order."""
    r = torch.arange(1, 5, device=device)
    return (r[:, None, None] * 36 + r[None, :, None] * 6
            + r[None, None, :]).reshape(-1)


def brick_conv_cells_plain(h: torch.Tensor, weights: torch.Tensor,
                           core_only: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`brick_conv_cells`: per offset, the
    shifted cells gathered and multiplied in f32."""
    cells = (core_cells(h.device) if core_only
             else torch.arange(CELLS6, device=h.device))
    out = torch.zeros((h.shape[0], cells.shape[0], weights.shape[-1]),
                      dtype=torch.float32, device=h.device)
    for k, delta in enumerate(DELTAS):
        out = out + h[:, (cells + delta) % CELLS6] @ weights[k]
    return out


def brick_conv_cells(h: torch.Tensor, weights: torch.Tensor,
                     core_only: bool = True) -> torch.Tensor:
    """``out[b, f] = sum_k h[b, (f + D_k) mod 216] @ W[k]`` for the 64 core
    cells (``core_only``) or all 216: (B, 216, Cin) f32 x (27, Cin, Cout)
    f32 -> (B, 64 | 216, Cout) f32.

    On a CUDA tensor this launches the kernel of ``csrc/brick_conv.cu`` or
    raises; a CPU tensor takes the plain version."""
    if flops.counting():
        # the bricks whose input is not all zero, as the kernel skips the
        # others (:mod:`..utils.flops`)
        live = (h != 0).flatten(1).any(dim=1).sum()
        flops.log_kernel_flops("brick_conv", live * (
            2 * (64 if core_only else CELLS6) * 27 * h.shape[-1]
            * weights.shape[-1]))
    if h.device.type == "cpu":
        return brick_conv_cells_plain(h, weights, core_only)
    if h.device.type != "cuda":
        raise ValueError(f"brick_conv_cells: unsupported device {h.device}")
    b, cells, cin = h.shape
    k, cin_w, cout = weights.shape
    if cells != CELLS6 or k != 27 or cin_w != cin or b < 1:
        raise ValueError(
            f"brick_conv_cells: shapes h {tuple(h.shape)}, weights "
            f"{tuple(weights.shape)}"
        )
    if h.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("brick_conv_cells: h and weights must be float32")
    if weights.device != h.device:
        raise ValueError("brick_conv_cells: tensors on different devices")
    if not (h.is_contiguous() and weights.is_contiguous()):
        raise ValueError("brick_conv_cells: tensors must be contiguous")

    lib = _library()
    out = torch.empty((b, 64 if core_only else CELLS6, cout),
                      dtype=torch.float32, device=h.device)
    # the split weights and the live-brick list
    workspace = torch.empty(lib.brick_conv_workspace_bytes(b, cin, cout),
                            dtype=torch.uint8, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.brick_conv_launch(
            h.data_ptr(), weights.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), b, cin, cout, int(core_only),
            stream_handle(h.device),
        )
    check_launch("brick_conv", rc)
    LAUNCHES["brick_conv"] += 1
    return out


def _library():
    lib = load_library("brick_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.brick_conv_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.brick_conv_launch.restype = ctypes.c_int
        lib.brick_conv_workspace_bytes.argtypes = [i, i, i]
        lib.brick_conv_workspace_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


class _BrickConvCore(torch.autograd.Function):
    """(B, 216, Cin) halo'd bricks -> (B, 64, Cout) core conv, with the
    JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, h, weights):
        ctx.save_for_backward(h, weights)
        return brick_conv_cells(h, weights, core_only=True)

    @staticmethod
    def backward(ctx, g):
        h, weights = ctx.saved_tensors
        cin, cout = h.shape[-1], g.shape[-1]
        # the core cotangent inside the 216 cells, halo zero: the reversed
        # offsets' wrapped terms then vanish
        g_full = torch.zeros((g.shape[0], CELLS6, cout), dtype=torch.float32,
                             device=g.device)
        g_full[:, core_cells(g.device)] = g.float()
        w_rev_t = weights.flip(0).transpose(1, 2).contiguous()
        d_h = brick_conv_cells(g_full, w_rev_t, core_only=False)
        # d_w[k] = (the cells the core read through offset k)^T g
        h6 = h.reshape(-1, SIDE, SIDE, SIDE, cin)
        g_center = g.reshape(-1, cout).float()
        d_w = torch.stack([
            h6[:, 1 + dx:5 + dx, 1 + dy:5 + dy, 1 + dz:5 + dz].reshape(
                -1, cin).T @ g_center
            for dx, dy, dz in DIRS27
        ])
        return d_h.to(h.dtype), d_w.to(weights.dtype)


def brick_conv(padded: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, 6, 6, 6, Cin) halo'd bricks x (27, Cin, Cout) -> the core conv
    (B, 4, 4, 4, Cout) float32, differentiable in both arguments."""
    b, cin = padded.shape[0], padded.shape[-1]
    h = padded.reshape(b, CELLS6, cin).float().contiguous()
    out = _BrickConvCore.apply(h, weights.float().contiguous())
    return out.reshape(b, 4, 4, 4, weights.shape[-1])
