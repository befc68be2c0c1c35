"""Masked window attention of PTv3's serialized blocks, and its gradient.

Port of ``treemorph_tpu/ops/attention.py``. Points sorted along a
space-filling curve are cut into windows of K rows; every (window, head)
computes ``softmax(Q K^T / sqrt(D) + mask) V``, where a (query, key) pair
is allowed only when both segment ids (batch elements) are equal and
>= 0. A row with no allowed key, padding rows included, comes out 0, and
so do its gradients.

:func:`window_attention` keeps the JAX layout: q, k, v (W, H, K, D) in f32
or bf16, seg (W, K) int32, out (W, H, K, D) f32. It is differentiable
(:class:`_WindowAttention`, the JAX package's custom VJP): on CUDA tensors
the forward launches the kernel of ``csrc/window_attention.cu`` and the
backward that of ``csrc/window_attention_bwd.cu``, or raise; CPU tensors
take the plain versions, :func:`window_attention_reference` and
:func:`window_attention_bwd_reference`. On the card a forward that autograd
will differentiate also writes each row's log-sum-exp of the scaled scores
and saves it with the output: the backward kernel then needs neither a pass
for the row statistics nor ``rowsum(dp * P)``, which is ``g . out``.
Inference writes no log-sum-exp.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import flops
from .cuda import LAUNCHES, check_launch, load_library, stream_handle

#: keys staged per pass in the CUDA kernels (the backward's rows per block
#: too); the window K must be a multiple of it
TILE = 64
#: head dims the kernel is compiled for
HEAD_DIMS = (8, 16, 32, 64)
#: f32 elements of one chunk's (windows, H, K, K) score tensor in the plain
#: version (the whole tensor is 4.4-8.9 GB at the plot's level 0)
_PLAIN_CHUNK_ELEMENTS = 1 << 26
#: the JAX kernels' fill for disallowed scores
NEG_INF = -1e30


def allowed_pairs(seg: torch.Tensor) -> torch.Tensor:
    """(W, K, K) bool: key j is allowed for query i of a window when both
    segment ids are equal and >= 0."""
    return (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, :, None]


def window_attention_reference(q, k, v, seg, bias=None, return_lse=False):
    """Plain PyTorch version (the JAX package's ``window_attention_reference``):
    scores in f32 from ``q * D^-0.5`` and ``k``, ``bias`` (W, H, K, K) added
    when given, disallowed pairs at -inf, rows with no allowed key 0. Runs
    over chunks of windows so the score tensor stays small. With
    ``return_lse`` also each row's log-sum-exp of its allowed scores,
    (W, H, K) f32, 0 for a row with no allowed key."""
    w_count, h, kk, d = q.shape
    scale = d**-0.5
    out = torch.empty((w_count, h, kk, d), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((w_count, h, kk), dtype=torch.float32, device=q.device)
    step = max(1, _PLAIN_CHUNK_ELEMENTS // (h * kk * kk))
    for w0 in range(0, w_count, step):
        sl = slice(w0, w0 + step)
        s = (q[sl].float() * scale) @ k[sl].float().transpose(-1, -2)
        if bias is not None:
            s = s + bias[sl].float()
        ok = allowed_pairs(seg[sl])[:, None]
        s = torch.where(ok, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(ok, torch.exp(s - m), 0.0)
        denom = e.sum(dim=-1, keepdim=True).clamp(min=1e-20)
        out[sl] = (e / denom) @ v[sl].float()
        lse[sl] = torch.where(ok.any(dim=-1), (m + denom.log())[..., 0], 0.0)
    return (out, lse) if return_lse else out


def window_attention_bwd_reference(q, k, v, seg, g, out=None, lse=None):
    """Plain PyTorch version of the backward (the JAX package's
    ``_window_attention_bwd_kernel``), in f32: P recomputed with the
    forward's mask, the -1e30 fill and the 1e-20 clamp, then ``dv = P^T g``,
    ``dp = g V^T``, ``ds = P * (dp - rowsum(dp * P))``, ``dq = ds K scale``,
    ``dk = ds^T (q scale)``. Given the forward's ``out`` and ``lse``, it
    takes the CUDA kernel's route instead: ``P = exp(s - lse)`` on the
    allowed pairs and ``rowsum(dp * P) = rowsum(g * out)``. Runs over chunks
    of windows as the forward's plain version does; returns (dq, dk, dv),
    each (W, H, K, D) f32."""
    w_count, h, kk, d = q.shape
    scale = d**-0.5
    dq, dk, dv = (torch.empty((w_count, h, kk, d), dtype=torch.float32,
                              device=q.device) for _ in range(3))
    step = max(1, _PLAIN_CHUNK_ELEMENTS // (h * kk * kk))
    for w0 in range(0, w_count, step):
        sl = slice(w0, w0 + step)
        qs = q[sl].float() * scale
        kf, vf, gf = k[sl].float(), v[sl].float(), g[sl].float()
        ok = allowed_pairs(seg[sl])[:, None]
        s = torch.where(ok, qs @ kf.transpose(-1, -2), NEG_INF)
        if lse is None:
            e = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                            0.0)
            p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-20)
        else:
            p = torch.where(ok, torch.exp(s - lse[sl, ..., None]), 0.0)
        dv[sl] = p.transpose(-1, -2) @ gf
        dp = gf @ vf.transpose(-1, -2)
        if out is None:
            delta = (dp * p).sum(dim=-1, keepdim=True)
        else:
            delta = (gf * out[sl]).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta)
        dq[sl] = (ds @ kf) * scale
        dk[sl] = ds.transpose(-1, -2) @ qs
    return dq, dk, dv


def _check_inputs(name, q, k, v, seg, g=None):
    """Raise on what the CUDA kernels do not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} must be one (W, H, K, D) shape"
        )
    w_count, h, kk, d = q.shape
    if seg.shape != (w_count, kk) or seg.dtype != torch.int32:
        raise ValueError(f"{name}: seg {tuple(seg.shape)} {seg.dtype}, want "
                         f"({w_count}, {kk}) int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if kk % TILE or kk == 0:
        raise ValueError(f"{name}: window {kk} not a multiple of {TILE}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == v.dtype == q.dtype
    ):
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"want one of f32, bf16")
    tensors = (q, k, v, seg)
    if g is not None:
        if g.shape != q.shape or g.dtype != torch.float32:
            raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype}, want "
                             f"{tuple(q.shape)} float32")
        tensors += (g,)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _aligned(x):
    """``x``, or a copy of it where its data is not 16-byte aligned (the
    kernels load 16 bytes at a time)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _window_attention_cuda(q, k, v, seg, with_lse=False):
    """The forward kernel of ``csrc/window_attention.cu``: (out, lse), lse
    (W, H, K) f32 with ``with_lse`` and None without."""
    _check_inputs("window_attention", q, k, v, seg)
    w_count, h, kk, d = q.shape
    lib = _library("window_attention")
    q, k, v, seg = (_aligned(x) for x in (q, k, v, seg))
    out = torch.empty((w_count, h, kk, d), dtype=torch.float32,
                      device=q.device)
    lse = (torch.empty((w_count, h, kk), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.window_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            int(q.dtype == torch.bfloat16), out.data_ptr(),
            lse.data_ptr() if with_lse else None, w_count, h, kk, d,
            d**-0.5, stream_handle(q.device),
        )
    check_launch("window_attention", rc)
    LAUNCHES["window_attention"] += 1
    return out, lse


def allowed_pair_count(seg: torch.Tensor) -> torch.Tensor:
    """Allowed (query, key) pairs of the windows ``seg`` (W, K) per head,
    a device tensor: over windows and segments, the segment's rows
    squared (each row's run of equal ids in the sorted window, summed)."""
    s = torch.sort(seg.to(torch.int64), dim=1).values
    run = (torch.searchsorted(s, s, right=True)
           - torch.searchsorted(s, s, right=False))
    return torch.where(s >= 0, run, 0).sum()


def _log_flops(tag, q, seg, per_pair):
    """Log ``per_pair`` x D FLOPs per allowed pair and head of a call
    (:mod:`..utils.flops`)."""
    flops.log_kernel_flops(
        tag, allowed_pair_count(seg) * (per_pair * q.shape[1] * q.shape[3]))


def window_attention_fwd(q, k, v, seg):
    """(out, lse) of the forward: the output and each row's log-sum-exp of
    its allowed scaled scores (0 for a row with none), as the backward
    takes them. On CUDA tensors the kernel of ``csrc/window_attention.cu``
    (or raise); CPU tensors take :func:`window_attention_reference`."""
    if flops.counting():
        _log_flops("window_attention", q, seg, 4)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, seg, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    return _window_attention_cuda(q, k, v, seg, with_lse=True)


def window_attention_bwd(q, k, v, seg, g, out, lse):
    """(dq, dk, dv) of :func:`window_attention` for the output cotangent
    ``g`` (f32), given the forward's ``out`` and ``lse``
    (:func:`window_attention_fwd`), each (W, H, K, D) f32, by the kernels of
    ``csrc/window_attention_bwd.cu`` on CUDA tensors (D in
    :data:`HEAD_DIMS`, K a multiple of :data:`TILE`); raises on anything
    else. One call runs two grids (``dq``, then ``dk`` and ``dv``) and
    counts one launch."""
    if flops.counting():
        _log_flops("window_attention_bwd", q, seg, 5)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: unsupported device "
                         f"{q.device}")
    _check_inputs("window_attention_bwd", q, k, v, seg, g)
    w_count, h, kk, d = q.shape
    if (out.shape != q.shape or lse.shape != (w_count, h, kk)
            or out.dtype != torch.float32 or lse.dtype != torch.float32
            or out.device != q.device or lse.device != q.device
            or not (out.is_contiguous() and lse.is_contiguous())):
        raise ValueError("window_attention_bwd: out and lse must be the "
                         "forward's, f32 and contiguous")
    lib = _library("window_attention_bwd")
    q, k, v, g, out = (_aligned(x) for x in (q, k, v, g, out))
    dq, dk, dv = (torch.empty((w_count, h, kk, d), dtype=torch.float32,
                              device=q.device) for _ in range(3))
    # per query row: rowsum(g * out), from the first grid to the second
    delta = torch.empty((w_count, h, kk), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.window_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            g.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), w_count, h, kk, d, d**-0.5,
            stream_handle(q.device),
        )
    check_launch("window_attention_bwd", rc)
    LAUNCHES["window_attention_bwd"] += 1
    return dq, dk, dv


class _WindowAttention(torch.autograd.Function):
    """Window attention with the JAX package's custom VJP
    (``_window_attention_bwd``), returning dq, dk, dv cast to the inputs'
    dtype (the cotangent widened to f32) and no gradient for ``seg``. On
    the card the forward saves its output and log-sum-exp for the backward
    kernel; on the CPU the plain backward recomputes the probabilities from
    the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, seg)
            return window_attention_reference(q, k, v, seg)
        out, lse = _window_attention_cuda(q, k, v, seg, with_lse=True)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, *saved = ctx.saved_tensors
        g = g.float().contiguous()
        if q.device.type == "cpu":
            if flops.counting():
                _log_flops("window_attention_bwd", q, seg, 5)
            dq, dk, dv = window_attention_bwd_reference(q, k, v, seg, g)
        else:
            dq, dk, dv = window_attention_bwd(q, k, v, seg, g, *saved)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def window_attention(q, k, v, seg):
    """Masked attention within each window; (W, H, K, D) float32,
    differentiable in q, k and v.

    On CUDA tensors this launches the kernel of
    ``csrc/window_attention.cu`` (D in :data:`HEAD_DIMS`, K a multiple of
    :data:`TILE`), and its backward that of
    ``csrc/window_attention_bwd.cu``, or raises; CPU tensors take the
    plain versions. Without autograd (no input requires a gradient, or
    grad mode is off) the forward writes no log-sum-exp."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if flops.counting():
        _log_flops("window_attention", q, seg, 4)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return _WindowAttention.apply(q, k, v, seg)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, seg)
    return _window_attention_cuda(q, k, v, seg)[0]


def _library(name):
    """The loaded kernel library ``name`` (``window_attention`` or
    ``window_attention_bwd``), its launch function typed."""
    lib = load_library(name)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(lib, f"{name}_launch")
        if name == "window_attention":  # q k v seg bf16 out lse
            fn.argtypes = [p, p, p, p, i, p, p, i, i, i, i, f, p]
        else:  # q k v seg g out lse bf16 dq dk dv delta
            fn.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p, i, i, i, i,
                           f, p]
        fn.restype = ctypes.c_int
        lib._typed = True
    return lib
