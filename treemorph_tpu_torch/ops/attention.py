"""Masked window attention of PTv3's serialized blocks.

Port of ``treemorph_tpu/ops/attention.py`` (the forward). Points sorted
along a space-filling curve are cut into windows of K rows; every
(window, head) computes ``softmax(Q K^T / sqrt(D) + mask) V``, where a
(query, key) pair is allowed only when both segment ids (batch elements)
are equal and >= 0. A row with no allowed key, padding rows included,
comes out 0.

:func:`window_attention` keeps the JAX layout: q, k, v (W, H, K, D) in f32
or bf16, seg (W, K) int32, out (W, H, K, D) f32. On a CUDA tensor it
launches the kernel of ``csrc/window_attention.cu`` or raises; a CPU tensor
takes :func:`window_attention_reference`, the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import LAUNCHES, check_launch, load_library, stream_handle

#: query rows per block, and keys staged per pass, in the CUDA kernel
TILE = 64
#: head dims the kernel is compiled for
HEAD_DIMS = (8, 16, 32, 64)
#: f32 elements of one chunk's (windows, H, K, K) score tensor in the plain
#: version (the whole tensor is 4.4-8.9 GB at the plot's level 0)
_PLAIN_CHUNK_ELEMENTS = 1 << 26


def allowed_pairs(seg: torch.Tensor) -> torch.Tensor:
    """(W, K, K) bool: key j is allowed for query i of a window when both
    segment ids are equal and >= 0."""
    return (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, :, None]


def window_attention_reference(q, k, v, seg, bias=None):
    """Plain PyTorch version (the JAX package's ``window_attention_reference``):
    scores in f32 from ``q * D^-0.5`` and ``k``, ``bias`` (W, H, K, K) added
    when given, disallowed pairs at -inf, rows with no allowed key 0. Runs
    over chunks of windows so the score tensor stays small."""
    w_count, h, kk, d = q.shape
    scale = d**-0.5
    out = torch.empty((w_count, h, kk, d), dtype=torch.float32,
                      device=q.device)
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
    return out


def window_attention(q, k, v, seg):
    """Masked attention within each window; (W, H, K, D) float32.

    On a CUDA tensor this launches the kernel of
    ``csrc/window_attention.cu`` (D in :data:`HEAD_DIMS`, K a multiple of
    :data:`TILE`) or raises; a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, seg)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} must be one (W, H, K, D) shape"
        )
    w_count, h, kk, d = q.shape
    if seg.shape != (w_count, kk) or seg.dtype != torch.int32:
        raise ValueError(
            f"window_attention: seg {tuple(seg.shape)} {seg.dtype}, want "
            f"({w_count}, {kk}) int32"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"window_attention: head dim {d} not in {HEAD_DIMS}")
    if kk % TILE or kk == 0:
        raise ValueError(f"window_attention: window {kk} not a multiple of "
                         f"{TILE}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == v.dtype == q.dtype
    ):
        raise TypeError(f"window_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of f32, bf16")
    tensors = (q, k, v, seg)
    if any(t.device != q.device for t in tensors):
        raise ValueError("window_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("window_attention: tensors must be contiguous")

    lib = _library()
    out = torch.empty((w_count, h, kk, d), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.window_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            int(q.dtype == torch.bfloat16), out.data_ptr(), w_count, h, kk,
            d, d**-0.5, stream_handle(q.device),
        )
    check_launch("window_attention", rc)
    LAUNCHES["window_attention"] += 1
    return out


def _library():
    lib = load_library("window_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.window_attention_launch.argtypes = [
            p, p, p, p, i, p, i, i, i, i, ctypes.c_float, p,
        ]
        lib.window_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib
