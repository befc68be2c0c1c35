"""Operations and bytes of the port's hand-kernel calls, counted from the
layers a forward runs (``conv_layers`` of a family's reference).

A call's least time is the larger of its operations at the peak of its
operands' type and its bytes at the HBM rate; bytes count each input read
once and each output written once: features and gradients at the conv's
type, weights and outputs in float32, the tiled rulebook's int32 entries
of the rows the call covers.
"""

from __future__ import annotations

from .peaks import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def band_conv_calls(layers: list[dict], train: bool, dtype: str) -> list:
    """``(ops, bytes)`` of each band-kernel call that ``layers`` make:
    every submanifold conv's forward; in training also its feature
    gradient (the forward kernel over the flipped kernel) and its weight
    gradient (``band_conv_bwd``), except the input conv's, whose input
    needs no gradient and whose weight gradient is not a band call."""
    fb = DTYPE_BYTES[dtype]
    calls = []
    for l in layers:
        if l["kind"] not in ("subm", "stem"):
            continue
        m, k, cin, cout = l["rows"], l["k"], l["cin"], l["cout"]
        ops = 2.0 * l["pairs"] * cin * cout
        w, rb = 4.0 * k * cin * cout, 4.0 * m * k
        calls.append((ops, m * cin * fb + w + rb + m * cout * 4.0))
        if train and l["kind"] == "subm":
            calls.append((ops, m * cout * fb + w + rb + m * cin * 4.0))
            calls.append((ops, m * (cin + cout) * fb + rb + w))
    return calls


def forward_flops(layers: list[dict]) -> int:
    """A forward's FLOPs: 2 per (output, input) pair and channel pair of
    each conv or linear; 4 x the head size per allowed (query, key) pair
    and head of each attention."""
    total = 0
    for l in layers:
        if l["kind"] == "attn":
            total += 4 * l["pairs"] * l["head_dim"] * l["heads"]
        else:
            total += 2 * l["pairs"] * l["cin"] * l["cout"]
    return total


def attention_calls(layers: list[dict], train: bool) -> list:
    """``(ops, bytes)`` of each window-attention kernel call: per attention
    layer a forward (4 x head size per allowed pair and head; q, k, v
    read, the output written, and in training each row's log-sum-exp) and
    in training a backward (8 x head size: dV, dP, dQ, dK, the scores'
    recomputation not counted; q, k, v, the output's gradient, the output
    and the log-sum-exp read, dq, dk, dv written). Rows are the layer's
    valid rows, float32."""
    calls = []
    for l in layers:
        if l["kind"] != "attn":
            continue
        rows, h, d = l["rows"], l["heads"], l["head_dim"]
        row_bytes = 4.0 * rows * h * d
        lse = 4.0 * rows * h if train else 0.0
        ops = 4.0 * l["pairs"] * h * d
        calls.append((ops, 4 * row_bytes + lse + 4.0 * rows))
        if train:
            calls.append((2 * ops, 8 * row_bytes + lse + 4.0 * rows))
    return calls
