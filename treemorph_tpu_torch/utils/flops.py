"""Analytic FLOP accounting and device time for MFU reporting.

Port of ``treemorph_tpu/utils/flops.py``. MFU is the analytic FLOPs of a
call over its measured device time over the card's peak rate: points per
second alone cannot say whether a forward sits at 3 % or at 30 % of the
hardware.

FLOPs come from two sources:

- **torch ops**: ``torch.utils.flop_counter.FlopCounterMode`` counts the
  matmuls, convolutions and attention calls that dispatch through ATen.
- **hand kernels**: the ``csrc/`` kernels are ctypes calls that ATen never
  sees, so each wrapper logs its work into the kernel log while
  :func:`count_kernel_flops` is open. A wrapper checks one flag before it
  counts anything, so outside that context the log costs no launch and no
  host synchronization. Inside it the counts (for example a plan's
  in-window rulebook entries) stay device tensors; they are summed and
  moved to the host once, when the context closes.

The log counts the useful multiply-adds of each call, the work that the
kernel table of ``PERF.md`` counts for its "operations" bounds, not the
work an implementation happens to issue, so that a redesign of a kernel
leaves its count as it was:

- band conv (forward, and ``d_feats``, which is the forward kernel on the
  gradient): ``2 * nnz * Cin * Cout``, nnz the found rulebook entries that
  lie inside their window; the weight gradient the same term;
- z-band conv: ``2 * anchors * ksize * Cin * Cout`` over the found anchors
  inside their window, ksize rows of Cin channels a packed row;
- window attention: ``4 * D`` per allowed (query, key) pair and head
  forward (the scores and P V), ``5 * D`` backward;
- brick conv: ``2 * live * cells * 27 * Cin * Cout`` over the bricks whose
  input is not all zero, 64 core cells or all 216.

The JAX package's log differs: it counts at trace time what its Pallas
kernels issue on the TPU, one-hot selects over padded tiles included, so
its figures describe that implementation's position on the roofline and
are not comparable with these.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

#: per-tag device tensors (or numbers) of the open counting context, or
#: None when no context is open
_LOG: dict | None = None

#: dense bf16 tensor-core peak FLOP/s by the name ``torch.cuda.
#: get_device_name()`` gives (NVIDIA H100 datasheet, SXM5: 989.4 TFLOPS
#: without sparsity)
_CARD_PEAKS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def counting() -> bool:
    """Whether a :func:`count_kernel_flops` context is open."""
    return _LOG is not None


def log_kernel_flops(tag: str, flops) -> None:
    """Add ``flops`` (a number, or a device tensor, summed later) to
    ``tag``'s entry of the open context's log."""
    _LOG[tag].append(flops)


@contextlib.contextmanager
def count_kernel_flops():
    """Collect the hand kernels' analytic FLOPs of the calls made inside
    the block. Yields a dict that, once the block has ended, maps each
    wrapper's tag to its FLOPs (floats). Contexts do not nest."""
    global _LOG
    if _LOG is not None:
        raise RuntimeError("count_kernel_flops contexts do not nest")
    _LOG = defaultdict(list)
    totals: dict[str, float] = {}
    try:
        yield totals
    finally:
        log, _LOG = _LOG, None
    for tag, entries in log.items():
        totals[tag] = float(sum(
            float(e.double().sum()) if torch.is_tensor(e) else float(e)
            for e in entries
        ))


def chip_peak_flops_bf16(device=None) -> float:
    """The dense bf16 peak of the card ``device`` (the current CUDA
    device unless named), by its name. Raises for a card not in the table
    rather than guessing."""
    name = torch.cuda.get_device_name(device)
    if name not in _CARD_PEAKS_BF16:
        raise KeyError(f"no bf16 peak known for {name!r}; known: "
                       f"{sorted(_CARD_PEAKS_BF16)}")
    return _CARD_PEAKS_BF16[name]


def analytic_flops(fn, *args) -> dict:
    """Analytic FLOPs of one call of ``fn(*args)``: ``torch_flops`` from
    ``FlopCounterMode`` (the ATen ops), ``kernel_flops`` from the hand
    kernels' log, and ``total_flops``. On the CPU the wrappers take their
    plain versions, whose ATen ops the log already counts, so those are
    left out of ``torch_flops``: both devices report the same split."""
    from torch.utils.flop_counter import FlopCounterMode

    with count_kernel_flops() as kernel, FlopCounterMode(
            display=False) as counter:
        with _plain_versions_uncounted(counter):
            fn(*args)
    torch_flops = float(counter.get_total_flops())
    kernel_flops = float(sum(kernel.values()))
    return {"torch_flops": torch_flops, "kernel_flops": kernel_flops,
            "total_flops": torch_flops + kernel_flops,
            "kernel_flops_by_tag": dict(kernel)}


#: module attributes the wrappers call on the CPU in place of a kernel
_PLAIN_VERSIONS = (
    ("..ops.bandconv", ("band_conv_padded_plain", "band_conv_dw_padded_plain",
                        "zband_conv_padded_plain")),
    ("..ops.attention", ("window_attention_reference",
                         "window_attention_bwd_reference")),
    ("..ops.brick_conv", ("brick_conv_cells_plain",)),
)


@contextlib.contextmanager
def _plain_versions_uncounted(counter):
    """While open, each kernel's plain version runs with ``counter``'s
    counting suspended, so its ATen ops are not counted twice beside the
    kernel log."""
    import importlib

    saved = []

    def uncounted(fn):
        def run(*a, **kw):
            with _suspended(counter):
                return fn(*a, **kw)
        return run

    for mod_name, names in _PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name, __package__)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, uncounted(getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _suspended(counter):
    """``counter``'s FLOPs are restored to what they were on entry when
    the block ends."""
    before = {mod: dict(ops) for mod, ops in counter.flop_counts.items()}
    try:
        yield
    finally:
        counter.flop_counts.clear()
        for mod, ops in before.items():
            counter.flop_counts[mod].update(ops)


def measure_device_time_ms(fn, args, iters: int = 3) -> float:
    """Device time of one call of ``fn(*args)``: the summed time of the
    CUDA kernels in a ``torch.profiler`` trace of ``iters`` calls (after
    one call outside it), divided by ``iters``. User annotations
    (``record_function`` ranges on the device's timeline) are spans, not
    kernels, and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    total_us = sum(
        e.device_time_total if hasattr(e, "device_time_total")
        else e.cuda_time_total
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    return total_us / 1e3 / iters


def mfu_report(fn, args, iters: int = 3, peak: float | None = None) -> dict:
    """FLOPs, device time and MFU of one call of ``fn(*args)`` against
    ``peak`` (default: the card's dense bf16 peak)."""
    flops = analytic_flops(fn, *args)
    dt_ms = measure_device_time_ms(fn, args, iters=iters)
    peak = peak or chip_peak_flops_bf16()
    achieved = flops["total_flops"] / (dt_ms / 1e3) if dt_ms > 0 else 0.0
    return {
        **flops,
        "device_ms": float(dt_ms),
        "achieved_flops_per_sec": achieved,
        "peak_flops_bf16": peak,
        "mfu": achieved / peak,
    }
