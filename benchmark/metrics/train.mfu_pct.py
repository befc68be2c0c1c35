"""The training steps' share of the chip's dense bf16 peak: the model's
analytic FLOPs of every step in the window's untraced head (3x the
forward's, counted by the reference from each batch's structure), over
the head's wall time. The head is the window before its traced tail, so
the profiler's overhead is not in it."""

from benchmark.reference.peaks import MFU_PEAK
from benchmark.reference.work import forward_flops


def read(window, ctx):
    if window["kind"] != "train" or not window["head_layers"]:
        return None
    flops = sum(3 * forward_flops(layers) for layers in window["head_layers"])
    return 100.0 * flops / window["head_s"] / MFU_PEAK
