"""The served clouds' share of the chip's dense bf16 peak: the analytic
FLOPs of both stage-1 forwards of every cloud in the window's untraced
head (counted by the reference from each cloud's structure), over the
head's wall time. The head is the window before its traced tail, so the
profiler's overhead is not in it."""

from benchmark.reference.peaks import MFU_PEAK
from benchmark.reference.work import forward_flops


def read(window, ctx):
    if window["kind"] != "serve" or not window["head_layers"]:
        return None
    flops = sum(forward_flops(layers) for layers in window["head_layers"])
    return 100.0 * flops / window["head_s"] / MFU_PEAK
