"""The window-attention kernels' share of their roofline over the
training window: the least time of every attention call the steps made
(forward and backward, float32 operands at TF32's 495 TFLOP/s or bytes at
the HBM rate, whichever is larger), over the device time of the kernels
of ``csrc/window_attention.cu`` and ``csrc/window_attention_bwd.cu`` in
the trace. Nothing to read where the launches do not match the layers."""

from benchmark.lib.trace import kernel_matcher
from benchmark.reference.peaks import KERNEL_GROUPS
from benchmark.reference.work import attention_calls, least_seconds


def read(window, ctx):
    if window["kind"] != "train":
        return None
    calls = [c for layers in window["step_layers"]
             for c in attention_calls(layers, True)]
    launched = (window["launched"].get("window_attention", 0)
                + window["launched"].get("window_attention_bwd", 0))
    seconds = window["trace"].device_seconds(
        kernel_matcher(KERNEL_GROUPS["attention"]))
    if launched != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(o, b, "float32")
                       for o, b in calls) / seconds
