"""The window-attention kernel's share of its roofline over the serving
window: the least time of every attention forward of both stage-1
forwards (float32 operands at TF32's 495 TFLOP/s or bytes at the HBM
rate, whichever is larger), over the device time of
``csrc/window_attention.cu``'s kernel in the trace."""

from benchmark.lib.trace import kernel_matcher
from benchmark.reference.peaks import KERNEL_GROUPS
from benchmark.reference.work import attention_calls, least_seconds


def read(window, ctx):
    if window["kind"] != "serve":
        return None
    calls = [c for layers in window["step_layers"]
             for c in attention_calls(layers, False)]
    seconds = window["trace"].device_seconds(
        kernel_matcher(KERNEL_GROUPS["attention"]))
    if window["launched"].get("window_attention", 0) != len(calls) \
            or seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(o, b, "float32")
                       for o, b in calls) / seconds
