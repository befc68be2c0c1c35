"""The band conv kernels' share of their roofline over the training
window: the least time of every band call the steps made (forward, feature
gradient, weight gradient; operations at the conv type's peak or bytes at
the HBM rate, whichever is larger), over the device time of the kernels
of ``csrc/band_conv.cu`` and ``csrc/band_conv_bwd.cu`` in the trace.
Nothing to read where a conv left the band kernels (fewer launches than
the layers count)."""

from benchmark.lib.trace import kernel_matcher
from benchmark.reference.peaks import KERNEL_GROUPS
from benchmark.reference.work import band_conv_calls, least_seconds


def read(window, ctx):
    if window["kind"] != "train":
        return None
    dtype = ctx.config["model"]["conv_dtype"]
    calls = [c for layers in window["step_layers"]
             for c in band_conv_calls(layers, True, dtype)]
    launched = (window["launched"].get("band_conv", 0)
                + window["launched"].get("band_conv_bwd", 0))
    seconds = window["trace"].device_seconds(
        kernel_matcher(KERNEL_GROUPS["band_conv"]))
    if launched != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(o, b, dtype) for o, b in calls) / seconds
