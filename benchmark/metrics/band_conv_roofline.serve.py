"""The band conv kernel's share of its roofline over the serving window:
the least time of every band call of both stage-1 forwards (operations at
the conv type's peak or bytes at the HBM rate, whichever is larger), over
the device time of ``csrc/band_conv.cu``'s kernels in the trace. Nothing
to read where a conv left the band kernel."""

from benchmark.lib.trace import kernel_matcher
from benchmark.reference.peaks import KERNEL_GROUPS
from benchmark.reference.work import band_conv_calls, least_seconds


def read(window, ctx):
    if window["kind"] != "serve":
        return None
    dtype = ctx.config["model"]["conv_dtype"]
    calls = [c for layers in window["step_layers"]
             for c in band_conv_calls(layers, False, dtype)]
    seconds = window["trace"].device_seconds(
        kernel_matcher(KERNEL_GROUPS["band_conv"]))
    if window["launched"].get("band_conv", 0) != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(o, b, dtype) for o, b in calls) / seconds
