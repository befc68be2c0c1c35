"""Milliseconds of stage 2 a cloud: the benchmark's span around
``pipeline/upsample.py::upsample``, averaged over the clouds of the
window's untraced head."""


def read(window, ctx):
    if window["kind"] != "serve" or not window["stage2_s"]:
        return None
    return 1000.0 * sum(window["stage2_s"]) / len(window["stage2_s"])
