"""Milliseconds of stage 1 a cloud: the benchmark's span around
``pipeline/predict.py::make_predictions`` (both forwards and the host's
filtering), averaged over the clouds of the window's untraced head."""


def read(window, ctx):
    if window["kind"] != "serve" or not window["stage1_s"]:
        return None
    return 1000.0 * sum(window["stage1_s"]) / len(window["stage1_s"])
