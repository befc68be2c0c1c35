"""Milliseconds a training step waits for its batch: the benchmark's span
around reading it (``TreeDataset`` -> ``batch_iterator``), averaged over
the steps of the window's untraced head. The copy to the card
(``harness.to_device``) is outside the span: from pageable memory it
waits for the previous step's kernels, which is the device's time
(``device.idle_pct.train``, ``device.syncs_per_step.train``), not the
loader's."""


def read(window, ctx):
    if window["kind"] != "train" or not window["waits"]:
        return None
    return 1000.0 * sum(window["waits"]) / len(window["waits"])
