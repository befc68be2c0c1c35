"""Share of the traced serving window in which no operation ran on the
card: one minus the union of the device intervals over the window."""


def read(window, ctx):
    if window["kind"] != "serve":
        return None
    return 100.0 * (1.0 - window["trace"].busy_s() / window["window_s"])
