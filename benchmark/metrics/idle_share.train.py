"""The share of the traced training window in which no operation ran on
the device: 1 - busy / window."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
