"""The share of the traced calls' wall time in which no kernel, memcpy or
memset ran on the card: 1 − busy / window over the profiled calls."""


def read(rec):
    t = rec.window.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
