"""Snapshot solves a call: the program's "greedy.solve" ranges in the
profiled calls, over those calls."""

RANGE = "greedy.solve"


def read(rec):
    t = rec.window.trace
    if t is None or not t.calls or RANGE not in t.range_count:
        return None
    return t.range_count[RANGE] / t.calls
