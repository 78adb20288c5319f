"""Reads that wait for the card, a call: the program's "host sync"
ranges in the profiled calls, over those calls. Syncs inside library
calls (an LU's or SVD's info check) are not among them."""

RANGE = "host sync"


def read(rec):
    t = rec.window.trace
    if t is None or not t.calls or RANGE not in t.range_count:
        return None
    return t.range_count[RANGE] / t.calls
