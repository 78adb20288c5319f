"""The panel LU's diagonal-block inverses a sweep (K7, one launch a
factor's block step): the device seconds of the program's "panel.invert"
spans, summed over every sweep of the traced window, over its sweeps.
A program without the span reads nothing."""


def read(rec):
    w = rec.window
    t = w.phases.get("panel.invert")
    return t / w.attempted if t is not None and w.attempted else None
