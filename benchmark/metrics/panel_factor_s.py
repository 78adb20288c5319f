"""The panel LU's factors a sweep (K1-K3, the diagonal blocks' inverses):
the device seconds of the program's "panel.factor" spans, summed over
every sweep of the traced window, over its sweeps."""


def read(rec):
    w = rec.window
    t = w.phases.get("panel.factor")
    return t / w.attempted if t is not None and w.attempted else None
