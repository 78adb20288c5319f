"""The refinement steps a sweep (an apply of the factors, the f64
residual and its norm read back): the device seconds of the program's
"refine.step" spans, summed over every sweep of the traced window, over
its sweeps."""


def read(rec):
    w = rec.window
    t = w.phases.get("refine.step")
    return t / w.attempted if t is not None and w.attempted else None
