"""The banded full-order sweep's f64 refinement a call (each pass applies
the chunk's f32 factors, forms the f64 residual of its stacked solutions
and reads the norm back): the device seconds of the program's
"banded.refine" spans, summed over every call of the traced window, over
its calls. A program without the span reads nothing."""


def read(rec):
    w = rec.window
    t = w.phases.get("banded.refine")
    return t / w.attempted if t is not None and w.attempted else None
