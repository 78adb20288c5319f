"""The equally-distributed basis's seed solves a call (on the banded
route the banded full-order sweep of the call's seed points: their f32
block-Thomas factor, f64 refinement and any escalation; then the thin
SVD of the solutions): the device seconds of the program's
"equally.solve" spans, summed over every call of the traced window, over
its calls. A program without the span reads nothing."""


def read(rec):
    w = rec.window
    t = w.phases.get("equally.solve")
    return t / w.attempted if t is not None and w.attempted else None
