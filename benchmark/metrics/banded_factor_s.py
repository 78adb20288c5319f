"""The banded direct solves' factors a call (the combined band, its
block-tridiagonal blocks and their block-Thomas factorization): the
device seconds of the program's "banded.factor" spans, summed over every
call of the traced window, over its calls. A program without the span
reads nothing."""


def read(rec):
    w = rec.window
    t = w.phases.get("banded.factor")
    return t / w.attempted if t is not None and w.attempted else None
