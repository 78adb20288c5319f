"""The equally-distributed basis's Galerkin projection a call (r_p =
Qᵀ·A_p·Q of each nonzero addend and b_r = Qᵀ·B): the device seconds of
the program's "equally.project" spans, summed over every call of the
traced window, over its calls. A program without the span reads
nothing."""


def read(rec):
    w = rec.window
    t = w.phases.get("equally.project")
    return t / w.attempted if t is not None and w.attempted else None
