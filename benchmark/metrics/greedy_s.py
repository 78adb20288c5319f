"""The greedy basis build a call: the program's `PhaseTimer` phase
"projection base" (synchronised) over the window's calls."""


def read(rec):
    w = rec.window
    t = w.phases.get("projection base")
    return t / w.attempted if t is not None and w.attempted else None
