"""The greedy's error estimates a call: the device seconds of the
program's "greedy.estimate" spans, summed over every call of the traced
window, over its calls."""


def read(rec):
    w = rec.window
    t = w.phases.get("greedy.estimate")
    return t / w.attempted if t is not None and w.attempted else None
