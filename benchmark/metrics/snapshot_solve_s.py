"""The greedy's snapshot solves a call: the device seconds of the
program's "greedy.solve" spans (two timing events on the stream each),
summed over every call of the traced window, over its calls."""


def read(rec):
    w = rec.window
    t = w.phases.get("greedy.solve")
    return t / w.attempted if t is not None and w.attempted else None
