"""Time to a converged reduced sweep: the whole window over the calls
completed in it (the window closes at a call boundary)."""


def read(rec):
    w = rec.window
    return w.window_s / w.calls if w.calls else None
