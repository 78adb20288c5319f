"""Refinement steps a full-order sweep: the panel sweep's
``chunk_iterations`` summed over the window, over its sweeps. Each step
reads a residual norm back to the host."""


def read(rec):
    w = rec.window
    steps = w.counters.get("refine_steps")
    return steps / w.attempted if steps is not None and w.attempted else None
