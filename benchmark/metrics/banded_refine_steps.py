"""f64 refinement passes a snapshot of the banded direct solve: the
program's "banded.refine" ranges over its "greedy.solve" ranges, in the
profiled calls. Each pass applies the f32 factors, forms the f64
residual and reads its norm back. A program without the span reads
nothing."""

RANGE, PER = "banded.refine", "greedy.solve"


def read(rec):
    t = rec.window.trace
    if t is None or RANGE not in t.range_count or not t.range_count.get(PER):
        return None
    return t.range_count[RANGE] / t.range_count[PER]
