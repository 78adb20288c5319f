"""The banded full-order sweep's share of its roofline, in %: the least
time the card could take for the sweep's banded work over the device's
busy time inside the program's "full-order sweep" ranges of the profiled
calls. Not tied to kernel names.

The work is counted from the problem's shape, whatever implements it
(`sweep_work`): per point an LU of a band of half-width w (2·N·w²
operations) and its two triangular solves for M columns (4·N·w·M); the
three f64 bands read once (8·3·N·(2w+1) bytes) and x written once (8·N·M
bytes a point). N is the pencil's (``n_total``) and w one dense block's
half-width, ``n`` − 1: the tiled pencil's half-bandwidth. The card's
peaks are `harness/roofline.py`'s."""

import sys

from benchmark.harness import roofline

RANGE = "full-order sweep"


def sweep_work(n: int, w: int, m: int, points: int, word: int = 8):
    """(operations, bytes) of a banded full-order sweep of `points`
    N×N systems of half-bandwidth w with M right-hand sides."""
    flops = points * (2.0 * n * w * w + 4.0 * n * w * m)
    nbytes = word * (3.0 * n * (2 * w + 1) + points * n * m)
    return flops, nbytes


def read(rec):
    t = rec.window.trace
    if t is None or not t.range_busy_s.get(RANGE):
        return None
    cfg = rec.cell.config
    sweeps = t.range_count[RANGE]
    flops, nbytes = sweep_work(int(cfg["n_total"]), int(cfg["n"]) - 1,
                               int(cfg["m"]), int(rec.cell.traffic["points"]))
    least, bound = roofline.least_seconds(flops, nbytes, rec.device_kind)
    print(f"banded_roofline: {bound} bind ({flops:.4e} operations, "
          f"{nbytes:.4e} bytes a sweep)", file=sys.stderr)
    return 100.0 * least * sweeps / t.range_busy_s[RANGE]
