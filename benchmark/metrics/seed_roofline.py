"""The seed solves' share of their roofline, in %: the least time the
card could take for the banded work of a call's seeds over the device's
busy time inside the program's "equally.solve" ranges of the profiled
calls. Not tied to kernel names.

The work is `banded_roofline.py`'s `sweep_work` (per point an LU of a
band of half-width w and its two triangular solves for M columns; the
three f64 bands read once, x written once) for the seed points alone:
upstream's floor(I·(1 − rate)) of the mix's I points, with the rate the
configuration's ``equally_distributed_reduction_rate``. N is the
pencil's (``n_total``), w one dense block's half-width, ``n`` − 1. The
card's peaks are `harness/roofline.py`'s."""

import math
import sys

from benchmark.harness import roofline
from benchmark.metrics.banded_roofline import sweep_work

RANGE = "equally.solve"


def seed_count(config, points: int) -> int:
    rate = float(config["morfem"]["equally_distributed_reduction_rate"])
    return math.floor(points * (1 - rate))


def read(rec):
    t = rec.window.trace
    if t is None or not t.range_busy_s.get(RANGE):
        return None
    cfg = rec.cell.config
    seeds = seed_count(cfg, int(rec.cell.traffic["points"]))
    flops, nbytes = sweep_work(int(cfg["n_total"]), int(cfg["n"]) - 1,
                               int(cfg["m"]), seeds)
    least, bound = roofline.least_seconds(flops, nbytes, rec.device_kind)
    print(f"seed_roofline: {bound} bind ({flops:.4e} operations, "
          f"{nbytes:.4e} bytes a call's {seeds} seeds)", file=sys.stderr)
    return 100.0 * least * t.range_count[RANGE] / t.range_busy_s[RANGE]
