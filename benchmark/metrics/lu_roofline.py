"""The full-order sweep's share of its roofline, in %: the least time the
card could take for the sweep's LU work (harness/roofline.py: I·(⅔N³ +
2N²M) operations at the dense bf16 tensor rate, or the three f64
operators read and x written once at HBM bandwidth, whichever binds) over
the device's busy time inside the program's "full-order sweep" ranges of
the profiled calls. Not tied to kernel names."""

import sys

from benchmark.harness import roofline

RANGE = "full-order sweep"


def read(rec):
    t = rec.window.trace
    if t is None or not t.range_busy_s.get(RANGE):
        return None
    cfg = rec.cell.config
    sweeps = t.range_count[RANGE]
    flops, nbytes = roofline.lu_sweep_work(int(cfg["n"]), int(cfg["m"]),
                                           int(rec.cell.traffic["points"]))
    least, bound = roofline.least_seconds(flops, nbytes, rec.device_kind)
    print(f"lu_roofline: {bound} bind ({flops:.4e} operations, "
          f"{nbytes:.4e} bytes a sweep)", file=sys.stderr)
    return 100.0 * least * sweeps / t.range_busy_s[RANGE]
