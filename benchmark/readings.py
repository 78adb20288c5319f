"""Readings that set a cell's limits, and the control that has to fail
them. Not part of a run.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

One process sets the cell up once, then for each seed drives a window of
`--seconds` at the cell's own load and prints one JSON line: the calls,
the end-to-end metrics and each number the check compares for the
program and, with ``--control``, for the control: the plain reference in
the next lower precision (float32, TF32 off) put in the program's place,
at the same sampled points.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cli, registry  # noqa: E402


def readings(cell, seeds, seconds, control, device="cuda"):
    """Yield one dict per seed."""
    bench = cli.Bench(cell, device)
    try:
        bench.setup()
        setup_s = time.perf_counter() - T_START
        for seed in seeds:
            win = bench.window(seed, seconds, False)
            rec = cli.Records(setup_s, win, cell,
                              cli.device_info(bench.device, 1)["kind"])
            metrics = {m["name"]: registry.metric_reader(
                m["name"], cell.bench_dir)(rec) for m in cell.end_to_end}
            sampled = bench.program_values(win)
            line = {"cell": cell.name, "seed": seed, "calls": win.calls,
                    "attempted": win.attempted, "failed": win.failed,
                    "window_s": win.window_s, "metrics": metrics,
                    "program": bench.compare(sampled)}
            if control:
                line["control"] = bench.compare(sampled, control=True)
            yield line
    finally:
        bench.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = registry.find_cell(args.workload)
    cli.set_cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(cell, seeds, args.seconds, args.control):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
