"""The port's spans on the card: the slow calls of a window, what trace
mode costs a call, where the host waits for the card, and the spans
against the profiler's ranges.

    python3 tools/span_study.py --cell CELL --study window [--seconds 51]
    python3 tools/span_study.py --cell CELL --study cost [--seconds 15]
    python3 tools/span_study.py --cell CELL --study check

CELL is a cell of ``BENCHMARK.json`` (``waveguide_3411.mor``,
``waveguide_3411.full``). Each study sets the cell up as
``benchmark/run.py`` does (inputs, the program's set-up and warm-up
call), then drives its mix in a closed loop, one caller (``--seed``):

* ``window``: every call of a window in trace mode with no profiler; the
  spans go to ``OUT/spans_<cell>.json`` (`PhaseTimer.export`; ``--out``,
  default ``output/spans``), each call's totals by span name to
  ``OUT/calls_<cell>.json``; prints the
  slow calls (over ``--slow`` × the median) against the median call,
  span name by span name, in host and device seconds and counts;
* ``cost``: each request of a window twice, with no timer and in trace
  mode, in turns (off, on, on, off, ...): the quartiles of the paired
  ratio; then 3 requests off and in trace mode under `torch.profiler`;
* ``check``: 3 calls in trace mode: each call's ``greedy.iteration`` or
  ``panel.chunk`` spans' device seconds over their phase's; one call
  under ``torch.cuda.set_sync_debug_mode("warn")``: each line that
  synchronised, with the spans open there; one call under the profiler:
  the largest gap between a span's bounds and its range's, and the spans
  laid over the profiler's export (`PhaseTimer.export`).

One JSON line a result on stdout, progress on stderr. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cli, registry, traffic  # noqa: E402
from benchmark.harness import trace as tracing  # noqa: E402

# the spans that cover each entry point's heavy phase
COVER = {"mor_gsm": ("greedy.iteration", "projection base"),
         "full_order_gsm": ("panel.chunk", "full-order sweep")}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def drive(bench, seed, timer=None, seconds=None, calls=None):
    """Serve the mix's requests for `seed` until `seconds` or `calls`;
    → each call's seconds."""
    out, t0 = [], time.perf_counter()
    for req in traffic.requests(bench.traffic, seed):
        s = time.perf_counter()
        bench.cell.op.call(bench, bench.state, req, timer)
        cli.sync(bench.device)
        out.append(time.perf_counter() - s)
        if calls is not None and len(out) >= calls:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    return out


def per_call(timer):
    """{call: {"wall": s, "spans": {name: [count, host_s, device_s]}}}."""
    calls = {}
    for s in timer.spans:
        c = calls.setdefault(s.call, {"wall": 0.0, "spans": {}})
        if s.parent is None:
            c["wall"] = s.host_s()
            c["root"] = s.name
            continue
        t = c["spans"].setdefault(s.name, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += s.host_s()
        t[2] += s.device_s
    return calls


def study_window(bench, args, timer_cls):
    timer = timer_cls(trace=True, device=bench.device)
    times = drive(bench, args.seed, timer, seconds=args.seconds)
    os.makedirs(args.out, exist_ok=True)
    timer.export(os.path.join(args.out, f"spans_{args.cell}.json"))
    calls = per_call(timer)
    with open(os.path.join(args.out, f"calls_{args.cell}.json"), "w") as f:
        json.dump(calls, f)
    walls = [c["wall"] for c in calls.values()]
    med = statistics.median(walls)
    names = sorted({n for c in calls.values() for n in c["spans"]})
    median = {n: [statistics.median(c["spans"].get(n, [0, 0.0, 0.0])[i]
                                    for c in calls.values())
                  for i in range(3)] for n in names}
    emit(study="window", cell=args.cell, calls=len(calls),
         window_s=sum(times), call_s=times, median_call_s=med,
         median_by_span=median)
    for number, c in calls.items():
        if c["wall"] <= args.slow * med:
            continue
        grew = {n: [c["spans"].get(n, [0, 0.0, 0.0])[i] - median[n][i]
                    for i in range(3)] for n in names}
        top = sorted(grew.items(), key=lambda kv: -kv[1][1])[:8]
        emit(study="slow_call", call=number, wall_s=c["wall"],
             over_median=c["wall"] / med,
             counts={n: c["spans"].get(n, [0])[0]
                     for n in ("greedy.iteration", "greedy.solve",
                               "refine.step", "host sync", "panel.chunk")
                     if n in names},
             growth_count_host_device=dict(top))


def study_cost(bench, args, timer_cls):
    """Each request twice, with no timer and in trace mode, the order
    turning from request to request (off, on, on, off, ...): the paired
    ratio of call times. Then 3 requests with no timer and in trace mode
    under the profiler."""
    def timed(req, trace, profiled=False):
        timer = timer_cls(trace=True, device=bench.device) if trace else None
        prof = tracing.start() if profiled else None
        s = time.perf_counter()
        bench.cell.op.call(bench, bench.state, req, timer)
        cli.sync(bench.device)
        out = time.perf_counter() - s
        if prof is not None:
            prof.stop()
        return out

    t0 = time.perf_counter()
    offs, ons, ratios = [], [], []
    for k, req in enumerate(traffic.requests(bench.traffic, args.seed)):
        t = {}
        for trace in ((False, True) if k % 2 == 0 else (True, False)):
            t[trace] = timed(req, trace)
        offs.append(t[False])
        ons.append(t[True])
        ratios.append(t[True] / t[False])
        if time.perf_counter() - t0 >= args.seconds:
            break
    emit(study="cost", cell=args.cell, mode="spans", pairs=len(ratios),
         median_off_s=statistics.median(offs),
         median_on_s=statistics.median(ons),
         ratio_quartiles=statistics.quantiles(ratios, n=4))
    reqs = traffic.requests(bench.traffic, args.seed + 1)
    pairs = [(timed(req, False), timed(req, True, profiled=True))
             for _, req in zip(range(3), reqs)]
    emit(study="cost", cell=args.cell, mode="spans_profiled",
         off_on_s=pairs, ratios=[on / off for off, on in pairs])


def study_check(bench, args, timer_cls):
    import torch

    from morfem_tpu_torch.utils import timing

    timer = timer_cls(trace=True, device=bench.device)
    drive(bench, args.seed, timer, calls=3)
    for number, c in per_call(timer).items():
        inner, phase = COVER[c["root"]]
        ph = sum(s.device_s for s in timer.spans
                 if s.call == number and s.phase and s.name == phase)
        emit(study="cover", cell=args.cell, call=number, span=inner,
             phase=phase, phase_s=ph, spans_s=c["spans"][inner][2],
             share=c["spans"][inner][2] / ph)

    sites = {}

    def seen(message, category, filename, lineno, file=None, line=None):
        active = timing._active
        stack = [r.name for _, r in active._stack] if active else []
        key = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        site = sites.setdefault(key, {"n": 0, "message": str(message)[:80],
                                      "spans": {}})
        site["n"] += 1
        where = " > ".join(stack[-3:]) or "no span"
        site["spans"][where] = site["spans"].get(where, 0) + 1

    timer = timer_cls(trace=True, device=bench.device)
    card = bench.device.type == "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        if card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            drive(bench, args.seed, timer, calls=1)
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
    for key, site in sorted(sites.items(), key=lambda kv: -kv[1]["n"]):
        inside = sum(n for w, n in site["spans"].items()
                     if w.endswith(timing.HOST_SYNC))
        emit(study="sync", cell=args.cell, site=key, n=site["n"],
             in_host_sync=inside, spans=site["spans"],
             message=site["message"])
    emit(study="sync_total", cell=args.cell,
         warned=sum(s["n"] for s in sites.values()),
         host_sync_spans=timer.counts.get(timing.HOST_SYNC, 0))

    timer = timer_cls(trace=True, device=bench.device)
    prof = tracing.start()
    drive(bench, args.seed, timer, calls=1)
    prof.stop()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        overlay = os.path.join(d, "overlay.json")
        timer.export(overlay, profiler_trace=path)
        with open(overlay) as f:
            laid = len(json.load(f)["traceEvents"]) - len(doc["traceEvents"])
    base = int(doc["baseTimeNanoseconds"])
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = base + round(float(e["ts"]) * 1e3)
            ranges.setdefault(e["name"], []).append(
                (a, a + round(float(e["dur"]) * 1e3)))
    for v in ranges.values():
        v.sort()
    # a span holds its range: each gap is ≥ 0 when it does
    used, gaps, missing = {}, [], 0
    for s in timer.spans:
        i = used.get(s.name, 0)
        used[s.name] = i + 1
        if i >= len(ranges.get(s.name, ())):
            missing += 1
            continue
        a, b = ranges[s.name][i]
        gaps += [(a - s.start_ns, s.name, "start"),
                 (s.end_ns - b, s.name, "end")]
    widest = max(gaps, key=lambda g: abs(g[0]))
    emit(study="clock", cell=args.cell, spans=len(timer.spans),
         without_range=missing, largest_gap_us=abs(widest[0]) / 1e3,
         widest=[widest[0] / 1e3, widest[1], widest[2]],
         gaps_under_0=sum(g < 0 for g, _, _ in gaps),
         overlay_events_added=laid)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--study", required=True,
                   choices=("window", "cost", "check"))
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--slow", type=float, default=1.3)
    p.add_argument("--out", default=os.path.join(ROOT, "output", "spans"))
    args = p.parse_args(argv)
    cell = registry.find_cell(args.cell)
    cli.set_cache_dirs()
    from morfem_tpu_torch import PhaseTimer

    bench = cli.Bench(cell, "cuda")
    try:
        bench.setup()
        emit(study="card", card=cli.power_limit())
        {"window": study_window, "cost": study_cost,
         "check": study_check}[args.study](bench, args, PhaseTimer)
    finally:
        bench.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
