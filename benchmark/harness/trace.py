"""The traced run: `torch.profiler` over a bounded number of calls, and
the reduction of its trace to device busy time, per-range busy time, the
heaviest device operations and the host's share of the idle gaps.

The arithmetic (the union of kernel, memcpy and memset intervals clipped
to a range; kernels summed by function name) follows the port's
``chip_smoke.py`` trace phase, with the union merged once. The trace is
exported under ``TMPDIR``, its size logged, read back and deleted before
the run goes on. (The card's PyTorch gives its in-memory events no
category, so the export is the one way to read them.)
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Tuple

CALL = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def start():
    """A started profiler of the CPU and, where there is one, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def symbol(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    and parameters (the whole name where that leaves nothing)."""
    short = re.sub(r"<.*|\(.*", "", name.replace("(anonymous namespace)::",
                                                 "")).split(" ")[-1]
    return short.split("::")[-1] or name


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # first traced call's start to the last one's end
    busy_s: float  # union of device intervals inside it
    calls: int
    range_busy_s: Dict[str, float]  # by range name, summed over its ranges
    range_count: Dict[str, int]
    device_ops: List[Tuple[str, float]]  # heaviest, seconds
    idle_gaps: List[Tuple[str, float]]  # by what the host was doing


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(merged, starts, a, b) -> float:
    """Length of [a, b] covered by the sorted disjoint intervals `merged`
    (`starts`: their starts)."""
    total = 0.0
    for s, e in merged[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def _host_labels(host, points):
    """For each time in `points` (sorted), what the host thread was doing:
    its innermost annotated range and innermost operation."""
    host = sorted(host, key=lambda x: (x[0], -x[1]))
    stack, labels, j = [], [], 0
    for p in points:
        while j < len(host) and host[j][0] <= p:
            s, e, name, cat = host[j]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name, cat))
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        live = [x for x in stack if x[0] <= p <= x[1]]
        phase = next((x[2] for x in reversed(live)
                      if x[3] == "user_annotation" and x[2] != CALL), None)
        op = live[-1][2] if live and live[-1][2] not in (CALL, phase) \
            else None
        parts = [x for x in (phase, op) if x]
        labels.append(" > ".join(parts) if parts else "host code")
    return labels


def summarize(events) -> TraceSummary:
    """Reduce chrome-trace events (``traceEvents``) to a TraceSummary."""
    xs = [e for e in events if e.get("ph") == "X"]

    def span(e):
        s = float(e["ts"])
        return s, s + float(e.get("dur", 0.0))

    device = [(*span(e), symbol(e["name"]) if e["cat"] == "kernel"
               else e["name"]) for e in xs if e.get("cat") in DEVICE_CATS]
    calls = [(*span(e), e.get("tid")) for e in xs
             if e.get("cat") == "user_annotation" and e["name"] == CALL]
    if not calls:
        return TraceSummary(0.0, 0.0, 0, {}, {}, [], [])
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    spans = [(s, e) for s, e, _ in device]
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"] != CALL:
            ranges.setdefault(e["name"], []).append(span(e))
    ops: Dict[str, float] = {}
    for s, e, name in device:
        if lo <= s < hi:
            ops[name] = ops.get(name, 0.0) + (e - s)
    union = _union(spans)
    starts = [s for s, _ in union]
    merged = [iv for iv in union if iv[1] > lo and iv[0] < hi]
    gaps, reach = [], lo
    for s, e in merged:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    tid = calls[0][2]
    host = [(*span(e), e["name"], e.get("cat")) for e in xs
            if e.get("cat") in HOST_CATS and e.get("tid") == tid]
    gaps.sort(key=lambda g: (g[0] + g[1]) / 2)
    labels = _host_labels(host, [(a + b) / 2 for a, b in gaps])
    idle: Dict[str, float] = {}
    for (a, b), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (b - a)

    def top(d):
        return [(k, v / 1e6) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=_overlap_us(union, starts, lo, hi) / 1e6,
        calls=len(calls),
        range_busy_s={k: sum(_overlap_us(union, starts, a, b)
                             for a, b in v) / 1e6
                      for k, v in ranges.items()},
        range_count={k: len(v) for k, v in ranges.items()},
        device_ops=top(ops),
        idle_gaps=top(idle),
    )


def reduce(prof, log) -> TraceSummary:
    """Export the stopped `prof`'s trace under TMPDIR, summarise it and
    delete the export."""
    folder = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        log(f"trace export: {os.path.getsize(path)} bytes under {folder}")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return summarize(events)
