"""One run of one cell: set-up, the measured window, the traced run's
reading, the check against the plain reference, and the result line.

``main`` refuses to run without the card the cell asks for; `Bench` and
`execute` take any device, so the CPU tests walk the same path.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np

from benchmark.harness import guard, registry, traffic
from benchmark.harness import trace as tracing

# every build and kernel cache of the program, at fixed paths inside the
# checkout, so that only a checkout's first run builds
CACHE_ENV = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH",
             "TORCHINDUCTOR_CACHE_DIR")
CACHE_ROOT = registry.BENCH_DIR / "_cache"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def set_cache_dirs():
    for name in CACHE_ENV:
        path = CACHE_ROOT / name.lower()
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernels_built() -> bool:
    """Whether the program's kernel library is already built in this
    checkout (``morfem_tpu_torch/_build/<hash>/``)."""
    build = registry.ROOT / "morfem_tpu_torch" / "_build"
    return any(build.glob("*/libmorfem_kernels.so"))


@dataclasses.dataclass
class Window:
    seed: int
    seconds: float
    attempted: int = 0
    failed: int = 0
    calls: int = 0  # completed, the window closing at a call boundary
    served: int = 0  # answered
    window_s: float = 0.0
    call_s: List[float] = dataclasses.field(default_factory=list)
    kept: List[Any] = dataclasses.field(default_factory=list)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[tracing.TraceSummary] = None


@dataclasses.dataclass
class Records:
    """What a metric reader reads."""

    setup_s: float
    window: Window
    cell: registry.Cell
    device_kind: str


class Bench:
    """A cell's program under test on `device`: its inputs, set-up and
    windows, and the check of what a window produced."""

    def __init__(self, cell: registry.Cell, device="cuda", log=log):
        import torch

        self.cell, self.log = cell, log
        self.device = torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.tmpdir = tempfile.mkdtemp(prefix="bench_")
        self.state = None

    def morfem_config(self):
        from morfem_tpu_torch import MorfemConfig

        return MorfemConfig(**{**self.config.get("morfem", {}),
                               **self.traffic.get("morfem", {})})

    def setup(self):
        """Inputs, the driver's set-up and its warm-up calls."""
        t0 = time.perf_counter()
        self.inputs = self.cell.config_mod.make_inputs(self.config,
                                                       registry.ROOT)
        t1 = time.perf_counter()
        self.state = self.cell.op.setup(self)
        sync(self.device)
        t2 = time.perf_counter()
        for req in traffic.warmup_requests(self.traffic):
            self.cell.op.call(self, self.state, req, None)
        sync(self.device)
        self.log(f"set-up: inputs {t1 - t0:.3f} s, program {t2 - t1:.3f} s, "
                 f"warm-up {time.perf_counter() - t2:.3f} s")

    def _call(self, req, timer, win):
        win.attempted += 1
        try:
            ans = self.cell.op.call(self, self.state, req, timer)
            sync(self.device)
            return ans
        except Exception:
            win.failed += 1
            if win.failed == 1:
                self.log("call failed:\n" + traceback.format_exc())
            return None

    def window(self, seed: int, seconds: float, traced: bool) -> Window:
        """Drive the entry for `seconds` with the mix's requests for
        `seed`, one caller, closing at the first call boundary past
        `seconds`; in a traced run with the program's `PhaseTimer` and
        the profiler over the first ``trace_calls`` calls (the cell's)."""
        import torch
        from morfem_tpu_torch import PhaseTimer

        win = Window(seed, seconds)
        timer = PhaseTimer(trace=True, device=self.device) if traced else None
        op = self.cell.op
        if hasattr(op, "reset_counters"):
            op.reset_counters(self)
        prof = tracing.start() if traced else None
        profiled, limit = 0, int(self.cell.spec["trace_calls"])
        rng = np.random.default_rng([int(seed), 1])
        keep = int(self.cell.spec["sample"]["calls"])
        stopped = []

        def serve(req):
            nonlocal prof, profiled
            if prof is None:
                return self._call(req, timer, win)
            with torch.profiler.record_function(tracing.CALL):
                ans = self._call(req, timer, win)
            profiled += 1
            if profiled == limit:
                prof.stop()
                stopped.append(prof)
                prof = None
            return ans

        t0 = time.perf_counter()
        for req in traffic.requests(self.traffic, seed):
            start = time.perf_counter() - t0
            ans = serve(req)
            end = time.perf_counter() - t0
            win.call_s.append(end - start)
            win.calls += 1
            win.window_s = end
            if ans is not None:
                win.served += 1
                # a reservoir sample of the answers, drawn from the seed
                if len(win.kept) < keep:
                    win.kept.append((req, ans))
                else:
                    j = int(rng.integers(0, win.served))
                    if j < keep:
                        win.kept[j] = (req, ans)
            if end >= seconds:
                break
        if prof is not None:
            prof.stop()
            stopped.append(prof)
        if timer is not None:
            win.phases.update(timer.times)
        if hasattr(op, "counters"):
            win.counters.update(op.counters(self))
        if stopped:
            t1 = time.perf_counter()
            win.trace = tracing.reduce(stopped[0], self.log)
            self.log(f"trace read in {time.perf_counter() - t1:.1f} s")
        return win

    def program_values(self, win: Window):
        """[(request, point indices, values)] of the sampled answers, on
        the host; every point of an answer up to the cell's
        ``sample.points`` per answer, drawn from the seed."""
        rng = np.random.default_rng([int(win.seed), 2])
        most = int(self.cell.spec["sample"]["points"])
        out = []
        for req, ans in win.kept:
            n = req.points
            idx = (np.arange(n) if n <= most else
                   np.sort(rng.choice(n, size=most, replace=False)))
            try:
                vals = ans.values(idx, n)
            except (IndexError, RuntimeError, ValueError) as e:
                self.log(f"answer to request {req.index} unreadable: {e}")
                vals = None
            out.append((req, idx, vals))
        return out

    def compare(self, sampled, control: bool = False) -> Dict[str, float]:
        """Each number the check compares: the widest gap between the
        program's values (with `control`, the reference's in the next
        lower precision put in their place) and the reference's."""
        mod, cfg = self.cell.config_mod, self.config
        worst: Dict[str, float] = {}
        for req, idx, vals in sampled:
            freqs = req.freqs()[idx]
            kind, ref = mod.reference(cfg, freqs, "float64", self.device,
                                      self.inputs_for_reference())
            if control:
                _, vals = mod.reference(cfg, freqs, "float32", self.device,
                                        self.inputs_for_reference())
            worst[kind] = max(worst.get(kind, 0.0), gap(kind, vals, ref))
        return worst

    def inputs_for_reference(self):
        if getattr(self, "_ref_inputs", None) is None:
            self._ref_inputs = self.cell.config_mod.make_inputs(
                self.config, registry.ROOT)
        return self._ref_inputs

    def free(self):
        """Drop the program's state and inputs and give the card's memory
        back."""
        import torch

        self.state = None
        self.inputs = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def gap(kind: str, vals, ref) -> float:
    """``gsm_err``: the largest |S − S_ref| of any entry. A missing,
    misshapen or non-finite answer reads infinity."""
    if kind != "gsm_err":
        raise ValueError(f"no comparison named {kind!r}")
    if vals is None or np.shape(vals) != np.shape(ref):
        return math.inf
    vals = np.asarray(vals)
    if not np.all(np.isfinite(vals)):
        return math.inf
    return float(np.max(np.abs(vals - ref)))


def device_info(device, chips: int) -> Dict[str, Any]:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, where it answers."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def read_metrics(cell, rec: Records, traced: bool) -> Dict[str, Any]:
    out = {}
    for m in cell.metrics(traced):
        value = registry.metric_reader(m["name"], cell.bench_dir)(rec)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: registry.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float):
    """One run on `device` → (exit code, result dict or None)."""
    built_before = kernels_built()
    bench = Bench(cell, device)
    log(f"set-up: start to the first input {time.perf_counter() - t_start:.3f}"
        " s (imports, the card)")
    try:
        bench.setup()
        setup_s = time.perf_counter() - t_start
        # a checkout's first run builds the kernels inside its set-up
        built = not built_before and kernels_built()
        log(f"{cell.name}: set-up {setup_s:.3f} s"
            + (", the kernels built in it" if built else ""))
        win = bench.window(seed, seconds, traced)
        log(f"{cell.name}: {win.calls} calls in {win.window_s:.3f} s, "
            f"{win.attempted} attempted, {win.failed} failed")
        if win.call_s:
            q = np.percentile(win.call_s, [0, 50, 100])
            log(f"{cell.name}: a call took {q[0]:.3f} / {q[1]:.3f} / "
                f"{q[2]:.3f} s (least / median / most); in order: "
                + " ".join(f"{x:.3f}" for x in win.call_s[:200]))
        dev = device_info(bench.device, cell.chips)
        found = guard.forbidden_modules()
        if found:
            log(f"forbidden modules loaded: {found}")
            return 1, None
        if traced:
            log(f"card: {power_limit()}")
        metrics = read_metrics(cell, Records(setup_s, win, cell, dev["kind"]),
                               traced)
        sampled = bench.program_values(win)
        win.kept = []
        bench.free()
        t1 = time.perf_counter()
        numbers = bench.compare(sampled)
        log(f"check of {sum(len(i) for _, i, _ in sampled)} points in "
            f"{len(sampled)} answers: {time.perf_counter() - t1:.1f} s")
        limits = {k: float(v["limit"])
                  for k, v in cell.spec["limits"].items()}
        compared = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                    for k, lim in limits.items()}
        correct = (win.failed == 0 and bool(sampled)
                   and all(c["value"] <= c["limit"]
                           for c in compared.values()))
        result = {"correct": correct, "attempted": win.attempted,
                  "failed": win.failed, "metrics": metrics, "device": dev,
                  "setup_built_kernels": built}
        if traced:
            t = win.trace
            result["device"].update(busy_s=t.busy_s if t else 0.0,
                                    window_s=t.window_s if t else 0.0)
            if t:
                result["breakdown"] = {"device_ops": t.device_ops,
                                       "idle_gaps": t.idle_gaps}
        result["compared"] = compared
        found = guard.forbidden_modules()
        if found:
            log(f"forbidden modules loaded: {found}")
            return 1, None
        for k, c in compared.items():
            log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
        return 0, result
    finally:
        bench.close()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = registry.find_cell(args.workload)
    except (registry.UnknownName, KeyError, json.JSONDecodeError) as e:
        log(f"benchmark: {e}")
        return 2
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 1
    try:
        import morfem_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"benchmark: the program is missing: {e}")
        return 1
    rc, result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc
