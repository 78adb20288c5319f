"""Phase timing — named wall-clock buckets that wait for the device.

Counterpart of `morfem_tpu/utils/timing.py`. PyTorch returns before the
card finishes, so an enabled phase on the card synchronises it before it
starts and before it ends: the bucket then holds device completion, not
the time to enqueue, as the reference's phases do by blocking on their
outputs. The card synchronised is ``device`` when one is given, else the
current CUDA device once CUDA is initialised; a disabled timer
synchronises nothing.

``trace=True`` wraps each phase in `torch.profiler.record_function` (a
range in a `torch.profiler` trace, on the CPU and on the card) and, where
CUDA is available, in an NVTX range (Nsight Systems) — the counterpart of
the reference's `jax.profiler.TraceAnnotation`. With no profiler
recording, both cost next to nothing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseTimer:
    """Accumulates named wall-clock phase buckets.

    Usage::

        timer = PhaseTimer()
        with timer.phase("offline"):
            ...
        print(timer.report())
    """

    def __init__(self, disabled: bool = False, trace: bool = False, *,
                 device=None):
        self.times: Dict[str, float] = {}
        self.disabled = disabled
        self.trace = trace
        self.device = torch.device(device) if device is not None else None
        self._start = time.perf_counter()

    def _sync(self):
        if self.device is None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ranges(self, name: str):
        stack = contextlib.ExitStack()
        if self.trace:
            stack.enter_context(torch.profiler.record_function(name))
            if torch.cuda.is_available():
                stack.enter_context(torch.cuda.nvtx.range(name))
        return stack

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.disabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with self._ranges(name):
            yield
            self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def add(self, name: str, seconds: float):
        self.times[name] = self.times.get(name, 0.0) + seconds

    def total(self) -> float:
        """Wall time since construction ('Whole' in the reference)."""
        return time.perf_counter() - self._start

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.times)
        d["whole"] = self.total()
        return d

    def report(self) -> str:
        """Reference-style text report: seconds and % of whole."""
        whole = self.total()
        lines = [f"whole: {whole:.3f} s | 100.00%"]
        for name, t in self.times.items():
            pct = 100.0 * t / whole if whole > 0 else 0.0
            lines.append(f"{name}: {t:.3f} s | {pct:.2f}%")
        return "\n".join(lines)
