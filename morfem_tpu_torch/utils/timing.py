"""Phase timing — named wall-clock buckets that wait for the device.

Counterpart of `morfem_tpu/utils/timing.py`. PyTorch returns before the
card finishes, so a phase on a CUDA device ends with
`torch.cuda.synchronize()`: the bucket then holds device completion, not
the time to enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseTimer:
    """Accumulates named wall-clock phase buckets.

    Usage::

        timer = PhaseTimer(device=torch.device("cuda"))
        with timer.phase("offline"):
            ...
        print(timer.report())
    """

    def __init__(self, disabled: bool = False, device=None):
        self.times: Dict[str, float] = {}
        self.disabled = disabled
        self.device = torch.device(device) if device is not None else None
        self._start = time.perf_counter()

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.disabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def add(self, name: str, seconds: float):
        self.times[name] = self.times.get(name, 0.0) + seconds

    def total(self) -> float:
        return time.perf_counter() - self._start

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.times)
        d["whole"] = self.total()
        return d

    def report(self) -> str:
        whole = self.total()
        lines = [f"whole: {whole:.3f} s | 100.00%"]
        for name, t in self.times.items():
            pct = 100.0 * t / whole if whole > 0 else 0.0
            lines.append(f"{name}: {t:.3f} s | {pct:.2f}%")
        return "\n".join(lines)
