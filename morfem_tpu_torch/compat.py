"""The reference library's names, and state carried across as NumPy.

Counterpart of `morfem_tpu/compat.py`: users of the reference import
`morfem`, `ModelDefinition`, `solve_finite_element_method` and
`TimeStatistics` from ``implementation.py``; this module gives the same
names and call contracts (plus a ``device``), so reference scripts port
with an import change:

    from morfem_tpu_torch.compat import (
        morfem, ModelDefinition, solve_finite_element_method, TimeStatistics,
    )

* `morfem(...)` returns NumPy arrays ``(x, q, a0_r, a1_r, a2_r, b_r)``.
* `ModelDefinition(...)` builds an immutable AffineSystem (the reference
  mutates its instance during reduction).
* `solve_finite_element_method(md)` is the full-order sweep as a NumPy
  [I, N, M] cube, in the inputs' dtype (the reference's real float64 cube
  drops a complex solution's imaginary part).
* `TimeStatistics` keeps its buckets per instance (the reference's dict
  is class-level, shared by every instance).

`system_from_numpy` and `reduced_model_from_numpy` take the arrays of a
`morfem_tpu` AffineSystem or ReducedModel (converted with ``np.asarray``)
and return the port's objects on a device, so one state can be fed to both
packages. Nothing here imports the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.api import morfem as _morfem
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.ops.solve import solve_sweep
from morfem_tpu_torch.system import (
    AffineSystem,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)

__all__ = [
    "morfem",
    "ModelDefinition",
    "solve_finite_element_method",
    "TimeStatistics",
    "system_from_numpy",
    "reduced_model_from_numpy",
]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def morfem(
    domain, a0, a1, a2, b,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, config: MorfemConfig = DEFAULT_CONFIG, device="cuda",
):
    """Reference-compatible entry point; returns NumPy arrays
    ``(x [I,Nr,M], q [N,Nr], a0_r, a1_r, a2_r, b_r)``."""
    out = _morfem(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b,
                  config=config, device=device)
    return tuple(_host(o) for o in out)


def ModelDefinition(
    domain, a0, a1, a2, b,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, device="cuda",
) -> AffineSystem:
    """Reference-compatible constructor of the system definition."""
    return AffineSystem.create(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b,
                               device=device)


def solve_finite_element_method(
    md: AffineSystem, config: MorfemConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Full-order sweep as a NumPy [I, N, M] cube."""
    return _host(solve_sweep(md, config))


class TimeStatistics:
    """Reference-style wall-clock buckets (start_clock / add_time /
    add_custom_time / print_statistics), with per-instance state."""

    def __init__(self):
        self.times = {"Whole": 0.0}
        self.clock = 0.0

    def start_clock(self):
        self.clock = time.time()

    def add_time(self, time_name: str):
        if time_name not in self.times:
            self.times[time_name] = 0.0
        now = time.time()
        self.times[time_name] += now - self.clock
        self.clock = now

    def add_custom_time(self, time_name: str, custom_clock: float):
        self.times[time_name] += time.time() - custom_clock

    def print_statistics(self):
        whole = self.times.get("Whole", 0.0)
        for name, t in self.times.items():
            pct = (t / whole * 100) if whole else 0.0
            print(f"{name}: {round(t, 2)} s | {round(pct, 2)}%")


def system_from_numpy(
    domain, a0, a1, a2, b,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, device="cuda",
) -> AffineSystem:
    """AffineSystem from NumPy arrays (domain, a0, a1, a2, b)."""
    return AffineSystem.create(
        np.asarray(domain), np.asarray(a0), np.asarray(a1), np.asarray(a2),
        np.asarray(b), t_a0, t_a1, t_a2, t_b, device=device,
    )


def reduced_model_from_numpy(
    d: dict,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, device="cuda",
) -> ReducedModel:
    """ReducedModel from a mapping with keys domain, q, r0, r1, r2, b_r and
    ncols (NumPy arrays; ncols a scalar)."""
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(d[name]), device=dev)

    return ReducedModel(
        domain=t("domain"), q=t("q"), r0=t("r0"), r1=t("r1"), r2=t("r2"),
        b_r=t("b_r"), ncols=int(np.asarray(d["ncols"])), t_a0=t_a0,
        t_a1=t_a1, t_a2=t_a2, t_b=t_b,
    )
