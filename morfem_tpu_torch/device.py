"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default: the port is written for an
NVIDIA card, and the CPU runs only when the caller asks for it (the tests
do). A CUDA request without a visible card raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "morfem_tpu_torch: CUDA was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
