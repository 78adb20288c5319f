"""Equally-distributed projection-basis construction.

Counterpart of `morfem_tpu/mor/equally.py`: ``floor(I·(1 − rate))`` evenly
spaced domain indices, a full-order snapshot at each, the solution columns
stacked and orthonormalized by thin SVD.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.ops.orthonormalize import orthonormalize_svd
from morfem_tpu_torch.ops.solve import solve_batch
from morfem_tpu_torch.system import AffineSystem


def seed_indices(
    num_points: int, config: MorfemConfig, count: Optional[int] = None
) -> np.ndarray:
    """Evenly spaced seed indices: ``np.linspace(0, I-1, count)`` truncated
    toward zero, as the reference does."""
    if count is None:
        count = math.floor(
            num_points * (1 - config.equally_distributed_reduction_rate)
        )
    count = max(1, min(count, num_points))
    return np.linspace(0, num_points - 1, count).astype(int)


def equally_distributed_basis(
    sys: AffineSystem,
    config: MorfemConfig = DEFAULT_CONFIG,
    count: Optional[int] = None,
) -> torch.Tensor:
    """Orthonormal basis [N, count·M] from evenly spaced snapshots."""
    idx = torch.as_tensor(seed_indices(sys.num_points, config, count),
                          device=sys.device)
    xs = solve_batch(sys, sys.domain[idx], config)  # [S, N, M]
    q = xs.transpose(0, 1).reshape(sys.n, -1)
    return orthonormalize_svd(q)
