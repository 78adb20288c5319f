"""Equally-distributed projection-basis construction.

Counterpart of `morfem_tpu/mor/equally.py`: ``floor(I·(1 − rate))`` evenly
spaced domain indices, a full-order snapshot at each, the solution columns
stacked and orthonormalized by thin SVD.

`matfree_seed_basis` builds the same basis on a prepared sparse pencil
(`mor/api.py::MatfreeSystem`): on the banded route the seeds are solved
together by the banded full-order sweep (`solve_sweep_banded`).
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
from morfem_tpu_torch.utils.timing import span


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


def matfree_seed_basis(sys, config: MorfemConfig = DEFAULT_CONFIG
                       ) -> torch.Tensor:
    """Orthonormal basis [N, S·M] of a prepared `MatfreeSystem`, in its
    operator's row order, from the S seeds `seed_indices` picks.

    A banded operator solves the seeds together: the banded full-order
    sweep on the seed points (`solve_sweep_banded` on
    ``sys.with_domain(seeds)``: chunks of ``config.solve_chunk`` points,
    the f32 block-Thomas factor with the point axis batched, f64
    refinement of each chunk, its escalation and its counters), then the
    thin SVD of the stacked solutions. A `GeneralSparseOperator` (the
    GMRES route) solves them one at a time (`sparse_snapshot_basis`).

    Under a trace-mode `PhaseTimer` the seed solves and their SVD are an
    ``equally.solve`` span. Appends S to ``matfree_seed_basis.seeds``;
    `reset_matfree_seed_counters` empties it.
    """
    from morfem_tpu_torch.ops.block_tridiag import solve_sweep_banded
    from morfem_tpu_torch.ops.sparse import sparse_snapshot_basis

    idx = seed_indices(int(sys.domain.shape[0]), config)
    matfree_seed_basis.seeds.append(len(idx))
    with span("equally.solve"):
        if not hasattr(sys.op, "bands_w"):
            return sparse_snapshot_basis(
                sys.mats, sys.b, sys.domain, idx,
                (sys.t_a0, sys.t_a1, sys.t_a2, *sys.t_extra, sys.t_b),
                config=config, op=sys.op,
            )
        seeds = torch.as_tensor(idx, device=sys.domain.device)
        x = solve_sweep_banded(sys.with_domain(sys.domain[seeds]),
                               config)[:, sys.perm]
        return orthonormalize_svd(x.transpose(0, 1).reshape(sys.n, -1))


def reset_matfree_seed_counters() -> None:
    """Empty ``matfree_seed_basis.seeds``."""
    matfree_seed_basis.seeds = []


reset_matfree_seed_counters()
