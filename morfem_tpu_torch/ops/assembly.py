"""System-matrix / impulse-vector assembly over a batch of points.

Counterpart of `morfem_tpu/ops/assembly.py`: ``A(t) = Σᵢ cᵢ·Aᵢ`` with the
reference's ``(A + Aᵀ)/2`` symmetrization, and ``b(t) = t_b(t)·B``, for a
whole batch of points as one tensor expression.
"""

from __future__ import annotations

from typing import Tuple

import torch

from morfem_tpu_torch.system import AffineSystem


def system_matrix(ops, c: torch.Tensor, symmetrize: bool = True):
    """Assemble [..., N, N] matrices from the three addends and c [..., 3]."""
    a0, a1, a2 = ops
    c = c[..., None, None]
    a = c[..., 0, :, :] * a0 + c[..., 1, :, :] * a1 + c[..., 2, :, :] * a2
    if symmetrize:
        a = (a + a.transpose(-1, -2)) * 0.5
    return a


def impulse_vector(b: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """b(t) = t_b(t)·B for a batch of points: [..., N, M]."""
    return cb[..., None, None] * b


def assemble_at(
    sys: AffineSystem, t, symmetrize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A(t), b(t)) at a scalar point or a batch of points.

    Skips the transpose-add when the operators were verified exactly
    symmetric at construction (it is then a bit-exact no-op).
    """
    c, cb = sys.coefficients(t)
    a = system_matrix(
        sys.operators(), c, symmetrize=symmetrize and not sys.symmetric_ops
    )
    return a, impulse_vector(sys.b, cb)
