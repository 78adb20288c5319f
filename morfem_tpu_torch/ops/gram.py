"""Gram-block utilities — counterpart of `morfem_tpu/ops/gram.py`.

The reference's incremental USE_OPM Gram expansion is off the hot path
(the estimator recomputes from U_p = A_p·Q); it is kept for host-side
analysis of growing bases.
"""

from __future__ import annotations

import torch


def hermitian(a: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate over the last two axes."""
    if a.ndim < 2:
        raise ValueError("array has to be at least two-dimensional")
    return a.conj().transpose(-1, -2)


def expand_gram_matrix(original, old_q, middle, new_q) -> torch.Tensor:
    """Grow QᴴMQ to [Q, Q_new]ᴴ·M·[Q, Q_new] without recomputing it."""
    dt = original.dtype
    for x in (old_q, middle, new_q):
        dt = torch.promote_types(dt, x.dtype)
    original, old_q, middle, new_q = (
        x.to(dt) for x in (original, old_q, middle, new_q)
    )
    top_right = hermitian(old_q) @ (middle @ new_q)
    bottom_left = hermitian(new_q) @ (middle @ old_q)
    bottom_right = hermitian(new_q) @ (middle @ new_q)
    top = torch.cat([original, top_right], dim=1)
    bottom = torch.cat([bottom_left, bottom_right], dim=1)
    return torch.cat([top, bottom], dim=0)
