"""Public API: ``morfem()`` and the builder it wraps (dense real route).

Counterpart of `morfem_tpu/mor/api.py` with the same call contract

    morfem(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b)
        -> (x, q, a0_r, a1_r, a2_r, b_r)

the same defaults (t_a0 = 1, t_a1 = t, t_a2 = t², t_b = t) and shapes
(x [I, Nr, M], q [N, Nr], a*_r [Nr, Nr], b_r [Nr, M]), plus a ``device``
(default ``"cuda"``). This slice ports the dense real route; SciPy-sparse
operators (the matrix-free route) and complex systems raise
`NotImplementedError` naming the slice that ports them.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.equally import equally_distributed_basis
from morfem_tpu_torch.mor.greedy import GreedyResult, greedy_basis
from morfem_tpu_torch.mor.reduced import ReducedModel, project, sweep
from morfem_tpu_torch.system import (
    AffineSystem,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)
from morfem_tpu_torch.utils.timing import PhaseTimer


def _warn_if_unconverged(result: GreedyResult) -> None:
    """Warn when the greedy loop stopped short of its error threshold."""
    if result.converged:
        return
    warnings.warn(
        "morfem(): greedy basis construction stopped after "
        f"{result.iterations} estimator evaluations WITHOUT reaching the "
        "error threshold (column budget exhausted, or refinement "
        "stagnated). The returned reduced model is the best basis found; "
        "raise config.max_greedy_iterations or relax "
        "config.error_threshold to converge.",
        stacklevel=3,
    )


def build_reduced_model(
    sys: AffineSystem,
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
) -> Tuple[ReducedModel, Optional[GreedyResult]]:
    """Build the projection basis and project the system.

    Returns the padded ReducedModel and, for the greedy strategy, the
    GreedyResult with the error history.
    """
    timer = timer or PhaseTimer(disabled=True)
    greedy_result = None
    with timer.phase("projection base"):
        if config.use_equally_distributed:
            q = equally_distributed_basis(sys, config)
            ncols = q.shape[1]
        else:
            greedy_result = greedy_basis(sys, config)
            q, ncols = greedy_result.q, greedy_result.ncols
    if greedy_result is not None:
        _warn_if_unconverged(greedy_result)
    with timer.phase("projection"):
        rm = project(sys, q, ncols)
    return rm, greedy_result


def _run_sweep(rm: ReducedModel, config: MorfemConfig):
    """Final sweep per `config.sweep_method`: "auto" tries the two-term
    diagonalization, then the quadratic one, then batched LU."""
    if config.sweep_method == "lu":
        return sweep(rm, config)
    from morfem_tpu_torch.mor.spectral import (
        prepare_spectral,
        prepare_spectral_quadratic,
        spectral_sweep,
        spectral_sweep_quadratic,
    )

    try:
        return spectral_sweep(prepare_spectral(rm, config))
    except ValueError:
        if config.sweep_method == "spectral":
            raise
    try:
        return spectral_sweep_quadratic(prepare_spectral_quadratic(rm, config))
    except ValueError:
        return sweep(rm, config)


def _reject_unported(a0, a1, a2, b) -> None:
    import scipy.sparse as sp

    if any(sp.issparse(x) for x in (a0, a1, a2, b)):
        raise NotImplementedError(
            "SciPy-sparse operators take the matrix-free route, ported in "
            "slice 2 of the PyTorch port; pass dense arrays"
        )
    for x in (a0, a1, a2, b):
        if (x.is_complex() if isinstance(x, torch.Tensor)
                else np.iscomplexobj(x)):
            raise NotImplementedError(
                "complex systems are ported in slice 3 of the PyTorch port"
            )


def morfem(
    domain,
    a0,
    a1,
    a2,
    b,
    t_a0=_default_t_a0,
    t_a1=_default_t_a1,
    t_a2=_default_t_a2,
    t_b=_default_t_b,
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
    device="cuda",
):
    """Solve the parametric problem via model order reduction.

    Solves (t_a0·a0 + t_a1·a1 + t_a2·a2)·x = t_b·b over the whole domain
    by Galerkin projection onto a snapshot basis. Operators are dense
    real arrays or tensors; coefficient callables act elementwise on a
    tensor of points. Returns (x, q, a0_r, a1_r, a2_r, b_r) as tensors on
    `device`, padding trimmed.
    """
    _reject_unported(a0, a1, a2, b)
    timer = timer or PhaseTimer(disabled=True)
    sys = AffineSystem.create(
        domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b, device=device
    )
    if sys.b.is_complex() or sys.coefficients(sys.domain[:1])[0].is_complex():
        raise NotImplementedError(
            "complex coefficients are ported in slice 3 of the PyTorch port"
        )
    rm, _ = build_reduced_model(sys, config, timer)
    rm = rm.trim()
    with timer.phase("reduced sweep"):
        x = _run_sweep(rm, config)
    return x, rm.q, rm.r0, rm.r1, rm.r2, rm.b_r
