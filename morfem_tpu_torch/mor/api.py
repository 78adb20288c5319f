"""Public API: ``morfem()`` and the builder it wraps (dense real route).

Counterpart of `morfem_tpu/mor/api.py` with the same call contract

    morfem(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b)
        -> (x, q, a0_r, a1_r, a2_r, b_r)

the same defaults (t_a0 = 1, t_a1 = t, t_a2 = t², t_b = t) and shapes
(x [I, Nr, M], q [N, Nr], a*_r [Nr, Nr], b_r [Nr, M]), plus a ``device``
(default ``"cuda"``). Real systems take the dense route, or, for
SciPy-sparse operators with N > ``config.dense_cutoff``, the matrix-free
route (`_morfem_matfree`: RCM-banded direct snapshot solves, or the
general-sparsity route after a `BandwidthError`). Complex systems raise
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
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.system import (
    AffineSystem,
    _coefficients,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)
from morfem_tpu_torch.utils.timing import PhaseTimer


def _warn_if_unconverged(result: GreedyResult) -> None:
    """Warn when the greedy loop stopped short of its error threshold.

    A failed snapshot solve (matrix-free greedy, ``failed_snapshot``) gets
    its own warning: more iterations cannot help there.
    """
    if result.converged:
        return
    if result.failed_snapshot:
        warnings.warn(
            "morfem(): greedy basis construction ABORTED after "
            f"{result.iterations} estimator evaluations because a "
            "seed/snapshot solve did not reach an acceptable residual "
            "(see the preceding snapshot-solver warnings for the failing "
            "point and residual). The returned reduced model is the best "
            "basis found; raising config.max_greedy_iterations will NOT "
            "help — improve the snapshot solver instead (e.g. "
            "config.band_max_half, Krylov settings, or conditioning of "
            "the system near the failing point).",
            stacklevel=3,
        )
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


def _reject_complex(a0, a1, a2, b) -> None:
    import scipy.sparse as sp

    for x in (a0, a1, a2, b):
        data = x.data if sp.issparse(x) else x
        if (data.is_complex() if isinstance(data, torch.Tensor)
                else np.iscomplexobj(data)):
            raise NotImplementedError(
                "complex systems are ported in slice 3 of the PyTorch port"
            )


def _reject_complex_coefficients(domain, fns, t_b) -> None:
    c, cb = _coefficients(fns, t_b, domain[:1])
    if c.is_complex() or cb.is_complex():
        raise NotImplementedError(
            "complex coefficients are ported in slice 3 of the PyTorch port"
        )


def _morfem_matfree(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b, config,
                    timer, device):
    """Matrix-free `morfem()` for large sparse systems (same contract).

    Operator selection as in the reference: RCM-reordered banded direct
    solves when the sparsity is band-recoverable (`banded_via_rcm`), else
    (`BandwidthError`) the exact operator with the truncated-band shifted
    preconditioner (`truncated_band_via_rcm` → `GeneralSparseOperator`).
    The returned q is in the CALLER's row order.
    """
    import scipy.sparse as sp

    from morfem_tpu_torch.mor.equally import seed_indices
    from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
    from morfem_tpu_torch.ops.block_tridiag import (
        BandwidthError,
        banded_via_rcm,
        truncated_band_via_rcm,
    )
    from morfem_tpu_torch.ops.sparse import (
        GeneralSparseOperator,
        sparse_project,
        sparse_snapshot_basis,
    )

    dev = resolve_device(device)
    domain = torch.as_tensor(domain, device=dev)
    b = torch.as_tensor(b.toarray() if sp.issparse(b) else b, device=dev)
    if b.ndim == 1:
        b = b[:, None]
    mats = [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
            for m in (a0, a1, a2)]
    with timer.phase("operator setup"):
        try:
            op, perm = banded_via_rcm(
                *mats, symmetrize=config.symmetrize,
                max_half=config.band_max_half, device=dev,
            )
        except BandwidthError:
            # non-band-recoverable sparsity: exact applies with the
            # truncated-band shifted-direct preconditioner; only the
            # bandwidth rejection lands here
            exact_op, band_op, perm, dropped = truncated_band_via_rcm(
                *mats, symmetrize=config.symmetrize,
                band_half=config.band_max_half, device=dev,
            )
            op = GeneralSparseOperator(exact_op, band_op, dropped=dropped)
        b_op = b[perm]
    with timer.phase("projection base"):
        if config.use_equally_distributed:
            idx = seed_indices(int(domain.shape[0]), config)
            q_op = sparse_snapshot_basis(
                mats, b_op, domain, idx, (t_a0, t_a1, t_a2, t_b),
                config=config, op=op,
            )
            p = perm.cpu().numpy()
            pmats = [m.tocsr()[p][:, p] for m in mats]
            (r0, r1, r2), b_r = sparse_project(pmats, b_op, q_op)
            rm = ReducedModel(
                domain=domain, q=q_op, r0=r0, r1=r1, r2=r2, b_r=b_r,
                ncols=q_op.shape[1], t_a0=t_a0, t_a1=t_a1, t_a2=t_a2,
                t_b=t_b,
            )
        else:
            gres, rm = greedy_basis_matfree(
                op, b_op, domain, t_a0, t_a1, t_a2, t_b, config=config,
            )
            _warn_if_unconverged(gres)
    rm = rm.trim()
    q_out = torch.zeros_like(rm.q)
    q_out[perm] = rm.q
    with timer.phase("reduced sweep"):
        x = _run_sweep(rm, config)
    return x, q_out, rm.r0, rm.r1, rm.r2, rm.b_r


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
    by Galerkin projection onto a snapshot basis. Operators are real
    arrays, tensors or SciPy sparse matrices: sparse ones with
    N > ``config.dense_cutoff`` stay matrix-free end to end, smaller
    ones are densified. Coefficient callables act elementwise on a tensor
    of points. Returns (x, q, a0_r, a1_r, a2_r, b_r) as tensors on
    `device`, padding trimmed; q is in the caller's row order.
    """
    import scipy.sparse as sp

    _reject_complex(a0, a1, a2, b)
    timer = timer or PhaseTimer(disabled=True)
    if (any(sp.issparse(x) for x in (a0, a1, a2))
            and a0.shape[0] > config.dense_cutoff):
        _reject_complex_coefficients(torch.as_tensor(domain),
                                     (t_a0, t_a1, t_a2), t_b)
        return _morfem_matfree(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b,
                               config, timer, device)
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
