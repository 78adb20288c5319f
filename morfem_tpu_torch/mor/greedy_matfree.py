"""Greedy basis construction over MATRIX-FREE operators (large N).

Counterpart of `morfem_tpu/mor/greedy_matfree.py`. The direct residual
estimator only needs operator applications U_p = A_p·Q, which every
large-N operator offers through ``apply_addend`` (banded, block-sparse,
ELL, CSR). A host loop drives it around a padded [N, K] basis with an
active-column count:

  seeds at the domain ends → estimate over the domain → snapshot at the
  worst point → CGS2 append (with the dependency guard) → …

Snapshot solves report their achieved residuals. Two-tier acceptance, as
in the reference: a residual above ``max(100·snapshot_tol, 1e-8)`` first
escalates (banded operators) to the shifted-GMRES solve; a residual then
still above that but within 1e-4 is accepted with a warning (a basis
vector needs span, not solver precision, and the estimator keeps
measuring true residuals); anything worse stops the expansion with
``converged=False`` and ``failed_snapshot=True``.

Under a trace-mode `PhaseTimer` the spans are the dense greedy's: each
pass (a seed snapshot, or an estimate and its snapshot) is a
``greedy.iteration`` holding ``greedy.estimate``, ``greedy.solve`` (with
``greedy.escalate`` around the shifted-GMRES fallback),
``greedy.dependency`` and ``greedy.orthonormalize``, and each read of a
value back to the host is a ``host sync`` (`utils/timing.py`).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.estimator import estimate_errors_direct
from morfem_tpu_torch.mor.greedy import GreedyResult, max_basis_columns
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.ops.orthonormalize import (
    column_mask,
    orthonormalize_append_cgs2,
    orthonormalize_svd,
)
from morfem_tpu_torch.ops.sparse import solve_point_iterative
from morfem_tpu_torch.system import (
    _coefficients,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)
from morfem_tpu_torch.utils.timing import host_read, span


def _reduced_from_u_matfree(domain, q, ncols, u, b, coeffs) -> ReducedModel:
    """Galerkin projection reusing U_p = A_p·Q (plain transpose form);
    addends beyond the classic 3 land in ``r_extra``."""
    t_a0, t_a1, t_a2, *t_extra, t_b = coeffs
    qmt = (q * column_mask(q.shape[1], ncols, q.dtype, q.device)).T
    return ReducedModel(
        domain=domain, q=q, r0=qmt @ u[0], r1=qmt @ u[1], r2=qmt @ u[2],
        b_r=qmt @ b, ncols=int(ncols), t_a0=t_a0, t_a1=t_a1, t_a2=t_a2,
        t_b=t_b, r_extra=tuple(qmt @ u[3 + j] for j in range(len(t_extra))),
        t_extra=tuple(t_extra),
    )


def greedy_basis_matfree(
    op,
    b,
    domain,
    t_a0=_default_t_a0,
    t_a1=_default_t_a1,
    t_a2=_default_t_a2,
    t_b=_default_t_b,
    config: MorfemConfig = DEFAULT_CONFIG,
    snapshot_tol: float = 1e-10,
    snapshot_maxiter: int = 2000,
    method: str = "auto",
    t_extra=(),
) -> Tuple[GreedyResult, ReducedModel]:
    """Greedy MOR basis for a matrix-free affine operator.

    Args:
      op: operator with ``matvec(c, x)``, ``diagonal(c)`` and
        ``apply_addend(p, x)`` (`SparseAffineOperator`,
        `BandedAffineOperator`, `BlockSparseAffineOperator`, …).
      b: [N, M] dense impulse part (moved to op's device).
      domain: [I] parameter grid.
      t_a0..t_b: coefficient callables (defaults 1, t, t², t).
      t_extra: coefficient callables of addends beyond the classic 3.
      config: greedy knobs (threshold, iteration budget,
        dependency_tolerance); the estimator is the direct one.
      snapshot_tol / snapshot_maxiter / method: snapshot-solve settings
        (`ops/sparse.py::solve_point_iterative`); ``"bicgstab"`` on a
        banded or block-sparse operator runs its f32 kernel (K5, K6).

    Returns:
      (GreedyResult, trimmed ReducedModel).
    """
    coeffs = (t_a0, t_a1, t_a2, *t_extra, t_b)
    n_add = 3 + len(t_extra)
    op_n = getattr(op, "n_addends", n_add)
    if op_n != n_add:
        raise ValueError(
            f"operator has {op_n} addends but {n_add} coefficient "
            "callables were given (pass the extras via t_extra)"
        )
    dev = op.device
    b = torch.as_tensor(b, device=dev)
    if b.ndim == 1:
        b = b[:, None]
    dtype = b.dtype
    n, m = b.shape
    domain = torch.as_tensor(domain, device=dev)
    i_pts = int(domain.shape[0])
    k = max_basis_columns(m, config, n)
    max_iters = config.max_greedy_iterations

    def coeff_at(t):
        c, cb = _coefficients(coeffs[:-1], t_b, t)
        return c.to(dtype), cb.to(dtype)

    def snapshot(t):
        c, cb = coeff_at(t)
        return solve_point_iterative(
            op, c, cb * b, tol=snapshot_tol, maxiter=snapshot_maxiter,
            method=method, return_residual=True,
        )

    def snapshot_shifted(t):
        # near-resonance escalation: the σ-shifted factorization's
        # condition is bounded by ~1/σ (f32-safe), and the outer f64 GMRES
        # restores full accuracy
        from morfem_tpu_torch.ops.block_tridiag import shifted_gmres_solve

        c, cb = coeff_at(t)
        return shifted_gmres_solve(op, c, cb * b, tol=snapshot_tol,
                                   maxiter=60)

    def estimate(q, ncols):
        qm = q * column_mask(k, ncols, q.dtype, dev)
        u = torch.stack([op.apply_addend(p, qm) for p in range(n_add)])
        rm = _reduced_from_u_matfree(domain, q, ncols, u, b, coeffs)
        err, _ = estimate_errors_direct(rm, u, b, config)
        return err, u

    def independent_of(q, ncols, x_new):
        # dependency guard, as in the dense greedy
        mask = column_mask(k, ncols, q.dtype, dev)

        def project_out(v):
            return v - q @ ((q.conj().T @ v) * mask[:, None])

        resid = project_out(project_out(x_new))
        ratio = torch.linalg.norm(resid, dim=0) / torch.clamp(
            torch.linalg.norm(x_new, dim=0), min=1e-300)
        return host_read(float, ratio.max()) > config.dependency_tolerance

    res_limit = max(snapshot_tol * 100, 1e-8)
    accept_limit = 1e-4

    def solve_checked(t):
        with span("greedy.solve"):
            x, relres = snapshot(t)
            worst = host_read(float, relres.max())
            # NaN (Krylov breakdown) must escalate: NaN > x is False
            if not (worst <= res_limit) and hasattr(op, "bands_w"):
                with span("greedy.escalate"):
                    x, relres = snapshot_shifted(t)
                    worst = host_read(float, relres.max())
        if not (worst <= accept_limit):
            warnings.warn(
                f"greedy snapshot solve at t={host_read(float, t):.6g} "
                f"reached only {worst:.1e} relative residual — stopping "
                "basis expansion (strongly indefinite operator?)",
                stacklevel=3,
            )
            return x, False
        if not (worst <= res_limit):
            warnings.warn(
                f"greedy snapshot at t={host_read(float, t):.6g} accepted at "
                f"{worst:.1e} relative residual (> {res_limit:.0e}; "
                "near-resonance conditioning) — basis span is still "
                "useful; the error estimator tracks true residuals",
                stacklevel=3,
            )
        return x, True

    # seeds: snapshots at the domain ends, a pass each
    with span("greedy.iteration"):
        x0, ok0 = solve_checked(domain[0])
    with span("greedy.iteration"):
        x1, ok1 = solve_checked(domain[-1])
        with span("greedy.orthonormalize"):
            q = torch.zeros((n, k), dtype=dtype, device=dev)
            q[:, :2 * m] = orthonormalize_svd(
                torch.cat([x0, x1], dim=1).to(dtype))
    ncols = 2 * m

    rdtype = torch.empty((), dtype=dtype).real.dtype
    err_hist = torch.zeros((max_iters + 1, i_pts), dtype=rdtype)
    converged = False
    healthy = ok0 and ok1
    it = 0
    u = None
    u_ncols = None  # the basis width u was computed for
    while it <= max_iters:
        with span("greedy.iteration"):
            with span("greedy.estimate"):
                err, u = estimate(q, ncols)
            u_ncols = ncols
            # one read of the estimates: the stopping test and the pick
            # are made on the host copy
            err_hist[it] = err_h = host_read(err.cpu)
            it += 1
            if not healthy:
                break
            if float(err_h.max()) < config.error_threshold:
                converged = True
                break
            if ncols + m > k:
                break
            x_new, ok = solve_checked(domain[int(torch.argmax(err_h))])
            if not ok:
                healthy = False
                break
            x_new = x_new.to(dtype)
            with span("greedy.dependency"):
                independent = independent_of(q, ncols, x_new)
            if not independent:
                # dependent snapshot: the estimator floor is reached
                break
            with span("greedy.orthonormalize"):
                q, ncols = orthonormalize_append_cgs2(q, ncols, x_new)

    if u_ncols != ncols:
        # the loop ended right after an append: recompute U for the final
        # basis, or the last snapshot's columns would project to zero
        with span("greedy.estimate"):
            _, u = estimate(q, ncols)

    result = GreedyResult(
        q=q, ncols=ncols, iterations=it, converged=converged,
        err_hist=err_hist.to(dev), failed_snapshot=not healthy,
    )
    rm = _reduced_from_u_matfree(domain, q, ncols, u, b, coeffs).trim()
    return result, rm
