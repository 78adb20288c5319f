"""Greedy projection-basis construction.

Counterpart of `morfem_tpu/mor/greedy.py`. The reference runs the whole
loop as one `lax.while_loop` over a padded [N, K] basis; here the same
state lives on the device and a host loop drives it: seed snapshots at the
first and last domain points, then (1) estimate the residual norm over the
whole domain, (2) take a full-order snapshot at the worst point, (3)
re-orthonormalize — until the max estimate drops below the threshold, the
column budget runs out, the estimate turns NaN, or a new snapshot is
numerically dependent on the basis (stagnation).

Under a trace-mode `PhaseTimer` each pass of the loop is a
``greedy.iteration`` span holding ``greedy.estimate``, ``greedy.solve``,
``greedy.dependency`` and ``greedy.orthonormalize``, and each read of a
value back to the host a ``host sync`` (`utils/timing.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.estimator import (
    estimate_errors,
    estimate_errors_direct,
    estimator_blocks,
    operator_images,
)
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.ops.orthonormalize import (
    column_mask,
    orthonormalize_append_cgs2,
    orthonormalize_svd_masked,
)
from morfem_tpu_torch.ops.solve import solve_point
from morfem_tpu_torch.system import AffineSystem
from morfem_tpu_torch.utils.timing import host_read, span


class GreedyResult(NamedTuple):
    q: torch.Tensor  # [N, K] padded orthonormal basis
    ncols: int  # active columns
    iterations: int  # estimator evaluations performed
    converged: bool
    err_hist: torch.Tensor  # [max_iters + 1, I]; rows ≥ iterations are zero
    failed_snapshot: bool = False  # matrix-free greedy: a solve failed


def max_basis_columns(m: int, config: MorfemConfig, n=None) -> int:
    """Padded basis width: 2 seed snapshots + one per iteration, ≤ N."""
    k = (2 + config.max_greedy_iterations) * m
    if n is not None:
        k = min(k, n)
    return max(k, 2 * m)


def _reduced_from_u(sys, q, ncols, u) -> ReducedModel:
    """Reduced model from the estimator's U_p = A_p·Q (plain transpose)."""
    qmt = (q * column_mask(q.shape[1], ncols, q.dtype, q.device)).T
    return ReducedModel(
        domain=sys.domain, q=q, r0=qmt @ u[0], r1=qmt @ u[1],
        r2=qmt @ u[2], b_r=qmt @ sys.b, ncols=int(ncols), t_a0=sys.t_a0,
        t_a1=sys.t_a1, t_a2=sys.t_a2, t_b=sys.t_b,
    )


def greedy_basis(
    sys: AffineSystem, config: MorfemConfig = DEFAULT_CONFIG
) -> GreedyResult:
    """Run the greedy loop; returns the padded orthonormal basis."""
    m, n, i = sys.m, sys.n, sys.num_points
    k = max_basis_columns(m, config, n)
    max_iters = config.max_greedy_iterations
    c_probe, cb_probe = sys.coefficients(sys.domain[:1])
    dtype = torch.promote_types(
        torch.promote_types(sys.dtype, c_probe.dtype), cb_probe.dtype
    )
    rdtype = torch.empty((), dtype=dtype).real.dtype
    dev = sys.device

    def run_estimator(q, ncols):
        if config.estimator == "gram":
            blocks, u = estimator_blocks(sys, q, ncols)
            err, _ = estimate_errors(_reduced_from_u(sys, q, ncols, u),
                                     blocks, config)
        else:
            u = operator_images(sys, q, ncols)
            err, _ = estimate_errors_direct(
                _reduced_from_u(sys, q, ncols, u), u, sys.b, config
            )
        return err

    def project_out(q, mask, v):
        return v - q @ ((q.conj().T @ v) * mask[:, None])

    q = torch.zeros((n, k), dtype=dtype, device=dev)
    ncols, seeded, it = 0, 0, 0
    err_hist = torch.zeros((max_iters + 1, i), dtype=rdtype, device=dev)
    converged = done = False
    while not done and it <= max_iters:
        with span("greedy.iteration"):
            # the first two iterations take the seed snapshots without the
            # estimator (whose reduced solve is singular on an empty basis)
            seed_phase = seeded < 2
            if seed_phase:
                err = torch.zeros(i, dtype=rdtype, device=dev)
            else:
                with span("greedy.estimate"):
                    err = run_estimator(q, ncols)
                err_hist[it] = err
            err_max = host_read(float, err.max())
            if not seed_phase:
                converged = err_max < config.error_threshold
            out_of_budget = ncols + m > k
            poisoned = not seed_phase and err_max != err_max  # NaN
            if seed_phase:
                t_star = sys.domain[0] if seeded == 0 else sys.domain[-1]
            else:
                t_star = sys.domain[host_read(int, torch.argmax(err))]

            independent = False
            if not (converged or out_of_budget or poisoned):
                with span("greedy.solve"):
                    x_new = solve_point(sys, t_star, config).to(q.dtype)
                with span("greedy.dependency"):
                    # stagnation guard: does any new column keep norm
                    # after projecting out span(Q) twice?
                    mask = column_mask(k, ncols, q.dtype, dev)
                    resid = project_out(q, mask, project_out(q, mask, x_new))
                    ratio = torch.linalg.norm(resid, dim=0) / torch.clamp(
                        torch.linalg.norm(x_new, dim=0), min=1e-300
                    )
                    independent = (host_read(float, ratio.max())
                                   > config.dependency_tolerance)
            if independent:
                with span("greedy.orthonormalize"):
                    if config.orthonormalization == "svd":
                        q2 = q.clone()
                        q2[:, ncols:ncols + m] = x_new
                        q = orthonormalize_svd_masked(q2, ncols + m)
                        # count the columns the SVD actually produced
                        # (unit norm)
                        ncols = host_read(
                            int, ((q.abs() ** 2).sum(dim=0) > 0.5).sum())
                    else:
                        q, ncols = orthonormalize_append_cgs2(q, ncols,
                                                              x_new)
            stagnated = not seed_phase and not independent
            done = converged or out_of_budget or poisoned or stagnated
            if seed_phase:
                seeded += 1
            else:
                it += 1
    return GreedyResult(
        q=q, ncols=ncols, iterations=it, converged=converged,
        err_hist=err_hist,
    )
