"""Tensor-parallel snapshot solves: row-sharded operators over the mesh.

Counterpart of `morfem_tpu/parallel/tp_solve.py`, under the whole-in,
whole-out contract of `parallel/sharded.py`. The OPERATOR ROWS are split
over the ``tp`` axis and the solve is matrix-free Krylov whose only
distributed primitive is the row-parallel matvec

    y = all_gather_tp( A_local @ x )        A_local: [N/tp, N] per rank

Krylov vectors stay replicated ([N, M], small beside the operator): every
rank performs the same O(N·M) vector updates on the same gathered data,
so every rank takes the same stopping decisions, while the O(N²/tp·M)
matvec is divided. Jacobi-preconditioned Krylov wants diagonally dominant
or definite operators; strongly indefinite banded Helmholtz pencils take
`parallel/tp_banded.py`'s distributed direct solve. The solver reports
achieved residuals.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.ops.krylov import bicgstab, gmres
from morfem_tpu_torch.ops.orthonormalize import orthonormalize_svd
from morfem_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    chunk,
    gather_rows,
)
from morfem_tpu_torch.parallel.sharded import tp_operator_images_and_project


def tp_matvec_fn(mesh, axis: str = "tp"):
    """Build the row-parallel matvec: (a [N, N], x [N, M]) → [N, M].

    Each call multiplies this rank's block of a's rows (a view) and
    gathers the blocks."""
    part = (axis_size(mesh, axis), axis_index(mesh, axis))

    def mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n = a.shape[0]
        r0, r1, _ = chunk(n, *part)
        return gather_rows(a[r0:r1] @ x, n, mesh, axis)

    return mv


def tp_solve(
    a: torch.Tensor,  # [N, N] PRE-symmetrized system matrix
    b: torch.Tensor,  # [N, M]
    mesh,
    axis: str = "tp",
    tol: float = 1e-10,
    maxiter: int = 2000,
    method: str = "bicgstab",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded matrix-free solve of A·x = b over the mesh.

    The matrix should already include the (A+Aᵀ)/2 symmetrization.
    Jacobi-preconditioned block BiCGStab or restarted GMRES
    (`ops/krylov.py`). Returns (x [N, M], relres [M]).
    """
    mv = tp_matvec_fn(mesh, axis)
    diag = torch.diagonal(a)
    safe = torch.where(diag.abs() > 1e-300, diag, torch.ones_like(diag))

    def precond(x_blk):
        # Jacobi; [N] columns (gmres) and [N, M] blocks (bicgstab)
        return x_blk / (safe[:, None] if x_blk.ndim == 2 else safe)

    def matvec(xx):
        return mv(a, xx)

    if method == "gmres":
        x, _ = gmres(matvec, b, precond=precond, tol=tol,
                     maxiter=max(1, maxiter // 32), restart=32)
    else:
        x, _ = bicgstab(matvec, b, precond=precond, tol=tol, maxiter=maxiter)
    r = b - mv(a, x)
    relres = torch.linalg.norm(r, dim=0) / torch.clamp(
        torch.linalg.norm(b, dim=0), min=1e-300)
    return x, relres


def tp_snapshot_basis(
    sys,
    seed_ts: torch.Tensor,
    mesh,
    config: MorfemConfig = DEFAULT_CONFIG,
    axis: str = "tp",
    tol: float = 1e-10,
    method: str = "bicgstab",
):
    """Row-sharded equally-distributed snapshot basis + tp projection.

    Iterative snapshot solves with the row-parallel matvec at the points
    ``seed_ts``, SVD orthonormalization, and the tp projection of
    `tp_operator_images_and_project`. Returns (q [N, S·M], (r0, r1, r2),
    b_r, worst_relres).
    """
    snaps = []
    worst = 0.0
    for t in seed_ts:
        c, cb = sys.coefficients(t)
        a = c[0] * sys.a0 + c[1] * sys.a1 + c[2] * sys.a2
        if config.symmetrize:
            a = (a + a.T) * 0.5
        x, relres = tp_solve(a, cb * sys.b, mesh, axis=axis, tol=tol,
                             method=method)
        worst = max(worst, float(relres.max()))
        snaps.append(x)
    q = orthonormalize_svd(torch.cat(snaps, dim=1))
    _, rs, b_r = tp_operator_images_and_project(
        sys.operators(), sys.b, q, mesh, axis=axis)
    if worst > max(tol * 100, 1e-8):
        warnings.warn(
            f"tp snapshot solves reached only {worst:.1e} relative residual",
            stacklevel=2,
        )
    return q, rs, b_r, worst
