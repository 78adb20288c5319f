"""Sparse operators and the large-N snapshot solves.

Counterpart of `morfem_tpu/ops/sparse.py`. The reference keeps general
sparsity as BCOO; the port keeps it as `torch.sparse_csr_tensor`
(cuSPARSE SpMM on the card) — neither is a hand-written kernel. On top:

  * `solve_point_iterative` — the snapshot solve of the matrix-free route,
    dispatched by operator type: banded operators take the
    block-tridiagonal DIRECT elimination (`ops/block_tridiag.py`), a
    `GeneralSparseOperator` takes exact-operator GMRES with the
    truncated-band shifted preconditioner, anything else Jacobi-
    preconditioned block BiCGStab (or GMRES). Krylov callers get the
    achieved residual back, so non-convergence is never consumed
    silently;
  * `sparse_snapshot_basis` (equally-distributed basis) and
    `sparse_project` (Galerkin projection with SpMM images).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.system import _coefficients


def to_csr(a, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Dense / SciPy sparse → a `torch.sparse_csr_tensor` on `device`."""
    import scipy.sparse as sp

    dev = resolve_device(device)
    csr = a.tocsr() if sp.issparse(a) else sp.csr_matrix(np.asarray(a))
    csr.sum_duplicates()

    def dense(x, t_dtype):
        # copied into a fresh tensor: an empty NumPy array has stride 0,
        # which PyTorch's CSR check may refuse as not contiguous
        return torch.empty(x.shape, dtype=t_dtype).copy_(torch.as_tensor(x))

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            dense(csr.indptr, torch.int64), dense(csr.indices, torch.int64),
            dense(csr.data, dtype), size=csr.shape, check_invariants=True,
        ).to(dev)


def _spmm(op: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 1:
        return (op @ x[:, None])[:, 0]
    return op @ x


class SparseAffineOperator:
    """A(t)·x applications for CSR operator addends.

    Symmetrization (A+Aᵀ)/2 is applied per matvec through the transposed
    products, as in the reference, so no symmetrized matrix is stored.
    """

    def __init__(self, *mats, symmetrize: bool = True, device="cuda"):
        import scipy.sparse as sp

        self.ops = tuple(to_csr(a, device=device) for a in mats)
        self.ops_t = tuple(
            to_csr((a if sp.issparse(a) else np.asarray(a)).T, device=device)
            for a in mats
        ) if symmetrize else None
        self.symmetrize = symmetrize
        self.diags = torch.stack([
            torch.as_tensor(
                (a if sp.issparse(a) else sp.csr_matrix(np.asarray(a)))
                .diagonal(), dtype=torch.float64)
            for a in mats
        ]).to(self.ops[0].device)

    @property
    def n_addends(self) -> int:
        return len(self.ops)

    @property
    def device(self) -> torch.device:
        return self.ops[0].device

    def matvec(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = A(t)·x with coefficients c [P]; x [N] or [N, M]."""
        y = torch.zeros_like(x)
        for p, op in enumerate(self.ops):
            y = y + c[p] * _spmm(op, x)
        if self.symmetrize:
            yt = torch.zeros_like(x)
            for p, op_t in enumerate(self.ops_t):
                yt = yt + c[p] * _spmm(op_t, x)
            y = (y + yt) * 0.5
        return y

    def apply_addend(self, p: int, x: torch.Tensor) -> torch.Tensor:
        """A_p·x for one addend (symmetrized like `matvec`)."""
        y = _spmm(self.ops[p], x)
        if self.symmetrize:
            y = (y + _spmm(self.ops_t[p], x)) * 0.5
        return y

    def diagonal(self, c: torch.Tensor) -> torch.Tensor:
        """diag(A(t)) for the Jacobi preconditioner."""
        return torch.tensordot(c.to(self.diags.dtype), self.diags, dims=1)


class GeneralSparseOperator:
    """Exact sparse applies + truncated-band shifted-direct preconditioning.

    The operator for sparsity that RCM cannot make banded
    (`BandwidthError`): applies and residuals go through the exact
    operator; solves run GMRES preconditioned by the shifted block-direct
    factorization of the in-band part
    (`ops/block_tridiag.py::general_sparse_solve`). Build it from
    `truncated_band_via_rcm`.
    """

    def __init__(self, exact_op, band_op, sigma: float = 1e-4,
                 dropped: float = 0.0):
        self.exact = exact_op
        self.band = band_op
        self.sigma = sigma
        self.dropped = dropped

    @property
    def n_addends(self) -> int:
        return self.exact.n_addends

    @property
    def device(self) -> torch.device:
        return self.exact.device

    def matvec(self, c, x):
        return self.exact.matvec(c, x)

    def apply_addend(self, p, x):
        return self.exact.apply_addend(p, x)

    def diagonal(self, c):
        return self.exact.diagonal(c)


def solve_point_iterative(
    op,
    c: torch.Tensor,
    rhs: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 2000,
    method: str = "auto",
    return_residual: bool = False,
):
    """Matrix-free solve of A(t)·x = rhs — the large-N snapshot solve.

    Methods: ``"direct"`` (block-tridiagonal elimination + f64 refinement,
    banded operators), ``"general"`` (exact-operator GMRES, truncated-band
    shifted preconditioner; `GeneralSparseOperator`), ``"bicgstab"`` /
    ``"gmres"`` (Jacobi-preconditioned block Krylov, for definite or
    diagonally dominant systems; a banded or block-sparse operator runs
    its f32 kernel inside), ``"spike"`` (the banded direct solve
    DISTRIBUTED over a mesh, `parallel/tp_banded.py`; operators carrying a
    ``spike_mesh``, `SpikeBandedOperator`, only), ``"auto"`` (spike when
    the operator carries a mesh, direct for banded storage, general for a
    `GeneralSparseOperator`, else bicgstab).

    With ``return_residual`` also returns the achieved relative residual
    per column.
    """
    if method == "auto":
        if hasattr(op, "spike_mesh"):
            method = "spike"
        elif hasattr(op, "bands_w"):
            method = "direct"
        elif hasattr(op, "band"):
            method = "general"
        else:
            method = "bicgstab"
    if method == "spike":
        x, relres, _ = op.spike_solve(
            c, rhs, tol=tol, refine_iterations=min(30, maxiter))
        return (x, relres) if return_residual else x
    if method == "general":
        from morfem_tpu_torch.ops.block_tridiag import general_sparse_solve

        x, relres = general_sparse_solve(
            op.exact, op.band, c, rhs, sigma=op.sigma, tol=tol,
            maxiter=max(2, maxiter // 32),
        )
        return (x, relres) if return_residual else x
    if method == "direct":
        from morfem_tpu_torch.ops.block_tridiag import banded_direct_solve

        x, relres, _ = banded_direct_solve(
            op, c, rhs, tol=tol, refine_iterations=min(30, maxiter)
        )
        return (x, relres) if return_residual else x
    if method not in ("bicgstab", "gmres"):
        raise ValueError(f"unknown method {method!r}")
    diag = op.diagonal(c)
    safe = torch.where(diag.abs() > 1e-300, diag, torch.ones_like(diag))

    # `bind` (when offered) combines the operator for these coefficients
    # once: the f32 kernel matvec (K5, K6) inside the Krylov loop
    mv = op.bind(c) if hasattr(op, "bind") else (lambda x: op.matvec(c, x))

    def precond(x):
        return x / (safe[:, None] if x.ndim == 2 else safe)

    if method == "gmres":
        from morfem_tpu_torch.ops.krylov import gmres

        x, _ = gmres(mv, rhs, precond=precond, tol=tol,
                     maxiter=max(1, maxiter // 32), restart=32)
    else:
        from morfem_tpu_torch.ops.krylov import bicgstab

        x, _ = bicgstab(mv, rhs, precond=precond, tol=tol, maxiter=maxiter)
        if hasattr(op, "bind_precise"):
            # the fast matvec is f32: polish with a few outer refinement
            # steps whose residuals use the working-dtype matvec
            mv_precise = op.bind_precise(c)
            for _ in range(3):
                r = rhs - mv_precise(x.to(rhs.dtype))
                d, _ = bicgstab(mv, r.to(x.dtype), precond=precond,
                                tol=1e-4, maxiter=maxiter)
                x = x.to(rhs.dtype) + d.to(rhs.dtype)
    if return_residual:
        mv_res = op.bind_precise(c) if hasattr(op, "bind_precise") else (
            lambda v: op.matvec(c, v)
        )
        r = rhs - mv_res(x)
        relres = torch.linalg.norm(r, dim=0) / torch.clamp(
            torch.linalg.norm(rhs, dim=0), min=1e-300
        )
        return x, relres
    return x


def sparse_snapshot_basis(
    mats,
    b: torch.Tensor,
    domain: torch.Tensor,
    seed_indices,
    coeffs,
    config: MorfemConfig = DEFAULT_CONFIG,
    tol: float = 1e-10,
    method: str = "auto",
    op=None,
) -> torch.Tensor:
    """Equally-distributed snapshot basis with large-N solves.

    ``mats`` are the P operator addends, ``coeffs`` the P coefficient
    callables plus t_b last. Pass ``op`` (e.g. a `BandedAffineOperator`)
    to reuse prepared storage and unlock ``method="auto"``'s direct
    banded path; by default a CSR `SparseAffineOperator` on b's device is
    built from ``mats``. A point whose residual misses ``max(100·tol,
    1e-8)`` escalates to the shifted GMRES solve (banded operators);
    a residual still above it warns. Returns the orthonormal q [N, S·M].
    """
    from morfem_tpu_torch.ops.block_tridiag import shifted_gmres_solve
    from morfem_tpu_torch.ops.orthonormalize import orthonormalize_svd

    t_ops, t_b = tuple(coeffs[:-1]), coeffs[-1]
    if len(t_ops) != len(mats):
        raise ValueError(
            f"{len(mats)} operator addends need {len(mats)} + 1 coefficient "
            f"callables, got {len(coeffs)}"
        )
    if op is None:
        op = SparseAffineOperator(*mats, symmetrize=config.symmetrize,
                                  device=b.device)
    idx = torch.as_tensor(np.asarray(seed_indices), device=domain.device)
    ts = domain[idx]
    limit = max(tol * 100, 1e-8)
    snaps = []
    worst = 0.0
    for i in range(ts.shape[0]):
        c, cb = _coefficients(t_ops, t_b, ts[i])
        c, rhs = c.to(b.dtype), cb.to(b.dtype) * b
        x, relres = solve_point_iterative(op, c, rhs, tol=tol, method=method,
                                          return_residual=True)
        point_worst = float(relres.max())
        # NaN residuals must escalate too: compare negatively
        if not (point_worst <= limit) and hasattr(op, "bands_w"):
            x, relres = shifted_gmres_solve(op, c, rhs, tol=tol, maxiter=60)
            point_worst = float(relres.max())
        if not (point_worst <= worst):
            worst = point_worst
        snaps.append(x)
    if worst > limit:
        hint = ""
        if getattr(op, "dropped", 0.0) > 0.01:
            hint = (
                f" The in-band preconditioner drops {op.dropped:.1%} of "
                "the operator's mass — raising config.band_max_half "
                "should restore convergence."
            )
        warnings.warn(
            f"iterative snapshot solves reached only {worst:.1e} relative "
            "residual — the operator is likely strongly indefinite; the "
            "basis may be unusable (consider the dense path or a better "
            f"preconditioner).{hint}",
            stacklevel=2,
        )
    return orthonormalize_svd(torch.cat(snaps, dim=1))


def sparse_project(mats, b: torch.Tensor, q: torch.Tensor):
    """Galerkin projection with SpMM images — r_p = Qᵀ·(A_p·Q), b_r = Qᵀ·B
    (plain transpose). Returns (P-tuple of [K, K], b_r)."""
    qt = q.T
    rs = tuple(qt @ (to_csr(a, dtype=q.dtype, device=q.device) @ q)
               for a in mats)
    return rs, qt @ torch.as_tensor(b, device=q.device)
