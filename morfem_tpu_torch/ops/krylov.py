"""Block BiCGStab and restarted GMRES as host loops over device tensors.

Counterpart of `morfem_tpu/ops/krylov.py`, whose solvers are
`lax.while_loop`s; here each iteration's stopping test reads one scalar
from the device, with the reference's stopping rules. BiCGStab works on the
[N, M] block directly: one matvec per half-step serves all M columns, with
per-column scalars; columns that have converged stop changing (their
updates multiply by ~0) until all meet the tolerance. GMRES solves the
columns one after another.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _identity(x):
    return x


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable = _identity,
    tol: float = 1e-10,
    maxiter: int = 2000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block preconditioned BiCGStab; returns (x [N, M], relres [M])."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    b_norm = torch.linalg.norm(b, dim=0)
    atol = tol * b_norm
    tiny = 1e-300

    def col_dot(u, v):
        return (u.conj() * v).sum(dim=0)

    def safe(d):
        return torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)

    x = torch.zeros_like(b)
    r = b
    rhat = b
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    ones = torch.ones(b.shape[1], dtype=b.dtype, device=b.device)
    rho, alpha, omega = ones, ones, ones
    k = 0
    while k < maxiter:
        going = ((torch.linalg.norm(r, dim=0) > atol).any()
                 & (rho.abs() > tiny).any())
        if not bool(going):
            break
        rho_new = col_dot(rhat, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = r + beta[None, :] * (p - omega[None, :] * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / safe(col_dot(rhat, v))
        s = r - alpha[None, :] * v
        shat = precond(s)
        t = matvec(shat)
        omega = col_dot(t, s) / safe(col_dot(t, t))
        x = x + alpha[None, :] * phat + omega[None, :] * shat
        r = s - omega[None, :] * t
        rho = rho_new
        k += 1
    relres = torch.linalg.norm(r, dim=0) / torch.clamp(b_norm, min=tiny)
    if squeeze:
        return x[:, 0], relres[0]
    return x, relres


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable = _identity,
    tol: float = 1e-10,
    maxiter: int = 50,
    restart: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restarted, right-preconditioned GMRES(m); returns (x, relres per
    column). `maxiter` counts outer restarts; each runs `restart` full
    Arnoldi steps (modified Gram–Schmidt plus one re-orthogonalization
    pass), as in the reference. The small least-squares problem is solved
    on the host by SVD (rank-deficient after a breakdown, as the
    reference's `lstsq` allows)."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, m_cols = b.shape
    dt, dev = b.dtype, b.device
    tiny = 1e-300

    def mv_col(x_col):
        return matvec(x_col[:, None])[:, 0]

    def cycle(b_col, x):
        r = b_col - mv_col(x)
        beta = torch.linalg.norm(r)
        v = torch.zeros((n, restart + 1), dtype=dt, device=dev)
        v[:, 0] = r / torch.clamp(beta, min=tiny)
        h = torch.zeros((restart + 1, restart), dtype=dt, device=dev)
        for j in range(restart):
            w = mv_col(precond(v[:, j]))
            vj = v[:, :j + 1]
            coeffs = vj.conj().T @ w
            w = w - vj @ coeffs
            coeffs2 = vj.conj().T @ w
            w = w - vj @ coeffs2
            wn = torch.linalg.norm(w)
            h[:j + 1, j] = coeffs + coeffs2
            h[j + 1, j] = wn
            v[:, j + 1] = w / torch.clamp(wn, min=tiny)
        e1 = torch.zeros((restart + 1, 1), dtype=dt)
        e1[0, 0] = beta.cpu()
        y = torch.linalg.lstsq(h.cpu(), e1, driver="gelsd").solution
        return x + precond(v[:, :restart] @ y[:, 0].to(dev))

    xs, rels = [], []
    for col in range(m_cols):
        b_col = b[:, col]
        b_norm = float(torch.linalg.norm(b_col))
        x = torch.zeros_like(b_col)
        k = 0
        while k < maxiter and float(
                torch.linalg.norm(b_col - mv_col(x))) > tol * b_norm:
            x = cycle(b_col, x)
            k += 1
        xs.append(x)
        rels.append(torch.linalg.norm(b_col - mv_col(x))
                    / max(b_norm, tiny))
    x = torch.stack(xs, dim=1)
    relres = torch.stack(rels)
    if squeeze:
        return x[:, 0], relres[0]
    return x, relres
