"""Reduced-order model: Galerkin projection and the batched reduced sweep.

Counterpart of `morfem_tpu/mor/reduced.py`. The projection uses the PLAIN
transpose ``qᵀ`` (bilinear form), like the reference, so complex-symmetric
FEM systems stay complex-symmetric after projection. The sweep assembles
all I reduced systems at once ([I, K, K] = Σ c_p(t)·R_p, identity on the
inactive diagonal) and solves them as one batched `torch.linalg` LU in the
factor dtype with adaptive refinement in the working dtype; under
``use_pallas_reduced_sweep`` the fused CUDA kernel K4 assembles and solves
each point instead (`ops/kernels/reduced_sweep.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.ops.orthonormalize import column_mask
from morfem_tpu_torch.ops.refine import host_norm, refine, refine_masked
from morfem_tpu_torch.ops.solve import factor_dtype_like, lu_factor_each
from morfem_tpu_torch.system import AffineSystem, Coefficient, _coefficients


@dataclasses.dataclass(frozen=True)
class ReducedModel:
    """Projected model: q [N, K]; r0/r1/r2 [K, K]; b_r [K, M]; domain [I];
    ``ncols`` active basis columns (≤ K; the rest is zero padding)."""

    domain: torch.Tensor
    q: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    b_r: torch.Tensor
    ncols: int
    t_a0: Coefficient
    t_a1: Coefficient
    t_a2: Coefficient
    t_b: Coefficient
    r_extra: Tuple[torch.Tensor, ...] = ()
    t_extra: Tuple[Coefficient, ...] = ()

    @property
    def k(self) -> int:
        return self.q.shape[1]

    @property
    def m(self) -> int:
        return self.b_r.shape[1]

    def coefficients(self, t):
        fns = (self.t_a0, self.t_a1, self.t_a2) + tuple(self.t_extra)
        return _coefficients(fns, self.t_b, t)

    def trim(self) -> "ReducedModel":
        """Slice away the padding columns."""
        nc = int(self.ncols)
        return dataclasses.replace(
            self,
            q=self.q[:, :nc],
            r0=self.r0[:nc, :nc],
            r1=self.r1[:nc, :nc],
            r2=self.r2[:nc, :nc],
            b_r=self.b_r[:nc],
            ncols=nc,
            r_extra=tuple(r[:nc, :nc] for r in self.r_extra),
        )


def project(sys: AffineSystem, q: torch.Tensor, ncols=None) -> ReducedModel:
    """Galerkin-project the affine system onto basis q (plain transpose)."""
    ncols = q.shape[1] if ncols is None else int(ncols)
    qt = q.T
    r0, r1, r2 = (qt @ (a @ q) for a in sys.operators())
    return ReducedModel(
        domain=sys.domain, q=q, r0=r0, r1=r1, r2=r2, b_r=qt @ sys.b,
        ncols=ncols, t_a0=sys.t_a0, t_a1=sys.t_a1, t_a2=sys.t_a2,
        t_b=sys.t_b,
    )


def assemble_reduced(
    rm: ReducedModel, ts, config: MorfemConfig = DEFAULT_CONFIG
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch of reduced systems ([I, K, K], [I, K, M]) at points ts, with
    identity on inactive diagonal entries."""
    c, cb = rm.coefficients(ts)
    a = (
        c[..., 0, None, None] * rm.r0
        + c[..., 1, None, None] * rm.r1
        + c[..., 2, None, None] * rm.r2
    )
    for j, rj in enumerate(rm.r_extra):
        a = a + c[..., 3 + j, None, None] * rj
    if config.symmetrize:
        a = (a + a.transpose(-1, -2)) * 0.5
    mask = column_mask(rm.k, rm.ncols, a.dtype, a.device)
    a = a + torch.diag(1.0 - mask)
    rhs = cb[..., None, None] * (rm.b_r * mask[:, None])
    return a, rhs


def solve_reduced_batch(
    a: torch.Tensor, rhs: torch.Tensor, config: MorfemConfig = DEFAULT_CONFIG,
    masked: bool = False,
) -> torch.Tensor:
    """Batched LU of [..., K, K] systems + refinement with a batch-global
    stopping criterion (the reference's).

    ``masked=True`` factors each system alone (`ops/solve.py::
    lu_factor_each`) and runs the refinement as the masked fixed trip
    `ops/refine.py::refine_masked`, same rule: nothing synchronises the
    host, so a CUDA graph can capture the call.
    """
    work = torch.promote_types(a.dtype, rhs.dtype)
    fd = factor_dtype_like(work, config.factor_dtype_name)
    factor = lu_factor_each if masked else torch.linalg.lu_factor
    lu, piv = factor(a.to(fd))
    x = torch.linalg.lu_solve(lu, piv, rhs.to(fd)).to(work)
    if (
        config.refine_iterations > 0
        and torch.finfo(work).bits > torch.finfo(fd).bits
    ):
        def apply(r):
            return torch.linalg.lu_solve(lu, piv, r.to(fd)).to(work)

        if masked:
            return refine_masked(a, rhs, x, apply, config.refine_iterations,
                                 per_lane=False)
        a_w, rhs_w = a.to(work), rhs.to(work)
        tol = 10 * torch.finfo(work).eps * host_norm(rhs_w)
        x = refine(x, lambda x: rhs_w - a_w @ x, apply, tol,
                   config.refine_iterations, norm=host_norm)[0]
    return x


def sweep(
    rm: ReducedModel, config: MorfemConfig = DEFAULT_CONFIG, ts=None
) -> torch.Tensor:
    """Sweep the reduced model over its domain (or ts) → x [I, K, M].

    ts (the serving re-sweep's grid) may be any array of points; it is
    moved to the model's device. ``config.use_pallas_reduced_sweep`` takes
    the fused kernel K4 with f64 refinement instead of the batched LU.
    """
    ts = rm.domain if ts is None else torch.as_tensor(
        ts, device=rm.r0.device)
    if config.use_pallas_reduced_sweep:
        from morfem_tpu_torch.ops.kernels.reduced_sweep import (
            fused_reduced_sweep,
        )

        return fused_reduced_sweep(rm, ts, config)
    a, rhs = assemble_reduced(rm, ts, config)
    return solve_reduced_batch(a, rhs, config)
