"""Tensor-parallel DENSE direct solves — Gauss–Jordan over the tp axis.

Counterpart of `morfem_tpu/parallel/tp_dense.py`, under the whole-in,
whole-out contract of `parallel/sharded.py`. The blocked Gauss–Jordan
elimination of `ops/blocked_inverse.py` runs COLUMN-sharded over ``tp``:

  * each rank owns a contiguous block of columns of the working matrix
    (which turns into the composed elimination coefficients C);
  * at every width-``panel`` step every rank factors its own panel at the
    step's local offset (`gj_panel_factor`, the O(N·panel²) sequential
    part), and the owner's (cp [N, panel], pivots [panel]) reach every
    rank by one masked all_reduce each: the other ranks add zeros chosen
    by `torch.where`, not by a multiply, since a non-owner's panel can
    hit a zero pivot and NaN·0 would poison the sum;
  * every rank then applies the rank-``panel`` update to its own columns
    (the O(N²·panel) part, divided);
  * applying A⁻¹ = D⁻¹·Pᵀ·(I + C·E) is one column-sharded product + one
    all_reduce and two replicated gathers; the f64 refinement around it
    takes residuals from the same column-sharded matvec of the ORIGINAL
    matrix.

Pivoting is the single-card Gauss–Jordan's masked partial pivoting: the
owner holds the whole column, so no pivot exchange is needed. Rows are
equilibrated to unit max first. The products are FP32 with TF32 off
(`NUMERICS.md` row 33).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from morfem_tpu_torch.ops.blocked_inverse import gj_panel_factor
from morfem_tpu_torch.ops.refine import refine
from morfem_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
    chunk,
)


class TpGjFactor(NamedTuple):
    """Column-sharded Gauss–Jordan factor, gathered whole.

    c: [Np, Np] f32 — elimination coefficients (column j = the c-vector of
       elimination step j); each rank reads its block of columns.
    pivrows: [Np] int64 — pivot row of each step.
    d: [Np] working dtype — row equilibration scales.
    n: original (unpadded) size.
    """

    c: torch.Tensor
    pivrows: torch.Tensor
    d: torch.Tensor
    n: int


def _pad_to(a: torch.Tensor, np_: int) -> torch.Tensor:
    n0 = a.shape[0]
    if np_ == n0:
        return a
    out = torch.zeros((np_, np_), dtype=a.dtype, device=a.device)
    out[:n0, :n0] = a
    out[n0:, n0:] = torch.eye(np_ - n0, dtype=a.dtype, device=a.device)
    return out


def _check_square_real(a: torch.Tensor, name: str) -> int:
    n0 = a.shape[-1]
    if a.ndim != 2 or a.shape[-2] != n0:
        raise ValueError(f"square matrix required, got {tuple(a.shape)}")
    if a.is_complex():
        raise ValueError(
            f"{name} is real-only; lift complex operators through the real "
            "embedding first (ops/complex_split)"
        )
    return n0


def _columns(mesh, axis: str, np_: int) -> slice:
    w = np_ // axis_size(mesh, axis)
    j = axis_index(mesh, axis)
    return slice(j * w, (j + 1) * w)


def _factor_local(m_local: torch.Tensor, mesh, axis: str, panel: int,
                  sub: int):
    """Per-rank body of the distributed factorization (module docstring).

    m_local: [Np, Np/tp] f32 — this rank's equilibrated column block.
    Returns (c_local, pivrows) with pivrows the same on every rank.
    """
    np_, shard_w = m_local.shape
    m_l = m_local.clone()
    panels_per_shard = shard_w // panel
    my = axis_index(mesh, axis)
    avail = torch.ones(np_, dtype=torch.bool, device=m_l.device)
    pivrows = torch.zeros(np_, dtype=torch.long, device=m_l.device)
    for k in range(np_ // panel):
        owner = k // panels_per_shard
        cols = slice((k % panels_per_shard) * panel,
                     (k % panels_per_shard + 1) * panel)
        cp_mine, piv_mine, _ = gj_panel_factor(m_l[:, cols], avail, sub)
        # select with where, NOT multiply by a mask (module docstring)
        is_owner = torch.tensor(my == owner, device=m_l.device)
        cp = all_reduce(torch.where(is_owner, cp_mine,
                                    torch.zeros_like(cp_mine)), mesh, axis)
        pivpanel = all_reduce(torch.where(is_owner, piv_mine,
                                          torch.zeros_like(piv_mine)),
                              mesh, axis)
        m_l += cp @ m_l[pivpanel]  # rank-`panel` update of the local block
        if my == owner:
            m_l[:, cols] = cp
        avail[pivpanel] = False
        pivrows[k * panel:(k + 1) * panel] = pivpanel
    return m_l, pivrows


def tp_gj_factor(
    a: torch.Tensor,
    mesh,
    axis: str = "tp",
    panel: int = 128,
    sub: int = 8,
) -> TpGjFactor:
    """Distributed Gauss–Jordan factorization of a real [N, N] matrix.

    ``a`` is padded to a multiple of ``panel × tp`` (identity on the pad)
    and row-equilibrated like `gj_inverse_f32`. The column blocks of C are
    gathered at the end, so every rank returns the whole factor.
    """
    n0 = _check_square_real(a, "tp_gj_factor")
    step = panel * axis_size(mesh, axis)
    np_ = ((n0 + step - 1) // step) * step
    d = a.abs().amax(dim=-1)
    d = torch.where(d == 0, torch.ones_like(d), d)
    a_eq = _pad_to((a / d[:, None]).to(torch.float32), np_)
    d_p = torch.cat([d, torch.ones(np_ - n0, dtype=d.dtype,
                                   device=d.device)])
    c_local, pivrows = _factor_local(
        a_eq[:, _columns(mesh, axis, np_)], mesh, axis, panel, sub)
    c = all_gather_cat(c_local, mesh, axis, dim=1)
    return TpGjFactor(c=c, pivrows=pivrows, d=d_p, n=n0)


def tp_gj_apply(
    fac: TpGjFactor,
    b: torch.Tensor,
    mesh,
    axis: str = "tp",
) -> torch.Tensor:
    """x ≈ A⁻¹·b from the column-sharded factor (f32 apply).

    A⁻¹·b = D⁻¹·Pᵀ·(I + C·E)·b on the equilibrated system: z = b[pivrows]
    (replicated gather), y = b + C·z (column-sharded product + one
    all_reduce), x = y[pivrows] (the Pᵀ gather).
    """
    np_ = fac.c.shape[0]
    n0 = fac.n
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    b_p = torch.zeros((np_, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    b_p[:n0] = b / fac.d[:n0, None]
    z = b_p[fac.pivrows]
    cols = _columns(mesh, axis, np_)
    y = b_p + all_reduce(fac.c[:, cols] @ z[cols], mesh, axis)
    x = y[fac.pivrows][:n0].to(b.dtype)
    return x[:, 0] if squeeze else x


def _column_matvec(a: torch.Tensor, mesh, axis: str):
    """x ↦ A·x by this rank's block of columns + one all_reduce."""
    c0, c1, _ = chunk(a.shape[1], axis_size(mesh, axis),
                      axis_index(mesh, axis))

    def mv(x):
        return all_reduce(a[:, c0:c1] @ x[c0:c1], mesh, axis)

    return mv


def _host_norm(r: torch.Tensor) -> float:
    # every rank holds the same all-reduced residual, so every rank takes
    # the same decisions
    return float(torch.linalg.norm(r))


def tp_solve_dense(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh,
    axis: str = "tp",
    panel: int = 128,
    sub: int = 8,
    refine_iterations: int = 25,
    fac: Optional[TpGjFactor] = None,
) -> torch.Tensor:
    """Working-precision distributed dense solve: factor + f64 refinement.

    Pass ``fac`` to reuse one factorization for many right-hand sides.
    The refinement residuals use a column-sharded matvec of the ORIGINAL
    matrix (f64 products + one all_reduce); a float32 b is returned
    unrefined.
    """
    if fac is None:
        fac = tp_gj_factor(a, mesh, axis=axis, panel=panel, sub=sub)
    x = tp_gj_apply(fac, b, mesh, axis=axis).to(b.dtype)
    if refine_iterations <= 0 or b.dtype != torch.float64:
        return x
    mv = _column_matvec(a, mesh, axis)
    tol = 10 * torch.finfo(b.dtype).eps * _host_norm(b)
    return refine(
        x, lambda x: b - mv(x),
        lambda r: tp_gj_apply(fac, r, mesh, axis=axis).to(b.dtype), tol,
        refine_iterations, norm=_host_norm)[0]


def tp_solve_dense_compiled(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh,
    axis: str = "tp",
    panel: int = 128,
    sub: int = 8,
    refine_iterations: int = 25,
) -> torch.Tensor:
    """One-shot distributed dense solve: equilibrate, factor, apply and
    refine in one call.

    The reference fuses these steps into one compiled program, with the
    adaptive refinement as an on-device loop (no host round trip after
    dispatch). PyTorch runs eagerly: this computes the same steps in the
    same order (equilibration from each rank's local row maxima and one
    max all_reduce, the factor kept in its column blocks and never
    gathered, the same stopping rule), with a host-driven loop. Real
    systems only; the refinement runs when the working dtype is wider
    than f32.
    """
    n0 = _check_square_real(a, "tp_solve_dense_compiled")
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    step = panel * axis_size(mesh, axis)
    np_ = ((n0 + step - 1) // step) * step
    work = torch.promote_types(a.dtype, b.dtype)
    a_p = _pad_to(a.to(work), np_)
    b_p = torch.zeros((np_, b.shape[1]), dtype=work, device=b.device)
    b_p[:n0] = b
    cols = _columns(mesh, axis, np_)
    a_loc = a_p[:, cols]
    # global row maxima: local row max, then a max all_reduce
    d = all_reduce(a_loc.abs().amax(dim=1), mesh, axis, op=dist.ReduceOp.MAX)
    d = torch.where(d == 0, torch.ones_like(d), d)
    c_loc, pivrows = _factor_local((a_loc / d[:, None]).to(torch.float32),
                                   mesh, axis, panel, sub)

    def apply_inv(r):
        r_eq = (r / d[:, None]).to(torch.float32)
        z = r_eq[pivrows]
        y = r_eq + all_reduce(c_loc @ z[cols], mesh, axis)
        return y[pivrows].to(work)

    x = apply_inv(b_p)
    if refine_iterations > 0 and torch.finfo(work).bits > 32:
        mv = _column_matvec(a_p, mesh, axis)
        tol = 10 * torch.finfo(work).eps * _host_norm(b_p)
        x = refine(x, lambda x: b_p - mv(x), apply_inv, tol,
                   refine_iterations, norm=_host_norm)[0]
    x = x[:n0]
    return x[:, 0] if squeeze else x
