"""Residual-norm error estimator — the heart of the greedy loop.

Counterpart of `morfem_tpu/mor/estimator.py`. Both estimators start from
the operator images U_p = A_p·Q ([N, N]×[N, K] products):

* `estimate_errors_direct` (the default) forms R(t) = Σ_p c_p·U_p·x_r − c_b·B
  per point and returns ‖RᴴR‖_F (the reference's quadratic semantics);
* `estimate_errors` expands the same norm into the reference's 16 Gram
  blocks (``estimator="gram"``).

All products are float64 matmuls on the card; the reference's Ozaki path
(``estimator_impl="ozaki"``) computes the same quantity, so every
``estimator_impl`` value takes the one path here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.reduced import (
    ReducedModel,
    assemble_reduced,
    solve_reduced_batch,
)
from morfem_tpu_torch.ops.orthonormalize import column_mask
from morfem_tpu_torch.system import AffineSystem


class EstimatorBlocks(NamedTuple):
    """g[i, j] = U_iᴴU_j [3, 3, K, K]; gb[i] = U_iᴴB [3, K, M]; bb = BᴴB."""

    g: torch.Tensor
    gb: torch.Tensor
    bb: torch.Tensor


def operator_images(sys: AffineSystem, q: torch.Tensor, ncols) -> torch.Tensor:
    """U_p = A_p·Q for the masked padded basis — [3, N, K]."""
    qm = q * column_mask(q.shape[1], ncols, q.dtype, q.device)
    return torch.stack([a @ qm for a in sys.operators()])


def estimator_blocks(
    sys: AffineSystem, q: torch.Tensor, ncols
) -> Tuple[EstimatorBlocks, torch.Tensor]:
    """The Gram blocks and (for reuse) the U stack [3, N, K]."""
    u = operator_images(sys, q, ncols)
    uh = u.conj().transpose(-1, -2)  # [3, K, N]
    g = torch.einsum("ikn,jnl->ijkl", uh, u)
    gb = uh @ sys.b
    bb = sys.b.conj().T @ sys.b
    return EstimatorBlocks(g=g, gb=gb, bb=bb), u


def estimate_errors(
    rm: ReducedModel, blocks: EstimatorBlocks,
    config: MorfemConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-norm estimate per point from the Gram blocks.

    Coefficients are normalized by their per-operator maxima and the
    scales folded into the blocks (keeps the quartic products in range).
    Returns (err [I], x_r [I, K, M]).
    """
    c, cb = rm.coefficients(rm.domain)
    a, rhs = assemble_reduced(rm, rm.domain, config)
    x = solve_reduced_batch(a, rhs, config)
    s = torch.clamp(c.abs().amax(dim=0), min=1e-300)
    sb = torch.clamp(cb.abs().amax(), min=1e-300)
    cn, cbn = c / s, cb / sb
    g_bal = (blocks.g * s[:, None, None, None]) * s[None, :, None, None]
    gb_bal = (blocks.gb * s[:, None, None]) * sb
    bb_bal = blocks.bb * (sb * sb)
    z = torch.einsum("ip,iq,pqkl->ikl", cn, cn, g_bal)
    t1 = torch.einsum("ikm,ikl,iln->imn", x.conj(), z, x)
    gv = torch.einsum("ip,i,pkm->ikm", cn, cbn, gb_bal)
    t2 = torch.einsum("ikm,ikn->imn", x.conj(), gv)
    t3 = torch.einsum("ip,i,pkm,ikn->imn", cn, cbn, gb_bal.conj(), x)
    t4 = (cbn * cbn)[:, None, None] * bb_bal
    e = t1 - t2 - t3 + t4
    err = torch.sqrt((e.abs() ** 2).sum(dim=(-1, -2)))
    return err, x


def estimate_errors_direct(
    rm: ReducedModel,
    u: torch.Tensor,
    b: torch.Tensor,
    config: MorfemConfig = DEFAULT_CONFIG,
    impl=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-norm estimate per point, from the residual itself.

    err(t) = ‖R(t)ᴴR(t)‖_F with R = Σ_p c_p·U_p·x_r − c_b·B, computed per
    chunk of ``config.estimator_chunk`` points and normalized per point
    (R/max|R|) before the quartic norm, as in the reference.
    Returns (err [I], x_r [I, K, M]).
    """
    if impl is None:
        impl = config.estimator_impl
    if impl not in ("auto", "einsum", "ozaki"):
        raise ValueError(f"impl must be auto|einsum|ozaki, got {impl!r}")
    c, cb = rm.coefficients(rm.domain)
    a, rhs = assemble_reduced(rm, rm.domain, config)
    x = solve_reduced_batch(a, rhs, config)
    n_add, n_rows, k_b = u.shape
    # fold the operator axis into the contraction: one [N, P·K] × [P·K, M]
    # product per point
    ucat = u.permute(1, 0, 2).reshape(n_rows, n_add * k_b)
    tiny = torch.finfo(x.real.dtype).tiny
    errs = []
    chunk = max(1, config.estimator_chunk)
    for lo in range(0, c.shape[0], chunk):
        cc, cbc, xc = c[lo:lo + chunk], cb[lo:lo + chunk], x[lo:lo + chunk]
        xcat = (cc[:, :, None, None] * xc[:, None]).reshape(
            xc.shape[0], n_add * k_b, xc.shape[-1]
        )
        r = ucat @ xcat - cbc[:, None, None] * b
        s = torch.clamp(r.abs().amax(dim=(-1, -2), keepdim=True), min=tiny)
        rn = r / s
        rhr = rn.conj().transpose(-1, -2) @ rn
        norm_n = torch.sqrt((rhr.abs() ** 2).sum(dim=(-1, -2)))
        errs.append(torch.square(s[:, 0, 0].real * torch.sqrt(norm_n)))
    return torch.cat(errs), x


def residual_norm_exact(
    sys: AffineSystem, rm: ReducedModel, config: MorfemConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Exact ‖A(t)·Q·x_r(t) − b(t)‖_F per point, with the raw operators
    (the estimator's definition) — the test oracle."""
    from morfem_tpu_torch.mor.reduced import sweep

    x = sweep(rm, config)
    c, cb = sys.coefficients(rm.domain)
    a_raw = (
        c[..., 0, None, None] * sys.a0
        + c[..., 1, None, None] * sys.a1
        + c[..., 2, None, None] * sys.a2
    )
    qx = torch.einsum("nk,ikm->inm", rm.q, x)
    res = a_raw @ qx - cb[:, None, None] * sys.b
    return torch.sqrt((res.abs() ** 2).sum(dim=(-1, -2)))
