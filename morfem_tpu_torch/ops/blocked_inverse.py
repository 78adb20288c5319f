"""Blocked Gauss–Jordan inverse in f32 — the ``factorization="gj"`` backend.

Counterpart of `morfem_tpu/ops/blocked_inverse.py` (plain XLA there, no
Pallas kernel; plain PyTorch here). It computes an explicit approximate
inverse by Gauss–Jordan elimination with partial pivoting, organised so
the O(N³) work is rank-`panel` products:

  * pivoting WITHOUT row swaps: a pivot-availability mask drives each
    column's arg-max, and rows are never exchanged;
  * the composed elimination transform of a block of columns is kept as
    coefficients C with G = I + C·E (E selects the pivot rows), like a
    product of elementary Gauss–Jordan transforms;
  * two-level blocking: width-`sub` inner blocks propagate into their
    `panel` by one product each, and panels into the full matrix;
  * the final row and column permutations are undone by two gathers.

Rows are equilibrated to unit max first (the stored G − I holds 1/piv − 1
at each pivot, and for |piv| ≫ 1 the 1/piv would be lost to the −1 in
f32); A = D·B ⇒ A⁻¹ = B⁻¹·D⁻¹ is undone on the columns at the end.

The column steps are a host loop of small device operations (about N
steps, each a handful of launches), where the reference runs a
`fori_loop`; the products are plain `@` in FP32 with TF32 off, which is
f32-true where the reference needs its 3-word `matmul_f32_accurate`
(`NUMERICS.md` row 33).
Accuracy: relative error ~cond(A)·ε_f32, as an f32 LU; the f64 refinement
in `ops/solve.py::gj_solve_refined` contracts it to working precision.
"""

from __future__ import annotations

import torch


def gj_panel_factor(pb: torch.Tensor, avail: torch.Tensor, sub: int):
    """Factor ONE column panel of the elimination.

    pb [n, panel] or [B, n, panel] f32 (the panel's columns of the partly
    eliminated matrix), avail [n] or [B, n] bool (rows not yet used as
    pivots). Returns (cp, pivpanel, avail) with the same leading axes: the
    composed coefficients of the panel's columns (G_panel = I + cp·E),
    the pivot row of each column (int64), and the updated mask.
    """
    if pb.ndim == 2:
        cp, pivpanel, avail = gj_panel_factor(pb[None], avail[None], sub)
        return cp[0], pivpanel[0], avail[0]
    bsz, n, panel = pb.shape
    pb = pb.clone()
    avail = avail.clone()
    cp = torch.zeros_like(pb)
    pivpanel = torch.zeros((bsz, panel), dtype=torch.long, device=pb.device)
    batch = torch.arange(bsz, device=pb.device)
    # device scalars made by fills, not copied from the host, so that a
    # CUDA graph can capture the loop
    neg_inf = torch.full((), -float("inf"), dtype=pb.dtype, device=pb.device)
    used = torch.zeros((), dtype=torch.bool, device=pb.device)
    for s0 in range(0, panel, sub):
        s1 = s0 + sub
        blk = pb[:, :, s0:s1].clone()
        cs = torch.zeros_like(blk)
        pivlocal = torch.zeros((bsz, sub), dtype=torch.long,
                               device=pb.device)
        for i in range(sub):
            col = blk[:, :, i]
            p = torch.where(avail, col.abs(), neg_inf).argmax(dim=1)
            piv = col[batch, p]
            c = -col / piv[:, None]
            c[batch, p] = 1.0 / piv - 1.0
            # eliminate in the block's later columns, and compose into
            # the coefficients already produced
            blk[:, :, i + 1:] += c[:, :, None] * blk[batch, p, None, i + 1:]
            cs[:, :, :i] += c[:, :, None] * cs[batch, p, None, :i]
            cs[:, :, i] = c
            avail[batch, p] = used
            pivlocal[:, i] = p
        rows_pb = pb[batch[:, None], pivlocal]  # [B, sub, panel]
        rows_cp = cp[batch[:, None], pivlocal]
        pb[:, :, s1:] += cs @ rows_pb[:, :, s1:]
        cp[:, :, :s0] += cs @ rows_cp[:, :, :s0]
        cp[:, :, s0:s1] = cs
        pivpanel[:, s0:s1] = pivlocal
    return cp, pivpanel, avail


def _gj_inverse_batch(a32: torch.Tensor, panel: int, sub: int):
    """Inverses of a batch of padded f32 matrices [B, n, n] (n a multiple
    of `panel`)."""
    bsz, n, _ = a32.shape
    m = a32.clone()
    avail = torch.ones((bsz, n), dtype=torch.bool, device=a32.device)
    pivrows = torch.zeros((bsz, n), dtype=torch.long, device=a32.device)
    batch = torch.arange(bsz, device=a32.device)[:, None]
    for j0 in range(0, n, panel):
        j1 = j0 + panel
        cp, pivpanel, avail = gj_panel_factor(m[:, :, j0:j1], avail, sub)
        m = m + cp @ m[batch, pivpanel]
        m[:, :, j0:j1] = cp
        pivrows[:, j0:j1] = pivpanel
    # unscramble: G = I + C_all·E with E[j, :] = e_{p_j}ᵀ and G·A = P
    # (P[p_j, j] = 1), so A⁻¹ = Pᵀ·G; column c of G is e_c + C[:, step(c)]
    # with step(c) the elimination step that pivoted row c
    steps = torch.arange(n, device=a32.device).expand(bsz, n)
    inv_perm = torch.empty_like(pivrows).scatter_(1, pivrows, steps)
    g = m[batch, :, inv_perm].transpose(1, 2)
    g = g + torch.eye(n, dtype=torch.float32, device=a32.device)
    return g[batch, pivrows]


def gj_inverse_f32(a: torch.Tensor, panel: int = 256,
                   sub: int = 8) -> torch.Tensor:
    """Approximate f32 inverse via blocked pivot-masked Gauss–Jordan.

    a: [..., N, N] real matrices (any float dtype; computed in f32).
    panel: outer block width, the rank of the full-width updates; sub:
    inner block width of the sequential column steps. Returns [..., N, N]
    f32 (relative error ~cond·ε_f32; refine for working precision).
    """
    if a.is_complex():
        raise ValueError("gj_inverse_f32 inverts real matrices only")
    n0 = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != n0:
        raise ValueError(f"square matrices required, got {tuple(a.shape)}")
    panel = max(sub, min(panel, ((n0 + sub - 1) // sub) * sub))
    # a panel that is not a multiple of `sub` is rounded up, so no
    # column is left out of the inner blocks
    panel = ((panel + sub - 1) // sub) * sub
    n = ((n0 + panel - 1) // panel) * panel
    lead = a.shape[:-2]
    a32 = a.reshape(-1, n0, n0).to(torch.float32)
    d = a32.abs().amax(dim=-1)
    d = torch.where(d == 0, torch.ones_like(d), d)
    a32 = a32 / d[:, :, None]
    if n != n0:
        padded = torch.zeros((a32.shape[0], n, n), dtype=torch.float32,
                             device=a.device)
        padded[:, :n0, :n0] = a32
        padded[:, n0:, n0:] = torch.eye(n - n0, dtype=torch.float32,
                                        device=a.device)
        a32 = padded
    out = _gj_inverse_batch(a32, panel, sub)[:, :n0, :n0] / d[:, None, :]
    return out.reshape(*lead, n0, n0)
