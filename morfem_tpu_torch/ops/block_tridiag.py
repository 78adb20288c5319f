"""Block-tridiagonal direct solver — the banded `splu` of the large-N path.

Counterpart of `morfem_tpu/ops/block_tridiag.py`. A banded matrix with
half-bandwidth h, cut into blocks of size b ≥ h, is block-tridiagonal;
block-Thomas elimination is then a chain of dense b×b steps:

    S_0 = D_0,   S_i = D_i − L_i·S_{i−1}⁻¹·U_{i−1}       (factor)
    w_i = S_i⁻¹·(rhs_i − L_i·w_{i−1})                    (forward)
    x_i = w_i − S_i⁻¹U_i·x_{i+1}                         (backward)

The factor is f32 (explicit Schur-complement inverses, so every apply is
products only) with FP32 products (TF32 off — the reference's
`matmul_f32_accurate`), and the f64 refinement around it uses the f64
banded matvec for residuals, as in the reference. The reference's
`lax.scan` steps and `lax.while_loop` refinement are host loops over
device tensors here, with the same stopping rules.

When a Schur complement is near-singular (indefinite Helmholtz at a
resonance), `shifted_gmres_solve` escalates: GMRES preconditioned by the
same factorization of the complex-shifted matrix A − iσs·I, applied
through the real 2b embedding of each block, as the reference does.

``factorization="cr"`` takes block cyclic reduction instead of the
block-Thomas chain: ⌈log₂ nb⌉ levels, each one batched inverse of the raw
odd diagonal blocks and a few batched products (`cyclic_reduction_factor`),
with the same f64 refinement around it.

`solve_sweep_banded` is the full-order sweep of a prepared sparse pencil:
the block-Thomas factor and apply take a leading point axis, so a chunk of
points is factored step by step together, and refined together. There each
step's Schur complements are inverted together by the panel LU's kernels
(`_invert_points`: K1–K3 and K7, the substitutions on K2).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.ops.banded_matvec import combine_addends
from morfem_tpu_torch.ops.complex_split import real_embedding
from morfem_tpu_torch.ops.kernels import mm_words
from morfem_tpu_torch.ops.panel_lu import panel_lu_factor
from morfem_tpu_torch.ops.refine import host_norm, refine
from morfem_tpu_torch.utils.timing import host_read, span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _block_size(half: int) -> int:
    """The default block of a band of half-bandwidth ``half``: the
    smallest multiple of 128 at or above it."""
    return max(128, _round_up(half, 128))


class BandwidthError(ValueError):
    """Sparsity is not band-recoverable (RCM bandwidth over the limit).

    A dedicated type so callers fall back on exactly this condition
    without swallowing unrelated ValueErrors.
    """


def band_to_blocks(
    band: torch.Tensor, half: int, block: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-tridiagonal blocks (l, d, u) [nb, b, b] from diagonal storage.

    Requires ``block ≥ half``. Rows are padded to a multiple of ``block``
    with identity (padded Schur complements stay invertible); l[0] and
    u[-1] are zero. Block row I of A is [... L_I | D_I | U_I ...] at
    column offset (I−1)·b.
    """
    n, bw = band.shape
    b = block
    if b < half:
        raise ValueError(f"block ({b}) must be ≥ half-bandwidth ({half})")
    n_pad = _round_up(n, b)
    band_p = torch.zeros((n_pad, bw), dtype=band.dtype, device=band.device)
    band_p[:n] = band
    if n_pad > n:
        band_p[n:, half] = 1.0  # identity padding rows
    nb = n_pad // b
    band_rt = band_p.reshape(nb, b, bw)
    # W[I, r, b + r − half + j] = band_rt[I, r, j]: the [b, 3b] window of
    # block row I relative to column offset (I−1)·b
    w = torch.zeros((nb, b, 3 * b), dtype=band.dtype, device=band.device)
    rr = torch.arange(b, device=band.device)[:, None]
    cols = b + rr - half + torch.arange(bw, device=band.device)[None, :]
    w[:, rr, cols] = band_rt
    l = w[:, :, :b].clone()
    d = w[:, :, b:2 * b].clone()
    u = w[:, :, 2 * b:].clone()
    l[0] = 0.0  # the wrap-around edges index outside the matrix
    u[-1] = 0.0
    return l, d, u


class BlockTridiagFactors(NamedTuple):
    """f32 block-Thomas factors: g[i] = S_i⁻¹, h[i] = S_i⁻¹·U_i, plus L
    (of one point, or [G, nb, b, b] of G points)."""

    g: torch.Tensor  # [nb, b, b]
    h: torch.Tensor  # [nb, b, b]
    l: torch.Tensor  # [nb, b, b]
    n: int  # true (unpadded) row count


def _coupling_sets(l32: torch.Tensor, u32: torch.Tensor):
    """Each u[i]'s nonzero rows and each l[i]'s nonzero columns, as index
    tensors on the blocks' device ([nb] lists; a NaN counts as nonzero).
    Over leading point axes a row or column is in the set where any
    point's block has a nonzero in it.

    One batched reduction and one read of the 2·nb counts: a stable sort
    puts each block's nonzero indices first, in order, so each set is a
    slice of the sorted indices and no index is copied from the host.
    """
    nb, b = u32.shape[-3], u32.shape[-1]
    nz = torch.stack([
        (u32 != 0).any(dim=-1).reshape(-1, nb, b).any(dim=0),
        (l32 != 0).any(dim=-2).reshape(-1, nb, b).any(dim=0),
    ])
    order = torch.sort(nz.to(torch.uint8), dim=-1, descending=True,
                       stable=True).indices
    counts = host_read(torch.Tensor.tolist, nz.sum(dim=-1))
    return ([order[0, i, :k] for i, k in enumerate(counts[0])],
            [order[1, i, :k] for i, k in enumerate(counts[1])])


def _product_over(a: torch.Tensor, b: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """a @ b summed over the inner indices ``idx`` only (a's other columns
    or b's other rows are zero); all of them: the plain product."""
    if idx.numel() == a.shape[-1]:
        return a @ b
    return a.index_select(-1, idx) @ b.index_select(-2, idx)


def _schur_complement(l32: torch.Tensor, d32: torch.Tensor, h: torch.Tensor,
                      cols, i: int) -> torch.Tensor:
    """S_i = D_i − L_i·h_{i−1} of the block-Thomas factor (S_0 = D_0), the
    product over L_i's nonzero columns ``cols[i]`` only."""
    d_i = d32.select(-3, i)
    if i == 0 or not cols[i].numel():
        return d_i
    return d_i - _product_over(l32.select(-3, i), h.select(-3, i - 1),
                               cols[i])


def _inverse_each(s: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv_ex` of each matrix of [..., b, b] alone: a
    batched inverse of large blocks goes to another library (MAGMA on the
    card; MKL's batched LU stalls on some CPUs)."""
    if s.ndim == 2:
        return torch.linalg.inv_ex(s)[0]
    b = s.shape[-1]
    return torch.stack([torch.linalg.inv_ex(m)[0]
                        for m in s.reshape(-1, b, b)]).reshape(s.shape)


# Points a block step must hold for its Schur complements to be inverted
# together (`_invert_points`) instead of one by one (`_inverse_each`): the
# least G at which the batched route was the faster on an H100 at
# b = 3,456 (G = 1: 23.4 ms against 15.2; G = 2: 26.6 against 30.1;
# PERF.md §6).
POINTS_TO_BATCH = 2


def _substitute(x: torch.Tensor, lu: torch.Tensor, inv: torch.Tensor,
                a: int, b: int, lower: bool) -> None:
    """x[a:b] ← T⁻¹·x[a:b] in place, over the panels a..b of P rows.

    T is the unit-lower (``lower``) or the upper triangle of the packed
    LU ``lu`` [G, N, N], ``inv`` [G, nb, P, P] its inverted diagonal
    blocks (K7). The panels are halved recursively, so that the update of
    one half by the other is one large f32-true product (K2). The lower
    solve serves L⁻¹ only: x starts as the identity there, so its rows
    below panel b are zero right of column b·P and no product reads or
    writes those columns.
    """
    p = inv.shape[-1]
    if b - a == 1:
        rows = x[:, a * p:b * p, :b * p if lower else x.shape[-1]]
        rows.copy_(mm_words(inv[:, a], rows))
        return
    m = (a + b) // 2
    first, second = ((a, m), (m, b)) if lower else ((m, b), (a, m))
    _substitute(x, lu, inv, *first, lower)
    src = slice(first[0] * p, first[1] * p)
    dst = slice(second[0] * p, second[1] * p)
    w = m * p if lower else x.shape[-1]
    t = x[:, dst, :w]
    t.copy_(mm_words(lu[:, dst, src], x[:, src, :w], t=t, sign=-1))
    _substitute(x, lu, inv, *second, lower)


def _invert_points(s: torch.Tensor) -> torch.Tensor:
    """S⁻¹ of each matrix of s [G, b, b], all G together, by the panel LU's
    kernels: no library factorization or inverse.

    `panel_lu_factor` (partial pivoting over all rows, K1–K3, rows
    equilibrated to unit max, K7's diagonal-block inverses) gives
    P·E·S = L·U, with E the equilibration and P the pivot order. Then
    X = U⁻¹·L⁻¹ by two block substitutions against the identity
    (`_substitute`, f32-true on K2), and S⁻¹ = X·P·E: column ``perm[k]``
    of S⁻¹ is column k of X scaled by row ``perm[k]``'s equilibration.
    An exactly singular S gives non-finite entries for its point alone
    (K7 takes the reciprocal of its zero pivot; K1 divides by it).
    """
    f = panel_lu_factor(s)
    x = torch.zeros_like(f.lug)
    x.diagonal(dim1=1, dim2=2).fill_(1.0)
    nb = f.linv.shape[1]
    _substitute(x, f.lug, f.linv, 0, nb, lower=True)
    _substitute(x, f.lug, f.uinv, 0, nb, lower=False)
    g, n = s.shape[0], f.n
    cols = torch.argsort(f.perm, dim=1)[:, :n]
    return (torch.gather(x[:, :n], 2, cols[:, None, :].expand(g, n, n))
            * f.dinv[:, None, :n])


def block_tridiag_factor(l, d, u, n: int) -> BlockTridiagFactors:
    """Block-Thomas factorization in f32 (one dependent step per block).

    The blocks are [nb, b, b], or [G, nb, b, b] for G points factored
    together: each step then runs over the G points at once (the coupling
    products batched), and the coupling sets are the union of the points'
    (read once for all of them). A step of ``POINTS_TO_BATCH`` points or
    more inverts its G Schur complements together (`_invert_points`, the
    panel LU's kernels) and appends G to
    ``block_tridiag_factor.batched_inverses``; fewer points, and blocks
    without a point axis, invert each complement alone (`_inverse_each`,
    `torch.linalg.inv_ex`). Under a trace-mode `PhaseTimer` each step's
    inversion is a ``banded.invert`` span.

    Each coupling product runs over the coupling blocks' nonzero rows and
    columns only: with R_i the nonzero rows of U_i and C_i the nonzero
    columns of L_i,

        S_i = D_i − L_i[:, C_i]·h_{i−1}[C_i, :],   g_i = S_i⁻¹,
        h_i = g_i[:, R_i]·U_i[R_i, :]

    (so h_{i−1} = S_{i−1}⁻¹·U_{i−1} is formed once). An RCM-ordered band
    crosses each block edge in few rows, so the sums leave out exact
    zeros only; a full set takes the plain product, an empty one none.
    The share of the coupling kept, Σ|C_i| + Σ|R_i| over the 2·(nb−1)·b
    of the full products (L_0 and U_{nb−1} lie outside the matrix), is
    appended to ``block_tridiag_factor.coupling_share``.

    An exactly singular Schur complement does not raise: its inverse comes
    back non-finite (`torch.linalg.inv_ex`, as the reference's
    `jnp.linalg.inv`; on the batched route for its point alone), so the
    refinement's residual turns NaN and the callers escalate to the
    shifted solve. Neither route reads a block's `info` on the host, as
    `inv` does on the card.
    """
    f32 = torch.float32
    l32, d32, u32 = l.to(f32), d.to(f32), u.to(f32)
    nb, b = d32.shape[-3], d32.shape[-1]
    batched = d32.ndim == 4 and d32.shape[0] >= POINTS_TO_BATCH
    rows, cols = _coupling_sets(l32, u32)
    g = torch.empty_like(d32)
    h = torch.empty_like(d32)
    for i in range(nb):
        r, g_i, h_i = rows[i], g.select(-3, i), h.select(-3, i)
        s = _schur_complement(l32, d32, h, cols, i)
        with span("banded.invert"):
            if batched:
                g_i.copy_(_invert_points(s))
                block_tridiag_factor.batched_inverses.append(s.shape[0])
            else:
                g_i.copy_(_inverse_each(s))
        if r.numel():
            h_i.copy_(_product_over(g_i, u32.select(-3, i), r))
        else:
            h_i.zero_()
    full = 2 * (nb - 1) * b
    kept = sum(c.numel() for c in cols[1:]) + sum(
        r.numel() for r in rows[:-1])
    block_tridiag_factor.coupling_share.append(kept / full if full else 1.0)
    return BlockTridiagFactors(g=g, h=h, l=l32, n=n)


block_tridiag_factor.coupling_share = []
block_tridiag_factor.batched_inverses = []


def reset_factor_counters() -> None:
    """Empty the block-Thomas factor's lists of coupling shares and of
    Schur complements inverted together."""
    block_tridiag_factor.coupling_share = []
    block_tridiag_factor.batched_inverses = []


def block_tridiag_apply(factors: BlockTridiagFactors,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Approximate A⁻¹·rhs with the factors (f32); rhs [N, M] → [N, M],
    or [G, N, M] → [G, N, M] with factors of G points."""
    g, h, l, n = factors
    nb, b = g.shape[-3], g.shape[-1]
    lead, m = g.shape[:-3], rhs.shape[-1]
    r = torch.zeros((*lead, nb * b, m), dtype=torch.float32, device=g.device)
    r[..., :n, :] = rhs[..., :n, :]
    r = r.reshape(*lead, nb, b, m)
    w = torch.empty_like(r)
    for i in range(nb):
        r_i = r.select(-3, i)
        if i:
            r_i = r_i - l.select(-3, i) @ w.select(-3, i - 1)
        w.select(-3, i).copy_(g.select(-3, i) @ r_i)
    x = torch.empty_like(r)
    x.select(-3, nb - 1).copy_(w.select(-3, nb - 1))
    for i in range(nb - 2, -1, -1):
        x.select(-3, i).copy_(
            w.select(-3, i) - h.select(-3, i) @ x.select(-3, i + 1))
    return x.reshape(*lead, nb * b, m)[..., :n, :]


class CRLevel(NamedTuple):
    """One cyclic-reduction level (all arrays batched over block index)."""

    a: torch.Tensor  # [h, b, b] = L_even·D_odd_left⁻¹
    bm: torch.Tensor  # [h, b, b] = U_even·D_odd_right⁻¹
    dinv: torch.Tensor  # [h, b, b] = D_odd⁻¹
    lo: torch.Tensor  # [h, b, b] odd-block L (for back-substitution)
    uo: torch.Tensor  # [h, b, b] odd-block U


class CRFactors(NamedTuple):
    levels: Tuple  # CRLevel per reduction level
    dinv_root: torch.Tensor  # [b, b] inverse of the final single block
    n: int  # true row count


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x[k] → x[k−1] with a leading zero block (batched)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def cyclic_reduction_factor(l, d, u, n: int) -> CRFactors:
    """Block cyclic reduction in f32: each level eliminates every ODD
    block at once,

        D'_k = D_2k − L_2k·D_2k−1⁻¹·U_2k−1 − U_2k·D_2k+1⁻¹·L_2k+1
        L'_k = −L_2k·D_2k−1⁻¹·L_2k−1,   U'_k = −U_2k·D_2k+1⁻¹·U_2k+1

    so a level is one batched inverse and a few batched products, and
    ⌈log₂ nb⌉ levels exist. The RAW odd diagonal blocks are inverted (no
    Schur complement stands between them and a near-singular block, so
    this is more fragile than block Thomas on indefinite pencils). Odd
    block counts are padded with decoupled identity blocks.
    """
    f32 = torch.float32
    l, d, u = l.to(f32), d.to(f32), u.to(f32)
    levels = []
    while d.shape[0] > 1:
        if d.shape[0] % 2:
            eye = torch.eye(d.shape[-1], dtype=f32, device=d.device)[None]
            l = torch.cat([l, torch.zeros_like(l[:1])], dim=0)
            u = torch.cat([u, torch.zeros_like(u[:1])], dim=0)
            d = torch.cat([d, eye], dim=0)
        lo, do, uo = l[1::2], d[1::2], u[1::2]
        le, de, ue = l[0::2], d[0::2], u[0::2]
        dinv = torch.linalg.inv_ex(do)[0]  # one batched inverse per level
        a = le @ _shift_down(dinv)  # L_even·D_left⁻¹ (k=0 row → 0)
        bm = ue @ dinv  # U_even·D_right⁻¹
        levels.append(CRLevel(a=a, bm=bm, dinv=dinv, lo=lo, uo=uo))
        l = -(a @ _shift_down(lo))
        d = de - a @ _shift_down(uo) - bm @ lo
        # the last even block's right neighbour is the (zero) boundary
        u = torch.zeros_like(uo)
        u[:-1] = -(bm[:-1] @ uo[:-1])
    return CRFactors(levels=tuple(levels),
                     dinv_root=torch.linalg.inv_ex(d[0])[0], n=n)


def cyclic_reduction_apply(factors: CRFactors,
                           rhs: torch.Tensor) -> torch.Tensor:
    """Approximate A⁻¹·rhs with the CR factors (f32); rhs [N, M] → [N, M].

    Forward: per level, fold the odd rows into the even system. Backward:
    recover the odd rows by one batched product per level.
    """
    b = factors.dinv_root.shape[-1]
    m = rhs.shape[1]
    n = factors.n
    nb0 = factors.levels[0].dinv.shape[0] * 2 if factors.levels else 1
    r = torch.zeros((nb0 * b, m), dtype=torch.float32,
                    device=factors.dinv_root.device)
    r[:n] = rhs[:n]
    r = r.reshape(nb0, b, m)
    saved = []
    for lev in factors.levels:
        if r.shape[0] % 2:
            r = torch.cat([r, torch.zeros_like(r[:1])], dim=0)
        ro, re = r[1::2], r[0::2]
        saved.append(ro)
        r = re - lev.a @ _shift_down(ro) - lev.bm @ ro
    x = factors.dinv_root[None] @ r  # [1, b, m]
    for lev, ro in zip(reversed(factors.levels), reversed(saved)):
        h = lev.dinv.shape[0]
        x_even = x[:h]
        x_next = torch.cat([x_even[1:], torch.zeros_like(x_even[:1])], dim=0)
        x_odd = lev.dinv @ (ro - lev.lo @ x_even - lev.uo @ x_next)
        x = torch.stack([x_even, x_odd], dim=1).reshape(2 * h, b, m)
    return x.reshape(-1, m)[:n]


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x))


def banded_direct_solve(
    op,
    c: torch.Tensor,
    rhs: torch.Tensor,
    config: MorfemConfig = DEFAULT_CONFIG,
    block=None,
    refine_iterations: int = 30,
    factorization: str = "scan",
    tol=None,
):
    """Direct banded solve of A(c)·x = rhs + adaptive f64 refinement.

    Works on INDEFINITE in-band Helmholtz operators where Jacobi-Krylov
    stagnates. Returns (x, relres [M], iterations). ``tol`` is a relative
    residual target (refinement stops at tol·‖rhs‖); None refines to
    working precision. Refinement stops when the residual is below target,
    stops improving by 3 %, or after ``refine_iterations`` steps.
    ``factorization``: "scan" (block Thomas, the default) or "cr" (cyclic
    reduction).

    Under a trace-mode `PhaseTimer` the factor (the combined band, its
    blocks and their factorization) is a ``banded.factor`` span, each
    refinement pass a ``banded.refine`` span, and each residual norm read
    back a ``host sync``.
    """
    if factorization not in ("scan", "cr"):
        raise ValueError(f"factorization must be 'scan' or 'cr', got "
                         f"{factorization!r}")
    with span("banded.factor"):
        blocks = op.blocks(c, block or _block_size(op.half))
        if factorization == "cr":
            factors = cyclic_reduction_factor(*blocks, op.n)
            apply = cyclic_reduction_apply
        else:
            factors = block_tridiag_factor(*blocks, op.n)
            apply = block_tridiag_apply
        del blocks
    mv = op.bind_precise(c)

    def apply_factor(r):
        return apply(factors, r).to(rhs.dtype)

    x = apply_factor(rhs)
    b_norm = torch.linalg.norm(rhs, dim=0)
    tot_norm = host_read(_norm, rhs)
    abs_tol = 10 * torch.finfo(rhs.dtype).eps * tot_norm
    if tol is not None:
        abs_tol = max(abs_tol, tol * tot_norm)
    x, r, _, it = refine(
        x, lambda x: rhs - mv(x), apply_factor, abs_tol, refine_iterations,
        norm=lambda r: host_read(_norm, r), stop=0.97,
        span_name="banded.refine",
    )
    relres = torch.linalg.norm(r, dim=0) / torch.clamp(b_norm, min=1e-300)
    return x, relres, it


def solve_sweep_banded(sys, config: MorfemConfig = DEFAULT_CONFIG):
    """Full-order sweep of a prepared sparse pencil (`mor/api.py::
    MatfreeSystem`) → x [I, N, M] in the caller's row order.

    A banded operator is swept in chunks of ``config.solve_chunk`` points
    (the last padded with copies of the last point, as `solve_sweep_panel`
    pads). Per chunk: each point's f32 blocks (`BandedAffineOperator.
    blocks`), one block-Thomas factor with the point axis batched, its
    apply to the chunk's right-hand sides, then one f64 refinement of the
    whole chunk (`_solve_chunk`). A GMRES-route pencil (a
    `GeneralSparseOperator`, after a `BandwidthError`) is swept point by
    point by `solve_point_iterative` (``method="general"``).

    Plain counters, as `solve_sweep_panel` keeps them: ``chunk_iterations``
    gets each chunk's refinement passes, in order, and ``escalations``
    counts the points escalated; `reset_banded_sweep_counters` zeroes
    them. Under a trace-mode `PhaseTimer` each chunk is a ``banded.chunk``
    span holding a ``banded.factor`` (the blocks and their factor), the
    ``banded.refine`` passes and, around the fallback,
    ``banded.escalate``; each read of a norm or of the coupling counts is
    a ``host sync``.
    """
    from morfem_tpu_torch.ops.sparse import solve_point_iterative

    op, work = sys.op, sys.b.dtype
    i_pts = int(sys.domain.shape[0])
    if hasattr(op, "bands_w"):
        chunk = max(1, min(config.solve_chunk, i_pts))
        pad = (-i_pts) % chunk
        ts_all = torch.cat([sys.domain, sys.domain[-1:].expand(pad)])
        xs = []
        for start in range(0, i_pts, chunk):
            with span("banded.chunk"):
                x, steps = _solve_chunk(
                    sys, ts_all[start:start + chunk],
                    min(chunk, i_pts - start), config)
            xs.append(x)
            solve_sweep_banded.chunk_iterations.append(steps)
        x = torch.cat(xs)[:i_pts]
    else:
        c, cb = sys.coefficients(sys.domain)
        x = torch.stack([
            solve_point_iterative(op, c_i.to(work), cb_i.to(work) * sys.b,
                                  method="general")
            for c_i, cb_i in zip(c, cb)])
    out = torch.empty_like(x)
    out[:, sys.perm] = x
    return out


def _solve_chunk(sys, ts, real: int, config: MorfemConfig):
    """x [G, N, M] of one chunk of a banded sweep (operator row order) and
    its refinement passes; ``real``: the chunk's points that are not
    padding.

    The refinement is `ops/refine.py::refine` over the whole chunk, as in
    `solve_sweep_panel`: to 10·ε·‖b‖ of the chunk's right-hand sides,
    stopping when a pass cuts ‖r‖ by less than 3 % (the banded solves'
    rule) or after ``config.refine_iterations`` passes. Its residual
    applies each nonzero addend once to the chunk's stacked solutions
    [N, G·M] (`apply_addend`, f64). A chunk left above max(10·ε·‖b‖,
    1e-9·‖b‖), or NaN (an exactly singular Schur complement), escalates:
    each of its points is solved again by the shifted GMRES that the
    greedy escalates to (`shifted_gmres_solve`).
    """
    op, work = sys.op, sys.b.dtype
    c, cb = sys.coefficients(ts)
    c, cb = c.to(work), cb.to(work)
    rhs = cb[:, None, None] * sys.b  # [G, N, M]
    with span("banded.factor"):
        factors = block_tridiag_factor(
            *op.blocks(c, _block_size(op.half)), op.n)

    def residual(x):
        g, n, m = x.shape
        xf = x.transpose(0, 1).reshape(n, g * m)
        ax = torch.zeros((n, g, m), dtype=work, device=x.device)
        for p in op.nonzero_addends:
            ax += c[:, p, None] * op.apply_addend(p, xf).reshape(n, g, m)
        return rhs - ax.transpose(0, 1)

    def apply(r):
        return block_tridiag_apply(factors, r).to(work)

    b_norm = host_norm(rhs)
    tol = 10 * torch.finfo(work).eps * b_norm
    x, _, r_norm, steps = refine(
        apply(rhs), residual, apply, tol, config.refine_iterations,
        norm=host_norm, stop=0.97, span_name="banded.refine",
    )
    # "not <=" so that a NaN residual escalates too
    if not r_norm <= max(tol, 1e-9 * b_norm):
        with span("banded.escalate"):
            for g in range(real):
                x[g] = shifted_gmres_solve(op, c[g], rhs[g], tol=1e-10,
                                           maxiter=60)[0]
        solve_sweep_banded.escalations += real
    return x, steps


def reset_banded_sweep_counters() -> None:
    """Zero the refinement and escalation counters of the banded sweep."""
    solve_sweep_banded.chunk_iterations = []
    solve_sweep_banded.escalations = 0


reset_banded_sweep_counters()


def shifted_block_precond(op, c: torch.Tensor, sigma: float = 1e-5,
                          block=None):
    """Preconditioner P(r) = Re((A − iσs)⁻¹ r) via the embedded factors.

    s = max |diag A(c)|, so σ is dimensionless. The shift bounds every
    Schur complement away from singular, so the elimination cannot break
    down even exactly at a resonance; for symmetric A, Re((A − iσs)⁻¹)·A
    has eigenvalues λ²/(λ² + σ²s²), clustered at 1. Each complex block
    Z = X + iY is factored through its real image [[X, −Y], [Y, X]]
    (blocks of 2b, still block-tridiagonal), as in the reference.

    Returns (precond_fn [N, M] → [N, M], factors).
    """
    band_t = combine_addends(c, op.bands_w)
    b = block or _block_size(op.half)
    l, d, u = band_to_blocks(band_t, op.half, b)
    shift = sigma * float(op.diagonal(c).abs().max())
    nb = d.shape[0]
    zero = torch.zeros_like(d)
    eye = torch.eye(b, dtype=d.dtype, device=d.device).expand_as(d)
    factors = block_tridiag_factor(
        real_embedding(l, zero), real_embedding(d, -shift * eye),
        real_embedding(u, zero), nb * 2 * b,
    )
    n = op.n

    def precond(r):
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        m = r.shape[1]
        re = torch.zeros((nb * b, m), dtype=r.dtype, device=r.device)
        re[:n] = r
        re_blocks = re.reshape(nb, b, m)
        rhs_e = torch.cat([re_blocks, torch.zeros_like(re_blocks)],
                          dim=1).reshape(nb * 2 * b, m)
        xe = block_tridiag_apply(factors, rhs_e).to(r.dtype)
        x_re = xe.reshape(nb, 2 * b, m)[:, :b].reshape(nb * b, m)[:n]
        return x_re[:, 0] if squeeze else x_re

    return precond, factors


def _csr_list(operands):
    import scipy.sparse as sp

    return [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
            for m in operands]


def banded_via_rcm(*operands, symmetrize: bool = True, max_half: int = 2048,
                   device="cuda"):
    """Wrap a general sparse pencil as a banded operator via RCM reordering.

    Returns (op: BandedAffineOperator on the permuted pencil, perm [N]
    long tensor on op's device). Solve with the permuted rhs and scatter
    back: ``x = zeros_like(x_p); x[perm] = x_p``.

    Raises `BandwidthError` when the reordered half-bandwidth exceeds
    ``max_half``.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator

    mats = _csr_list(operands)
    pattern = sum(abs(m).tocsr() for m in mats)
    pattern = (pattern + pattern.T).tocsr()  # RCM wants symmetric structure
    perm = np.ascontiguousarray(
        reverse_cuthill_mckee(pattern, symmetric_mode=True))
    permuted = [m.tocsr()[perm][:, perm] for m in mats]
    coo = sum(abs(m) for m in permuted).tocoo()
    half = int(np.max(np.abs(coo.row - coo.col))) if coo.nnz else 0
    if half > max_half:
        raise BandwidthError(
            f"RCM-reordered half-bandwidth {half} exceeds {max_half} — "
            "sparsity is not band-recoverable; use the Krylov path"
        )
    op = BandedAffineOperator(*permuted, symmetrize=symmetrize,
                              device=device)
    return op, torch.as_tensor(perm, dtype=torch.long, device=op.device)


def rcm_direct_solve(a0, a1, a2, c, rhs, config: MorfemConfig = DEFAULT_CONFIG,
                     device="cuda", **kwargs):
    """One-call general-sparse direct solve: RCM → banded elimination →
    un-permute. Returns (x, relres, iterations)."""
    op, perm = banded_via_rcm(a0, a1, a2, symmetrize=config.symmetrize,
                              device=device)
    rhs = torch.as_tensor(rhs, device=op.device)
    c = torch.as_tensor(c, device=op.device)
    x_p, relres, iters = banded_direct_solve(op, c, rhs[perm], config=config,
                                             **kwargs)
    x = torch.zeros_like(x_p)
    x[perm] = x_p
    return x, relres, iters


def truncated_band_via_rcm(*operands, symmetrize: bool = True,
                           band_half: int = 1024, device="cuda"):
    """RCM + band TRUNCATION for non-band-recoverable sparsity.

    Builds, on one permutation (RCM or the identity, whichever leaves less
    absolute mass outside the band):
      * an exact operator for applies and residuals — dense-block BSR when
        the pattern blocks well (inflation ≤ 32), else ELL slots (inflation
        ≤ 8), else element-wise CSR;
      * a `BandedAffineOperator` truncated to ``band_half``, whose shifted
        block-tridiagonal factorization preconditions GMRES
        (`general_sparse_solve`).

    Returns (exact_op, band_op, perm, dropped): ``dropped`` is the
    fraction of absolute mass outside the kept band.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.block_sparse import BlockSparseAffineOperator
    from morfem_tpu_torch.ops.ell import ELLAffineOperator
    from morfem_tpu_torch.ops.sparse import SparseAffineOperator

    mats = _csr_list(operands)
    pattern = sum(abs(m).tocsr() for m in mats)
    pattern = (pattern + pattern.T).tocsr()
    n = pattern.shape[0]

    def out_of_band_frac(perm):
        permuted = sum(abs(m).tocsr()[perm][:, perm] for m in mats).tocoo()
        total = float(permuted.data.sum()) or 1.0
        out = float(
            permuted.data[np.abs(permuted.row - permuted.col) > band_half]
            .sum()
        )
        return out / total

    # RCM helps scrambled mesh-graph sparsity but hurts expander-like
    # patterns; keep whichever ordering leaves less mass outside the band
    perm_rcm = np.ascontiguousarray(
        reverse_cuthill_mckee(pattern, symmetric_mode=True))
    perm_id = np.arange(n)
    d_rcm = out_of_band_frac(perm_rcm)
    d_id = out_of_band_frac(perm_id)
    perm, dropped = (perm_rcm, d_rcm) if d_rcm <= d_id else (perm_id, d_id)
    permuted = [m.tocsr()[perm][:, perm] for m in mats]
    band_op = BandedAffineOperator(*permuted, symmetrize=symmetrize,
                                   bandwidth=band_half, device=device)
    exact_op = BlockSparseAffineOperator(*permuted, symmetrize=symmetrize,
                                         device=device)
    if exact_op.inflation > 32.0:
        exact_op = ELLAffineOperator(*permuted, symmetrize=symmetrize,
                                     device=device)
        if exact_op.inflation > 8.0:
            exact_op = SparseAffineOperator(*permuted, symmetrize=symmetrize,
                                            device=device)
    return (exact_op, band_op,
            torch.as_tensor(perm, dtype=torch.long, device=band_op.device),
            dropped)


def general_sparse_solve(exact_op, band_op, c, rhs, sigma: float = 1e-4,
                         block=None, tol: float = 1e-10, maxiter: int = 80,
                         restart: int = 32):
    """GMRES on the EXACT operator, preconditioned by the shifted block-direct
    factorization of the in-band part (`shifted_block_precond` on the
    truncated `band_op`). Returns (x, relres [M])."""
    from morfem_tpu_torch.ops.krylov import gmres

    precond, _ = shifted_block_precond(band_op, c, sigma=sigma, block=block)
    return gmres(lambda x: exact_op.matvec(c, x), rhs, precond=precond,
                 tol=tol, maxiter=maxiter, restart=restart)


def shifted_gmres_solve(op, c, rhs, sigma: float = 1e-5, block=None,
                        tol: float = 1e-10, maxiter: int = 40,
                        restart: int = 32):
    """GMRES on A(c)·x = rhs with the shifted-block-direct preconditioner:
    the robust path for banded systems at or near a resonance, where the
    unshifted elimination's refinement stalls. Returns (x, relres [M])."""
    from morfem_tpu_torch.ops.krylov import gmres

    precond, _ = shifted_block_precond(op, c, sigma=sigma, block=block)
    return gmres(op.bind_precise(c), rhs, precond=precond, tol=tol,
                 maxiter=maxiter, restart=restart)
