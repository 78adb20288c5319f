"""Distributed banded DIRECT solves over the tp axis — the SPIKE design.

Counterpart of `morfem_tpu/parallel/tp_banded.py`, under the whole-in,
whole-out contract of `parallel/sharded.py`. Beyond one card,
`parallel/tp_solve.py`'s row-sharded Krylov inherits Jacobi's weakness on
strongly indefinite in-band Helmholtz pencils; here the banded
factorization itself is distributed:

  * The rows are cut into `tp` contiguous partitions of n_loc rows, a
    multiple of the block-Thomas block b = max(128, round_up(h, 128)), so
    `band_to_blocks` never pads between partitions (identity rows pad the
    last). Each rank factors its LOCAL diagonal block A_j with the f32
    block-Thomas factor (`ops/block_tridiag.py`) and solves three
    right-hand sides at once: its rhs rows, and the coupling columns
    [0…0; B_j] (to the next partition) and [C_j; 0…0] (to the previous),
    whose solutions are the SPIKES V_j and W_j.
  * Only the top and bottom h rows of the spikes couple partitions: the
    reduced system x_j^{t,b} + V_j^{t,b}·x_{j+1}^t + W_j^{t,b}·x_{j-1}^b =
    g_j^{t,b} has 2·h·tp unknowns. One all_gather of each rank's
    [2h, M + 2h] interface rows (rhs, V, W) gives every rank the whole
    reduced system, which each solves replicated (one f32 inverse, reused
    by every refinement step).
  * Recovery is local: x_j = g_j − V_j·z_{j+1}^t − W_j·z_{j-1}^b.
  * Factor and applies are f32; GLOBAL f64 iterative refinement restores
    working precision. Its residual is a distributed banded matvec: each
    rank multiplies its strip of the band, with h halo rows of x on each
    side, by `banded_matvec_ref` (the working-dtype matvec of the
    single-card path, per diagonal or blocked by bandwidth); the residual
    norm is one all_reduce of column sums of squares.

The refinement stops below tol, when the residual stops falling by 5 %,
or after `refine_iterations` steps, as in the reference. A partition whose
local block is singular gives non-finite factors (`block_tridiag_factor`
uses `inv_ex`): the residual turns NaN, the refinement stops, and callers
escalate as on the single-card path. A result depends on the partition
count: compare runs at the same tp size.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from morfem_tpu_torch.ops.banded_matvec import (
    BandedAffineOperator,
    banded_matvec_ref,
    combine_addends,
)
from morfem_tpu_torch.ops.block_tridiag import (
    band_to_blocks,
    block_tridiag_apply,
    block_tridiag_factor,
)
from morfem_tpu_torch.ops.refine import refine
from morfem_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _coupling_blocks(band_loc: torch.Tensor, half: int):
    """(in-range band, C [h, h], B [h, h]) of a partition's band rows.

    band_loc [n_loc, 2h+1]: entry (r, d) addresses LOCAL column r − h + d;
    entries outside [0, n_loc) belong to the neighbours. C holds rows
    0..h's couplings to the LAST h columns of the previous partition,
    C[r, c] = band_loc[r, c − r] (c ≥ r); B holds rows n_loc−h..'s
    couplings to the FIRST h columns of the next partition,
    B[r', c] = band_loc[n_loc−h+r', c + 2h − r'] (c ≤ r'). For the first
    and last partition those entries are zero in the global band storage.
    """
    n_loc, bw = band_loc.shape
    h = half
    dev = band_loc.device
    r = torch.arange(n_loc, device=dev)[:, None]
    dd = torch.arange(bw, device=dev)[None, :]
    lcol = r - h + dd
    band_in = torch.where((lcol >= 0) & (lcol < n_loc), band_loc,
                          torch.zeros_like(band_loc))
    rr = torch.arange(h, device=dev)[:, None]
    cc = torch.arange(h, device=dev)[None, :]

    def pick(rows, d):
        ok = (d >= 0) & (d < bw)
        vals = torch.gather(rows, 1, d.clamp(0, bw - 1))
        return torch.where(ok, vals, torch.zeros_like(vals))

    cmat = pick(band_loc[:h], cc - rr)
    bmat = pick(band_loc[n_loc - h:], cc + 2 * h - rr)
    return band_in, cmat, bmat


def _reduced_matrix(vt, vb, wt, wb, p: int, h: int) -> torch.Tensor:
    """The [2hp, 2hp] SPIKE reduced system (f32), unknowns ordered
    z = [x_0^t, x_0^b, x_1^t, x_1^b, …]."""
    red = torch.eye(2 * h * p, dtype=torch.float32, device=vt.device)

    def blk(j, s):  # start row/col of block (partition j, side s: 0=t, 1=b)
        return slice((2 * j + s) * h, (2 * j + s + 1) * h)

    for j in range(p):
        if j + 1 < p:
            red[blk(j, 0), blk(j + 1, 0)] += vt[j]
            red[blk(j, 1), blk(j + 1, 0)] += vb[j]
        if j > 0:
            red[blk(j, 0), blk(j - 1, 1)] += wt[j]
            red[blk(j, 1), blk(j - 1, 1)] += wb[j]
    return red


def _interfaces(y: torch.Tensor, h: int) -> torch.Tensor:
    """[2h, K]: the top and bottom h rows of a partition's block."""
    return torch.cat([y[:h], y[-h:]])


def spike_solve(
    band: torch.Tensor,  # [N, 2h+1] working-dtype diagonal storage
    half: int,
    rhs: torch.Tensor,  # [N, M] working dtype
    mesh,
    axis: str = "tp",
    tol: float = 1e-10,
    refine_iterations: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Distributed banded direct solve of A·x = rhs over `mesh[axis]`.

    f32 SPIKE factorization (local block-Thomas factors + replicated
    reduced system) + global f64 iterative refinement. Returns (x [N, M],
    relres [M], iterations) — the contract of
    `ops/block_tridiag.banded_direct_solve`.
    """
    p = axis_size(mesh, axis)
    j = axis_index(mesh, axis)
    n, bw = band.shape
    h = half
    if bw != 2 * h + 1:
        raise ValueError(f"band width {bw} != 2·half+1 = {2 * h + 1}")
    work = torch.promote_types(band.dtype, rhs.dtype)
    m = rhs.shape[1]
    f32 = torch.float32
    dev = band.device

    b = max(128, _round_up(h, 128))
    n_loc = _round_up(max(math.ceil(n / p), b), b)
    j0 = j * n_loc
    rows = slice(j0, j0 + n_loc)
    band_p = torch.zeros((p * n_loc, bw), dtype=work, device=dev)
    band_p[:n] = band
    band_p[n:, h] = 1.0  # identity pad rows, decoupled
    rhs_p = torch.zeros((p * n_loc, m), dtype=work, device=dev)
    rhs_p[:n] = rhs
    band_loc, rhs_loc = band_p[rows], rhs_p[rows]

    # ---- stage 1: local factor + spikes (f32) ----------------------------
    band_in, cmat, bmat = _coupling_blocks(band_loc.to(f32), h)
    fac = block_tridiag_factor(*band_to_blocks(band_in, h, b), n_loc)
    big = torch.zeros((n_loc, m + 2 * h), dtype=f32, device=dev)
    big[:, :m] = rhs_loc
    big[n_loc - h:, m:m + h] = bmat
    big[:h, m + h:] = cmat
    y = block_tridiag_apply(fac, big)  # [n_loc, M + 2h]
    v, w = y[:, m:m + h], y[:, m + h:]

    # ---- stage 2: the reduced system, gathered and solved replicated -----
    itf = all_gather_cat(_interfaces(y, h), mesh, axis).reshape(
        p, 2 * h, m + 2 * h)
    red = _reduced_matrix(itf[:, :h, m:m + h], itf[:, h:, m:m + h],
                          itf[:, :h, m + h:], itf[:, h:, m + h:], p, h)
    red_inv = torch.linalg.inv_ex(red)[0]
    zero_hm = torch.zeros((h, m), dtype=f32, device=dev)

    def correct(g, g_itf):
        # x_j = g_j − V_j·z_{j+1}^t − W_j·z_{j-1}^b from every partition's
        # interface rows of g ([p, 2h, M])
        z = (red_inv @ g_itf.reshape(2 * h * p, m)).reshape(p, 2 * h, m)
        zt_next = z[j + 1, :h] if j + 1 < p else zero_hm
        zb_prev = z[j - 1, h:] if j > 0 else zero_hm
        return g - v @ zt_next - w @ zb_prev

    def spike_apply(r_loc):  # this rank's rows of ≈A⁻¹·r (f32)
        g = block_tridiag_apply(fac, r_loc.to(f32))
        g_itf = all_gather_cat(_interfaces(g, h), mesh, axis)
        return correct(g, g_itf.reshape(p, 2 * h, m))

    # first apply: reuse stage 1's local solve of the true rhs
    x_loc = correct(y[:, :m], itf[:, :, :m]).to(work)

    # ---- stage 3: global f64 refinement ----------------------------------
    # this rank's strip of the band with h halo rows above and below: the
    # square matvec over the halo'd window of x gives the strip's rows
    band2 = torch.zeros((n_loc + 2 * h, bw), dtype=work, device=dev)
    band2[h:h + n_loc] = band_loc
    real_rows = max(0, min(n_loc, n - j0))  # rows of this strip below n

    def residual(x_l):
        x_pad = torch.zeros((p * n_loc + 2 * h, m), dtype=work, device=dev)
        x_pad[h:h + p * n_loc] = all_gather_cat(x_l, mesh, axis)
        window = x_pad[j0:j0 + n_loc + 2 * h]
        return rhs_loc - banded_matvec_ref(band2, h, window)[h:h + n_loc]

    def col_norms2(r_l):  # global column sums of squares over rows < n
        return all_reduce((r_l[:real_rows] ** 2).sum(dim=0), mesh, axis)

    def global_norm(r_l):  # every rank reads the same all-reduced norm
        return math.sqrt(float(all_reduce((r_l ** 2).sum(), mesh, axis)))

    b_norm = float(torch.linalg.norm(rhs))
    tol_abs = max(tol * b_norm, 10 * torch.finfo(work).eps * b_norm)
    x_loc, r, _, it = refine(
        x_loc, residual, lambda r: spike_apply(r).to(work), tol_abs,
        refine_iterations, norm=global_norm,
    )
    x = all_gather_cat(x_loc, mesh, axis)[:n]
    relres = col_norms2(r).sqrt() / torch.clamp(
        torch.linalg.norm(rhs, dim=0), min=1e-300)
    return x, relres, it


class SpikeBandedOperator(BandedAffineOperator):
    """`BandedAffineOperator` whose DIRECT solves run SPIKE over a mesh.

    Carries the mesh and axis; `solve_point_iterative` routes ``"auto"``
    to ``"spike"`` when it sees ``spike_mesh``, so the matrix-free greedy
    (`greedy_basis_matfree`) runs unchanged with distributed snapshot
    solves. Estimator matvecs (`apply_addend`) stay replicated: they are
    O(N·BW·K), small beside the solves. Every rank builds the operator
    from the whole pencil.
    """

    def __init__(self, *mats, mesh, axis: str = "tp", **kwargs):
        super().__init__(*mats, **kwargs)
        self.spike_mesh = mesh
        self.spike_axis = axis

    def spike_solve(self, c, rhs, tol=1e-10, refine_iterations=30):
        band_t = combine_addends(c, self.bands_w)
        return spike_solve(band_t, self.half, rhs, self.spike_mesh,
                           axis=self.spike_axis, tol=tol,
                           refine_iterations=refine_iterations)
