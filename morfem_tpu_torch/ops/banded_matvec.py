"""Banded operators in diagonal storage (host side of kernel K5).

Counterpart of `morfem_tpu/ops/pallas/banded_matvec.py`. A banded matrix
is stored by diagonals,

    band[i, d] = A[i, i + d − half]            band: [N, BW], BW = 2·half+1

so a matvec is BW shifted multiply-adds. Narrow bands (BW ≤ ``WIDE_BW``)
run the CUDA kernel K5 (`ops/kernels/banded_matvec.py`) in f32; wider
bands take `banded_matvec_blocked`, the same operator as block-tridiagonal
(L, D, U) blocks applied by three batched products. The routing is the
reference's, so both packages take the same path for the same band.

`BandedAffineOperator` holds the P addends of an affine pencil in this
layout (pre-symmetrized on the host) and offers the operator surface the
solvers use: `bind` (f32 fast matvec, K5 or blocked), `bind_precise` (the
f64 reference matvec for residuals), `apply_addend`, `diagonal`, and
`blocks` (the f32 block-tridiagonal blocks of A(c) that the block-Thomas
factor takes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.ops.kernels.banded_matvec import (
    banded_matvec_padded,
    bind_banded_matvec,
)

# Above this many diagonals the reference switches from the per-diagonal
# forms (its Pallas kernel and its jnp loop, both unrolled per diagonal) to
# the blocked-GEMM matvec; the port keeps the threshold so both packages
# run the same algorithm for the same band.
WIDE_BW = 96


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_banded(a, bandwidth: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Convert a (dense / SciPy sparse) matrix to diagonal storage.

    Returns (band [N, 2·half+1], half). Entries outside the band are
    dropped — callers should pick `bandwidth` ≥ the true half-bandwidth
    (auto-detected from the sparsity when omitted).
    """
    import scipy.sparse as sp

    if sp.issparse(a):
        coo = a.tocoo()
        n = coo.shape[0]
        if bandwidth is None:
            bandwidth = int(np.max(np.abs(coo.row - coo.col))) if coo.nnz else 0
        half = bandwidth
        band = np.zeros((n, 2 * half + 1), dtype=coo.data.dtype)
        d = coo.col - coo.row + half
        keep = (d >= 0) & (d < 2 * half + 1)
        band[coo.row[keep], d[keep]] = coo.data[keep]
        return band, half
    a = np.asarray(a)
    n = a.shape[0]
    if bandwidth is None:
        nz = np.nonzero(a)
        bandwidth = int(np.max(np.abs(nz[0] - nz[1]))) if nz[0].size else 0
    half = bandwidth
    band = np.zeros((n, 2 * half + 1), dtype=a.dtype)
    for d in range(-half, half + 1):
        diag = np.diagonal(a, offset=d)
        rows = np.arange(max(0, -d), max(0, -d) + diag.size)
        band[rows, d + half] = diag
    return band, half


def pad_band(band: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """The reference's padded kernel layout: [N, BW] → f32 [N_pad, BWp]
    (rows to a multiple of `tile`, diagonals to a multiple of 128). K5
    reads only the first N rows and BW columns, so it takes this layout
    and the unpadded one alike."""
    n, bw = band.shape
    out = torch.zeros((_round_up(n, tile), _round_up(bw, 128)),
                      dtype=torch.float32, device=band.device)
    out[:n, :bw] = band
    return out


def banded_matvec(band: torch.Tensor, half: int, x: torch.Tensor,
                  tile: int = 256) -> torch.Tensor:
    """y = A·x for a banded A through K5 (pads the band inline, as the
    reference does for one-shot use) → [N, M] f32."""
    n, bw = band.shape
    return banded_matvec_padded(pad_band(band, tile), n, bw, half, x)


def banded_matvec_blocked(band: torch.Tensor, half: int,
                          x: torch.Tensor) -> torch.Tensor:
    """y = A·x as block-tridiagonal products — the wide-band matvec.

    Exact for any block ≥ half (`band_to_blocks`):
    y_I = L_I·x_{I−1} + D_I·x_I + U_I·x_{I+1}, in x's dtype (FP32 products
    with TF32 off for f32, DGEMM for f64).
    """
    from morfem_tpu_torch.ops.block_tridiag import band_to_blocks

    n = band.shape[0]
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    b = max(128, _round_up(half, 128))
    l, d, u = band_to_blocks(band, half, b)
    nb = l.shape[0]
    m = x.shape[1]
    xp = torch.zeros((nb * b, m), dtype=x.dtype, device=x.device)
    xp[:n] = x
    xb = xp.reshape(nb, b, m)
    zero = torch.zeros((1, b, m), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([zero, xb[:-1]], dim=0)
    x_next = torch.cat([xb[1:], zero], dim=0)
    y = (l.to(x.dtype) @ x_prev + d.to(x.dtype) @ xb
         + u.to(x.dtype) @ x_next)
    y = y.reshape(nb * b, m)[:n]
    return y[:, 0] if squeeze else y


def banded_matvec_ref(band: torch.Tensor, half: int,
                      x: torch.Tensor) -> torch.Tensor:
    """Reference banded matvec in plain torch (any dtype, e.g. f64): the
    residual operator around the f32 kernel. Wide bands take the blocked
    form, as in the reference."""
    n, bw = band.shape
    if bw > WIDE_BW:
        return banded_matvec_blocked(band, half, x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    x_pad = torch.zeros((n + 2 * half, x.shape[1]), dtype=x.dtype,
                        device=x.device)
    x_pad[half:half + n] = x
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for d in range(bw):
        y = y + band[:, d:d + 1] * x_pad[d:d + n]
    return y[:, 0] if squeeze else y


def combine_addends(c: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """Σ_p c_p·S_p over the leading addend axis of [P, ...] storage."""
    return torch.tensordot(c.to(stacked.dtype), stacked, dims=1)


class BandedAffineOperator:
    """A(t)·x applications with banded storage (kernel K5 for narrow bands).

    Same interface as `ops/sparse.py::SparseAffineOperator` (`matvec`,
    `diagonal`, `apply_addend`, plus `bind`/`bind_precise`), so
    `solve_point_iterative` takes it. The P addends are stored in
    diagonal form, pre-symmetrized on the host, in f64 (`bands_w`
    [P, N, BW]); narrow bands also keep an f32 copy (`bands_p`) that
    `bind` combines per point for the kernel. ``nonzero_addends`` lists
    the addends with a nonzero entry (the waveguide's a1 has none).
    """

    def __init__(
        self,
        *mats,
        symmetrize: bool = True,
        bandwidth: Optional[int] = None,
        device="cuda",
    ):
        """``bandwidth`` (optional): TRUNCATE every addend to this
        half-bandwidth — entries further from the diagonal are dropped.
        The result then represents only the in-band part of the pencil;
        use it as a PRECONDITIONER for the exact operator, never as the
        operator itself (`ops/block_tridiag.py::general_sparse_solve`)."""
        import scipy.sparse as sp

        dev = resolve_device(device)
        if symmetrize:
            mats = [(a + a.T) * 0.5 for a in mats]
        if any(
            np.iscomplexobj(m.data if sp.issparse(m) else np.asarray(m))
            for m in mats
        ):
            raise ValueError(
                "BandedAffineOperator stores real bands; lift complex "
                "operators through the interleaved real embedding first "
                "(ops/complex_split.embed_sparse_interleaved — morfem() "
                "does this automatically)"
            )
        bands, halves = zip(*(to_banded(a, bandwidth=bandwidth)
                              for a in mats))
        self.half = max(halves)
        n = bands[0].shape[0]
        bw = 2 * self.half + 1
        aligned = np.zeros((len(mats), n, bw), dtype=np.float64)
        for p, (band, h) in enumerate(zip(bands, halves)):
            aligned[p, :, self.half - h:self.half + h + 1] = band
        self.n = n
        self.bw = bw
        self.nonzero_addends = tuple(
            p for p, a in enumerate(mats)
            if (a.count_nonzero() if sp.issparse(a) else np.any(a)))
        self.bands_w = torch.from_numpy(aligned).to(dev)  # [P, N, BW] f64
        # the kernel's f32 operand (narrow bands only; wide bands run the
        # blocked matvec straight off bands_w)
        self.bands_p = (self.bands_w.to(torch.float32) if bw <= WIDE_BW
                        else None)
        self.diags = self.bands_w[:, :, self.half].clone()  # [P, N]

    @property
    def n_addends(self) -> int:
        return self.bands_w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.bands_w.device

    def bind(self, c: torch.Tensor):
        """Combine the bands for coefficients c ONCE and return the f32
        matvec closure (K5 for narrow bands, blocked products for wide),
        which returns y in x's dtype. K5 reads a float32 or float64 x as
        it is and writes y in that type: one launch per matvec."""
        if self.bw > WIDE_BW:
            band_t = combine_addends(c, self.bands_w).to(torch.float32)

            def mv(x):
                return banded_matvec_blocked(
                    band_t, self.half, x.to(torch.float32)
                ).to(x.dtype)

            return mv
        band_p = combine_addends(c, self.bands_p.to(torch.float64)).to(
            torch.float32).contiguous()
        k5 = bind_banded_matvec(band_p, self.n, self.bw, self.half)

        def mv(x):
            y = k5(x[:, None] if x.ndim == 1 else x).to(x.dtype)
            return y[:, 0] if x.ndim == 1 else y

        return mv

    def matvec(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.bind(c)(x)

    def bind_precise(self, c: torch.Tensor):
        """f64 (working-dtype) matvec closure for refinement residuals."""
        band_t = combine_addends(c, self.bands_w)
        return lambda x: banded_matvec_ref(band_t, self.half, x)

    def apply_addend(self, p: int, x: torch.Tensor) -> torch.Tensor:
        """A_p·x for one (pre-symmetrized) addend in working dtype."""
        return banded_matvec_ref(self.bands_w[p], self.half, x)

    def diagonal(self, c: torch.Tensor) -> torch.Tensor:
        return combine_addends(c, self.diags)

    def blocks(self, c: torch.Tensor, block: int):
        """The f32 block-tridiagonal blocks (l, d, u) of A(c)
        (`band_to_blocks`): [nb, b, b] for coefficients c [P], or
        [G, nb, b, b] for c [G, P], made one point at a time. Each point's
        bands are combined in f64, rounded to f32 and then cut into
        blocks, so no f64 block window is made: the same numbers as the
        f64 blocks rounded to f32."""
        from morfem_tpu_torch.ops.block_tridiag import band_to_blocks

        if c.ndim == 1:
            band32 = combine_addends(c, self.bands_w).to(torch.float32)
            return band_to_blocks(band32, self.half, block)
        out = None
        for g, c_g in enumerate(c):
            point = self.blocks(c_g, block)
            if out is None:
                out = tuple(t.new_empty((c.shape[0], *t.shape))
                            for t in point)
            for o, t in zip(out, point):
                o[g] = t
        return out
