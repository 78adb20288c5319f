"""Block-sparse (BSR) operators — general sparsity as dense blocks.

Counterpart of `morfem_tpu/ops/block_sparse.py` (host side of kernel K6).
A matrix is stored as dense [BR, BC] = [32, 128] blocks on a sparse block
grid, blocks sorted by (block row, block column):

    A = Σ_k  vals[k]  placed at  (brows[k]·BR, bcols[k]·BC)

Two application paths, as in the reference:

  * `bsr_matmul` — plain torch in any dtype: gather the x blocks, one
    batched product, a sum per block row (`index_add_`). The f64 path of
    residuals, projections and the estimator.
  * `bsr_matmul_f32` — the CUDA kernel K6 (`ops/kernels/block_sparse.py`),
    one thread block per block row; the fast path of Krylov iterations
    (`BlockSparseAffineOperator.bind`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.ops.kernels.block_sparse import (
    block_row_pointers,
    bsr_matmul_f32,
)


def bsr_from_scipy(
    mats, n: int, block_rows: int = 32, block_cols: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Block-partition same-shape SciPy matrices on a SHARED grid.

    The union pattern lets an affine pencil combine per-block values
    elementwise without touching the indices. Every block row gets at
    least one stored block (a zero block on the clamped diagonal if
    needed). Returns (vals [P, nb, BR, BC], brows [nb] i32, bcols [nb]
    i32, nbr, nbc) with blocks sorted by (brow, bcol).
    """
    nbr = -(-n // block_rows)
    nbc = -(-n // block_cols)
    coos = [m.tocoo() for m in mats]
    keys = [
        (coo.row // block_rows).astype(np.int64) * nbc
        + (coo.col // block_cols).astype(np.int64)
        for coo in coos
    ]
    union = np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)
    present_rows = (np.unique(union // nbc) if union.size
                    else np.zeros(0, np.int64))
    missing = np.setdiff1d(np.arange(nbr, dtype=np.int64), present_rows)
    if missing.size:
        union = np.sort(np.concatenate([
            union,
            missing * nbc + np.minimum(missing * block_rows // block_cols,
                                       nbc - 1),
        ]))
    nb = union.size
    vals = np.zeros((len(mats), nb, block_rows, block_cols))
    for p, (coo, key) in enumerate(zip(coos, keys)):
        bids = np.searchsorted(union, key)
        np.add.at(
            vals[p],
            (bids, coo.row % block_rows, coo.col % block_cols),
            coo.data,
        )
    brows = (union // nbc).astype(np.int32)
    bcols = (union % nbc).astype(np.int32)
    return vals, brows, bcols, nbr, nbc


def bsr_matmul(vals, brows, bcols, nbr: int, nbc: int, n: int,
               x: torch.Tensor) -> torch.Tensor:
    """y = A·x in x's dtype: gather x blocks, batched product, per-block-row
    sum. vals [nb, BR, BC]; x [N, M] or [N]."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    br, bc = vals.shape[-2], vals.shape[-1]
    m = x.shape[1]
    xp = torch.zeros((nbc * bc, m), dtype=x.dtype, device=x.device)
    xp[:n] = x
    gathered = xp.reshape(nbc, bc, m)[bcols.long()]
    yb = torch.bmm(vals.to(x.dtype), gathered)
    y = torch.zeros((nbr, br, m), dtype=x.dtype, device=x.device)
    y.index_add_(0, brows.long(), yb)
    y = y.reshape(nbr * br, m)[:n]
    return y[:, 0] if squeeze else y


class BlockSparseAffineOperator:
    """A(t)·x applications with dense-block storage on a sparse block grid.

    Same surface as `SparseAffineOperator` (`matvec`, `apply_addend`,
    `diagonal`, `bind`, `bind_precise`). The P addends share one union
    block pattern, so `bind` combines block VALUES elementwise and runs
    one f32 kernel K6 per apply. ``inflation`` = dense-block storage /
    union nnz: the price of blocking.
    """

    def __init__(self, *operands, symmetrize: bool = True,
                 block_rows: int = 32, block_cols: int = 128, device="cuda"):
        import scipy.sparse as sp

        dev = resolve_device(device)
        mats = [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
                for m in operands]
        if any(np.iscomplexobj(m.data) for m in mats):
            raise ValueError(
                "BlockSparseAffineOperator stores real blocks; complex "
                "systems are ported in slice 3 of the PyTorch port"
            )
        if symmetrize:
            mats = [(m + m.T) * 0.5 for m in mats]
        n = mats[0].shape[0]
        vals, brows, bcols, nbr, nbc = bsr_from_scipy(
            mats, n, block_rows, block_cols
        )
        self.n = n
        self.br, self.bc = block_rows, block_cols
        self.nbr, self.nbc = nbr, nbc
        self.brows = torch.as_tensor(brows, device=dev)
        self.bcols = torch.as_tensor(bcols, device=dev)
        self.rowptr = block_row_pointers(self.brows, nbr)
        self.vals_w = torch.as_tensor(vals, device=dev)  # [P, nb, BR, BC]
        nnz_union = int(sum(abs(m) for m in mats).nnz)
        self.inflation = vals[0].size / max(nnz_union, 1)
        self.diags = torch.stack(
            [torch.as_tensor(m.diagonal(), dtype=torch.float64)
             for m in mats]).to(dev)  # [P, N]

    @property
    def n_addends(self) -> int:
        return self.vals_w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals_w.device

    def _combined(self, c: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(c.to(self.vals_w.dtype), self.vals_w, dims=1)

    def bind(self, c: torch.Tensor):
        """f32 kernel K6, block values combined once — Krylov loops."""
        nb = self.brows.shape[0]
        vals2d = self._combined(c).to(torch.float32).reshape(
            nb * self.br, self.bc)

        def mv(x):
            return bsr_matmul_f32(
                vals2d, self.brows, self.bcols, self.nbr, self.nbc, self.n,
                self.br, self.bc, x, rowptr=self.rowptr,
            ).to(x.dtype)

        return mv

    def bind_precise(self, c: torch.Tensor):
        """Working-dtype (f64) path, combined once — residuals."""
        vals = self._combined(c)
        return lambda x: bsr_matmul(vals, self.brows, self.bcols, self.nbr,
                                    self.nbc, self.n, x)

    def matvec(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Working-dtype exact apply (the GMRES operator)."""
        return self.bind_precise(c)(x)

    def apply_addend(self, p: int, x: torch.Tensor) -> torch.Tensor:
        """A_p·x for one (pre-symmetrized) addend in working dtype."""
        return bsr_matmul(self.vals_w[p], self.brows, self.bcols, self.nbr,
                          self.nbc, self.n, x)

    def diagonal(self, c: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(c.to(self.diags.dtype), self.diags, dims=1)
