"""Block-sparse (BSR) operators — general sparsity on a block grid.

Counterpart of `morfem_tpu/ops/block_sparse.py` (host side of kernel K6).
A matrix is partitioned into [BR, BC] = [32, 128] blocks on a sparse block
grid, blocks sorted by (block row, block column), as in the reference:

    A = Σ_k  vals[k]  placed at  (brows[k]·BR, bcols[k]·BC)

The operator keeps only the nonzeros, packed once into row sectors
(`pack_sectors`, from the addends' CSR nonzeros; `bsr_from_scipy` builds
the blocks themselves, the reference's storage). Two application paths,
as in the reference:

  * `bsr_matmul` — plain torch in any dtype over the blocks themselves
    (the reference's XLA product: gather, batched product, segment sum).
  * `sector_matmul_plain` — plain torch in any dtype over the packing. The
    f64 path of residuals, projections and the estimator.
  * `bsr_matmul_f32` — the CUDA kernel K6 (`ops/kernels/block_sparse.py`)
    over the same packing, one thread per row; the fast path of Krylov
    iterations (`BlockSparseAffineOperator.bind`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.ops.kernels.block_sparse import (
    bsr_matmul_f32,
    pack_sectors,
    sector_matmul_plain,
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
    """y = A·x over the blocks in x's dtype: vals [nb, BR, BC], brows and
    bcols [nb] (sorted by block row), x [N, M] or [N]."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    br, bc = vals.shape[-2], vals.shape[-1]
    m = x.shape[1]
    xp = torch.zeros((nbc * bc, m), dtype=x.dtype, device=x.device)
    xp[:n] = x
    gathered = xp.reshape(nbc, bc, m)[
        torch.as_tensor(bcols, device=x.device).long()]
    yb = vals.to(x.dtype) @ gathered  # [nb, BR, M]
    y = torch.zeros((nbr, br, m), dtype=x.dtype, device=x.device)
    y.index_add_(0, torch.as_tensor(brows, device=x.device).long(), yb)
    y = y.reshape(nbr * br, m)[:n]
    return y[:, 0] if squeeze else y


class BlockSparseAffineOperator:
    """A(t)·x applications over the nonzeros of a sparse block grid.

    Same surface as `SparseAffineOperator` (`matvec`, `apply_addend`,
    `diagonal`, `bind`, `bind_precise`). The P addends share one union
    block pattern, packed into row sectors once, so `bind` combines
    sector VALUES elementwise and runs one f32 kernel K6 per apply.
    ``inflation`` = dense-block storage / union nnz: the price of blocking
    (the reference's router reads it; the packing stores far less).
    """

    def __init__(self, *operands, symmetrize: bool = True,
                 block_rows: int = 32, block_cols: int = 128, device="cuda"):
        import scipy.sparse as sp

        dev = resolve_device(device)
        mats = [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
                for m in operands]
        if any(np.iscomplexobj(m.data) for m in mats):
            raise ValueError(
                "BlockSparseAffineOperator stores real blocks; lift "
                "complex operators through the interleaved real embedding "
                "first (ops/complex_split.embed_sparse_interleaved — "
                "morfem() does this automatically)"
            )
        if symmetrize:
            mats = [(m + m.T) * 0.5 for m in mats]
        n = mats[0].shape[0]
        self.n = n
        self.br, self.bc = block_rows, block_cols
        self.nbr, self.nbc = -(-n // block_rows), -(-n // block_cols)
        union = sum(abs(m) for m in mats).tocsr()
        union.sort_indices()
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(union.indptr))
        keys = rows * n + union.indices
        nz = np.zeros((len(mats), keys.size))
        for p, m in enumerate(mats):
            coo = m.tocoo()
            stored = coo.data != 0  # explicit zeros may be off the union
            np.add.at(nz[p], np.searchsorted(
                keys, coo.row[stored].astype(np.int64) * n
                + coo.col[stored]), coo.data[stored])
        # [P, nsec, 8] working-dtype values per addend, on the device
        self.sectors = pack_sectors(
            torch.from_numpy(rows).to(dev),
            torch.from_numpy(union.indices.astype(np.int64)).to(dev),
            torch.from_numpy(nz).to(dev), n)
        # the blocks `bsr_from_scipy` would store: the union's, plus one
        # filler block in each block row that has none
        bkeys = np.unique(rows // block_rows * self.nbc
                          + union.indices // block_cols)
        nb = bkeys.size + self.nbr - np.unique(bkeys // self.nbc).size
        self.inflation = nb * block_rows * block_cols / max(keys.size, 1)
        self.diags = torch.stack(
            [torch.as_tensor(m.diagonal(), dtype=torch.float64)
             for m in mats]).to(dev)  # [P, N]

    @property
    def n_addends(self) -> int:
        return self.sectors.vals.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sectors.vals.device

    def _combined(self, c: torch.Tensor):
        """The packing of Σ_p c_p·A_p (sector values [nsec, W])."""
        vals = self.sectors.vals
        return self.sectors._replace(
            vals=torch.tensordot(c.to(vals.dtype), vals, dims=1))

    def bind(self, c: torch.Tensor):
        """f32 kernel K6, sector values combined once — Krylov loops."""
        packing = self._combined(c)
        packing = packing._replace(
            vals=packing.vals.to(torch.float32).contiguous())

        def mv(x):
            return bsr_matmul_f32(
                None, None, None, self.nbr, self.nbc, self.n, self.br,
                self.bc, x, packing=packing,
            ).to(x.dtype)

        return mv

    def bind_precise(self, c: torch.Tensor):
        """Working-dtype (f64) path, combined once — residuals."""
        packing = self._combined(c)
        return lambda x: sector_matmul_plain(packing, x)

    def matvec(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Working-dtype exact apply (the GMRES operator)."""
        return self.bind_precise(c)(x)

    def apply_addend(self, p: int, x: torch.Tensor) -> torch.Tensor:
        """A_p·x for one (pre-symmetrized) addend in working dtype."""
        return sector_matmul_plain(
            self.sectors._replace(vals=self.sectors.vals[p]), x)

    def diagonal(self, c: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(c.to(self.diags.dtype), self.diags, dims=1)
