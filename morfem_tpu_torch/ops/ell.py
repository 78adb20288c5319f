"""ELL (padded row-slot) operators — gather-only sparsity for scattered
patterns.

Counterpart of `morfem_tpu/ops/ell.py` (no kernel there either). Every row
stores exactly K slots (K = the most nonzeros of any row of the union
pattern of the pencil's addends; short rows pad with zero values pointing
at their own row):

    y[i] = Σ_k  vals[i, k] · x[cols[i, k]]

`truncated_band_via_rcm` takes it as the exact operator when dense-block
storage would inflate more than 32×, and ELL itself no more than 8×.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device

# One-shot gather ([N, K, M] intermediate) below this element count;
# above it, loop over slots to bound the intermediate at [N, M].
_ONE_SHOT_ELEMS = 1 << 27


def ell_from_scipy(mats, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack same-shape SciPy matrices into ELL slots on a SHARED pattern.

    Returns (vals [P, N, K], cols [N, K] i32), slots sorted by column
    within each row; padding slots carry 0 and point at their own row.
    """
    union = sum(abs(m).tocsr() for m in mats)
    union.sum_duplicates()
    union.sort_indices()
    counts = np.diff(union.indptr)
    k = max(int(counts.max()) if counts.size else 0, 1)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    slot = np.concatenate([np.arange(c) for c in counts]) if union.nnz else (
        np.zeros(0, np.int64)
    )
    u_rows = np.repeat(np.arange(n), counts)
    cols[u_rows, slot] = union.indices
    # (row, col) keys are globally sorted in a canonical CSR, so one
    # searchsorted finds every addend entry's union slot
    u_key = u_rows.astype(np.int64) * n + union.indices
    vals = np.zeros((len(mats), n, k))
    for p, m in enumerate(mats):
        csr = m.tocsr()
        csr.sum_duplicates()
        csr.sort_indices()
        a_rows = np.repeat(np.arange(n), np.diff(csr.indptr))
        a_key = a_rows.astype(np.int64) * n + csr.indices
        pos = np.searchsorted(u_key, a_key)
        vals[p][a_rows, pos - union.indptr[a_rows]] = csr.data
    return vals, cols


def ell_matmul(vals: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A·x, gather-only, in x's dtype (vals [N, K], cols [N, K])."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, k = vals.shape
    m = x.shape[1]
    vals = vals.to(x.dtype)
    cols = cols.long()
    if n * k * m <= _ONE_SHOT_ELEMS:
        y = torch.einsum("nk,nkm->nm", vals, x[cols.reshape(-1)]
                         .reshape(n, k, m))
    else:
        y = torch.zeros((n, m), dtype=x.dtype, device=x.device)
        for j in range(k):
            y = y + vals[:, j:j + 1] * x[cols[:, j]]
    return y[:, 0] if squeeze else y


class ELLAffineOperator:
    """A(t)·x applications with padded row-slot (ELL) storage.

    Same surface as `SparseAffineOperator`; the P addends share one union
    slot pattern, `bind` combines slot values once per point. ``inflation``
    = N·K / union nnz is the padding price.
    """

    def __init__(self, *operands, symmetrize: bool = True, device="cuda"):
        import scipy.sparse as sp

        dev = resolve_device(device)
        mats = [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
                for m in operands]
        if any(np.iscomplexobj(m.data) for m in mats):
            raise ValueError(
                "ELLAffineOperator stores real slots; lift complex "
                "operators through the interleaved real embedding first "
                "(ops/complex_split.embed_sparse_interleaved — morfem() "
                "does this automatically)"
            )
        if symmetrize:
            mats = [(m + m.T) * 0.5 for m in mats]
        n = mats[0].shape[0]
        vals, cols = ell_from_scipy(mats, n)
        self.n = n
        self.k = int(cols.shape[1])
        self.cols = torch.as_tensor(cols, device=dev)
        self.vals_w = torch.as_tensor(vals, device=dev)  # [P, N, K]
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
        """f32 path, slot values combined once — Krylov loops."""
        vals32 = self._combined(c).to(torch.float32)
        return lambda x: ell_matmul(vals32, self.cols,
                                    x.to(torch.float32)).to(x.dtype)

    def bind_precise(self, c: torch.Tensor):
        """Working-dtype path, combined once — residuals."""
        vals = self._combined(c)
        return lambda x: ell_matmul(vals, self.cols, x)

    def matvec(self, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Working-dtype exact apply (the GMRES operator)."""
        return self.bind_precise(c)(x)

    def apply_addend(self, p: int, x: torch.Tensor) -> torch.Tensor:
        return ell_matmul(self.vals_w[p], self.cols, x)

    def diagonal(self, c: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(c.to(self.diags.dtype), self.diags, dims=1)
