"""Block-sparse (BSR) SpMM in f32 — kernel K6.

Counterpart of `morfem_tpu/ops/block_sparse.py::bsr_matmul_pallas`; the
CUDA source is ``csrc/block_sparse.cu``. With the stored blocks
``vals[k]`` ([BR, BC] = [32, 128]) sorted by block row,

    y[brows[k]·BR : +BR] += vals[k] · x[bcols[k]·BC : +BC]

`BlockSparseAffineOperator.bind` (`ops/block_sparse.py`) runs it inside
the Krylov snapshot solves. The kernel gives each block row to one
thread block through a row-pointer array (`block_row_pointers`, computed
once per operator); every block row has at least one stored block
(`bsr_from_scipy` guarantees it), and one without writes zeros anyway.

A CPU tensor takes `bsr_matmul_f32_plain` (gather + batched matmul +
`index_add_`); a CUDA tensor launches the kernel, 8 columns of x per
launch at most.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

_BR, _BC, _MAX_COLS = 32, 128, 8  # the kernel's block shape and x width


def block_row_pointers(brows: torch.Tensor, nbr: int) -> torch.Tensor:
    """int32 [nbr + 1]: blocks of block row r are rowptr[r] … rowptr[r+1]−1
    (``brows`` sorted)."""
    bounds = torch.arange(nbr + 1, device=brows.device)
    return torch.searchsorted(brows.long(), bounds).to(torch.int32)


def _check(vals2d, brows, bcols, nbr, n, br, bc, x):
    nb = brows.shape[0]
    if tuple(vals2d.shape) != (nb * br, bc):
        raise ValueError(
            f"vals2d must be [{nb * br}, {bc}], got {tuple(vals2d.shape)}"
        )
    if bcols.shape != brows.shape:
        raise ValueError("brows and bcols must have the same length")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, M] or [{n}], got {tuple(x.shape)}")
    if nbr * br < n:
        raise ValueError(f"{nbr} block rows of {br} do not cover N={n}")


def bsr_matmul_f32_plain(vals2d, brows, bcols, nbr: int, nbc: int, n: int,
                         br: int, bc: int, x, rowptr=None):
    """The same function in plain PyTorch → [N, M] (or [N]) f32."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    _check(vals2d, brows, bcols, nbr, n, br, bc, x)
    m = x.shape[1]
    xp = torch.zeros((nbc * bc, m), dtype=torch.float32, device=x.device)
    xp[:n] = x
    gathered = xp.reshape(nbc, bc, m)[bcols.long()]
    yb = torch.bmm(vals2d.to(torch.float32).reshape(-1, br, bc), gathered)
    y = torch.zeros((nbr, br, m), dtype=torch.float32, device=x.device)
    y.index_add_(0, brows.long(), yb)
    y = y.reshape(nbr * br, m)[:n]
    return y[:, 0] if squeeze else y


def bsr_matmul_f32(vals2d, brows, bcols, nbr: int, nbc: int, n: int,
                   br: int, bc: int, x, rowptr=None):
    """y = A·x in f32 (x [N, M] or [N], any float dtype).

    ``rowptr`` (from `block_row_pointers`) is computed here when not
    given; operators pass their precomputed one.
    """
    if x.device.type == "cpu":
        return bsr_matmul_f32_plain(vals2d, brows, bcols, nbr, nbc, n, br,
                                    bc, x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    _check(vals2d, brows, bcols, nbr, n, br, bc, x)
    if (br, bc) != (_BR, _BC):
        raise ValueError(
            f"the kernel takes {_BR}×{_BC} blocks, got {br}×{bc}"
        )
    _lib.check_cuda_tensor("vals2d", vals2d, torch.float32)
    if not vals2d.is_contiguous():
        raise ValueError("vals2d must be contiguous")
    for name, t in (("brows", brows), ("bcols", bcols), ("x", x)):
        if t.device != vals2d.device:
            raise ValueError(f"{name} is on {t.device}, vals on "
                             f"{vals2d.device}")
    if rowptr is None:
        rowptr = block_row_pointers(brows, nbr)
    bcols32 = bcols.to(torch.int32).contiguous()
    rowptr32 = rowptr.to(torch.int32).contiguous()
    if rowptr32.shape != (nbr + 1,):
        raise ValueError(f"rowptr must be [{nbr + 1}]")
    x32 = x.to(torch.float32)
    m = x32.shape[1]
    y = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    stream = _lib.stream_handle(x32)
    for lo in range(0, m, _MAX_COLS):
        xc = x32[:, lo:lo + _MAX_COLS].contiguous()
        yc = y if xc.shape[1] == m else torch.empty_like(xc)
        lib.call(
            "morfem_bsr_spmm", vals2d.data_ptr(), bcols32.data_ptr(),
            rowptr32.data_ptr(), xc.data_ptr(), yc.data_ptr(), nbr, n,
            xc.shape[1], stream,
        )
        bsr_matmul_f32.launches += 1
        if yc is not y:
            y[:, lo:lo + _MAX_COLS] = yc
    return y[:, 0] if squeeze else y


bsr_matmul_f32.launches = 0
