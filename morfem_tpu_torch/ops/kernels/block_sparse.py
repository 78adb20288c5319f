"""Block-sparse (BSR) SpMM in f32 — kernel K6 — over packed row sectors.

Counterpart of `morfem_tpu/ops/block_sparse.py::bsr_matmul_pallas`; the
CUDA source is ``csrc/block_sparse.cu``. With the stored blocks
``vals[k]`` ([BR, BC] = [32, 128]) sorted by block row,

    y[brows[k]·BR : +BR] += vals[k] · x[bcols[k]·BC : +BC]

The kernel does not read the blocks: `bsr_pack_sectors` repacks their
nonzeros once into 8-wide row sectors (a `SectorPacking`: values
[nsec, 8], each sector's first column, and a pointer per row), and the
kernel reads only those. `BlockSparseAffineOperator` (`ops/block_sparse.py`)
packs its union pattern in its constructor (`pack_sectors`, from its CSR
nonzeros) and passes the packing to `bsr_matmul_f32` in `bind`; called
without one, `bsr_matmul_f32` packs on the fly, on the blocks' device.

A CPU tensor takes a plain version (`bsr_matmul_f32_plain` for blocks,
`sector_matmul_plain` for a packing); a CUDA tensor launches the kernel,
8 columns of x per launch at most.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morfem_tpu_torch.ops.kernels import _lib

_MAX_COLS = 8  # columns of x per launch
SECTOR_WIDTH = 8  # the width the kernel is built for (csrc/block_sparse.cu)


class SectorPacking(NamedTuple):
    """Nonzeros of an N×N operator as 8-wide row sectors.

    ``vals`` [nsec, 8] (or [P, nsec, 8], one slice per addend): the values
    of columns ``cols[s]`` … ``cols[s] + 7`` of the sector's row, zero
    where the operator is zero or the column is ≥ N. ``cols`` int32 [nsec]:
    each sector's first column. ``rowptr`` int32 [N + 1]: the sectors of
    row r are rowptr[r] … rowptr[r+1] − 1, in column order (the kernel's
    walk).
    """

    vals: torch.Tensor
    cols: torch.Tensor
    rowptr: torch.Tensor

    @property
    def n(self) -> int:
        return self.rowptr.shape[0] - 1


def pack_sectors(rows, cols, nz, n: int) -> SectorPacking:
    """Pack nonzeros (``rows``, ``cols`` int64 [nnz], sorted by row then
    column; values ``nz`` [nnz] or [P, nnz]) of an N×N operator into
    8-wide row sectors, on the nonzeros' device.

    In each row, a sector starts at the first nonzero column that no
    earlier sector covers (greedy, so a sector may straddle a block edge or
    run past N): one pass opens the next sector of every row that has one
    left, so the passes are as many as the most sectors in a row.
    """
    dev, w = rows.device, SECTOR_WIDTH
    keys = rows * n + cols
    row_keys = torch.arange(n + 1, device=dev) * n
    ptr = torch.searchsorted(keys, row_keys[:-1])  # each row's next nonzero
    ends = torch.searchsorted(keys, row_keys[1:])
    live = torch.nonzero(ptr < ends).squeeze(1)
    opened = []
    while live.numel():
        key = keys[ptr[live]]  # (row, first column) of each opened sector
        opened.append(key)
        ptr[live] = nxt = torch.searchsorted(keys, key + w)
        live = live[nxt < ends[live]]
    starts = torch.sort(torch.cat(opened)).values if opened else keys[:0]
    sector = torch.searchsorted(starts, keys, right=True) - 1
    out = torch.zeros((*nz.shape[:-1], starts.numel(), w), dtype=nz.dtype,
                      device=dev)
    out[..., sector, keys - starts[sector]] = nz
    return SectorPacking(out, (starts % n).to(torch.int32),
                         torch.searchsorted(starts, row_keys).to(torch.int32))


def bsr_pack_sectors(vals, brows, bcols, n: int) -> SectorPacking:
    """Pack the nonzeros of stored blocks into 8-wide row sectors.

    ``vals`` [nb, BR, BC] or [P, nb, BR, BC] (P addends on one block
    pattern: a column is packed where any addend is nonzero, so the
    addends combine sector by sector). Rows and columns ≥ ``n`` are
    dropped, as the blocks' product drops them. Runs on ``vals``' device
    (`pack_sectors`) and returns the packing there, in its dtype.
    """
    vals = torch.as_tensor(vals)
    dev = vals.device
    v = vals if vals.ndim == 4 else vals[None]
    _, _, br, bc = v.shape
    k, r, c = (v != 0).any(0).nonzero(as_tuple=True)
    rows = torch.as_tensor(brows, device=dev).long()[k] * br + r
    cols = torch.as_tensor(bcols, device=dev).long()[k] * bc + c
    keep = (rows < n) & (cols < n)
    order = torch.argsort(rows[keep] * n + cols[keep])
    k, r, c = (t[keep][order] for t in (k, r, c))
    packing = pack_sectors(rows[keep][order], cols[keep][order],
                           v[:, k, r, c], n)
    if vals.ndim == 3:
        packing = packing._replace(vals=packing.vals[0])
    return packing


def sector_matmul_plain(packing: SectorPacking, x: torch.Tensor):
    """y = A·x over a packing, in plain PyTorch, in x's dtype (x [N, M]
    or [N]): the 8-wide windows of x at the sectors' columns, one product
    per sector, a sum per row."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, w = packing.n, SECTOR_WIDTH
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, M] or [{n}], got {tuple(x.shape)}")
    xp = torch.zeros((n + w, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[:n] = x
    windows = xp.unfold(0, w, 1)[packing.cols]  # [nsec, M, W]
    ys = (windows * packing.vals.to(x.dtype)[:, None, :]).sum(-1)
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), packing.rowptr.diff(),
        output_size=packing.cols.numel())
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, rows, ys)
    return y[:, 0] if squeeze else y


def _check(vals2d, brows, bcols, nbr, n, br, bc, x):
    nb = brows.shape[0]
    if tuple(vals2d.shape) != (nb * br, bc):
        raise ValueError(
            f"vals2d must be [{nb * br}, {bc}], got {tuple(vals2d.shape)}"
        )
    if bcols.shape != brows.shape:
        raise ValueError("brows and bcols must have the same length")
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, M] or [{n}], got {tuple(x.shape)}")
    if nbr * br < n:
        raise ValueError(f"{nbr} block rows of {br} do not cover N={n}")


def bsr_matmul_f32_plain(vals2d, brows, bcols, nbr: int, nbc: int, n: int,
                         br: int, bc: int, x):
    """The same function in plain PyTorch, over the blocks → [N, M] (or
    [N]) f32: gather + batched product + `index_add_`."""
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
                   br: int, bc: int, x, packing: SectorPacking = None):
    """y = A·x in f32 (x [N, M] or [N], any float dtype).

    ``packing`` (from `bsr_pack_sectors`, f32 values [nsec, 8]) is the
    operator when given, and the blocks (vals2d, brows, bcols) are then
    not read: operators pass their precomputed one. Without it the blocks
    are packed here, on their device.
    """
    if packing is None:
        _check(vals2d, brows, bcols, nbr, n, br, bc, x)
        if x.device.type == "cpu":
            return bsr_matmul_f32_plain(vals2d, brows, bcols, nbr, nbc, n,
                                        br, bc, x)
        packing = bsr_pack_sectors(
            vals2d.reshape(-1, br, bc).to(torch.float32), brows, bcols, n)
    elif x.device.type == "cpu":
        return sector_matmul_plain(packing, x.to(torch.float32))
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.ndim != 2 or x.shape[0] != n or packing.n != n:
        raise ValueError(
            f"x must be [{n}, M] and the packing {n} rows, got "
            f"{tuple(x.shape)} and {packing.n}")
    if (packing.vals.shape[1:] != (SECTOR_WIDTH,)
            or packing.cols.shape != packing.vals.shape[:1]):
        raise ValueError(
            f"the kernel takes packed values [nsec, {SECTOR_WIDTH}] and nsec"
            f" columns, got {tuple(packing.vals.shape)} and "
            f"{tuple(packing.cols.shape)}")
    for name, t, dtype in (("packing.vals", packing.vals, torch.float32),
                           ("packing.cols", packing.cols, torch.int32),
                           ("packing.rowptr", packing.rowptr, torch.int32)):
        _lib.check_cuda_tensor(name, t, dtype)
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    x32 = x.to(torch.float32)
    m = x32.shape[1]
    y = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    stream = _lib.stream_handle(x32)
    for lo in range(0, m, _MAX_COLS):
        xc = x32.contiguous() if m <= _MAX_COLS else (
            x32[:, lo:lo + _MAX_COLS].contiguous())
        yc = y if xc.shape[1] == m else torch.empty_like(xc)
        lib.call(
            "morfem_bsr_spmm", packing.vals.data_ptr(),
            packing.cols.data_ptr(), packing.rowptr.data_ptr(),
            xc.data_ptr(), yc.data_ptr(), n, xc.shape[1], stream,
        )
        bsr_matmul_f32.launches += 1
        if yc is not y:
            y[:, lo:lo + _MAX_COLS] = yc
    return y[:, 0] if squeeze else y


bsr_matmul_f32.launches = 0
