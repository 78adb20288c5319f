"""Batched row gather ``src[g, idx[g], :]`` — kernel K3 of the panel LU.

Counterpart of `morfem_tpu/ops/pallas/row_gather.py::gather_rows`; the
CUDA source is ``csrc/row_gather.cu``. The panel LU gathers the pivot
rows of each trailing block and applies the final permutation with it.

The input contract is the reference's (f32 source, P a multiple of 128, N
a multiple of 8, W a multiple of 128), so both packages reject the same
inputs; the source may be a strided view with a unit column stride, and
the indices int32 or int64 at any strides (the kernel reads them as they
are; other integer types are widened to int64 first).
A CPU tensor takes `gather_rows_plain`; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib


def _check(src: torch.Tensor, idx: torch.Tensor):
    if src.ndim != 3 or idx.ndim != 2:
        raise ValueError(
            f"gather_rows needs src [G, N, W] and idx [G, P], got "
            f"{tuple(src.shape)} and {tuple(idx.shape)}"
        )
    g, n, w = src.shape
    g2, p = idx.shape
    if src.dtype != torch.float32:
        raise ValueError(f"gather_rows is f32-only, got {src.dtype}")
    if g != g2:
        raise ValueError(
            f"batch mismatch: src {tuple(src.shape)}, idx {tuple(idx.shape)}"
        )
    if p % 128:
        raise ValueError(f"gather_rows needs P % 128 == 0, got P={p}")
    if n % 8:
        raise ValueError(f"gather_rows needs N % 8 == 0, got N={n}")
    if w % 128:
        raise ValueError(f"gather_rows needs a lane-multiple W, got W={w}")


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (advanced indexing)."""
    _check(src, idx)
    batch = torch.arange(src.shape[0], device=src.device)[:, None]
    return src[batch, idx.long()]


_IDX_BYTES = {torch.int32: 4, torch.int64: 8}


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather → [G, P, W]; exact."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    _check(src, idx)
    _lib.check_cuda_tensor("src", src, torch.float32)
    if idx.device != src.device:
        raise ValueError("idx must be on the same device as src")
    if src.stride(2) != 1:
        raise ValueError("gather_rows needs a unit column stride in src")
    if idx.dtype not in _IDX_BYTES:
        idx = idx.long()
    g, n, w = src.shape
    p = idx.shape[1]
    out = torch.empty((g, p, w), dtype=torch.float32, device=src.device)
    _lib.load().call(
        "morfem_gather_rows", src.data_ptr(), idx.data_ptr(),
        _IDX_BYTES[idx.dtype], out.data_ptr(), g, n, p, w, src.stride(0),
        src.stride(1), idx.stride(0), idx.stride(1), _lib.stream_handle(src),
    )
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
