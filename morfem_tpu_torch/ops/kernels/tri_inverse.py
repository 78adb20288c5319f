"""Inverses of packed LU diagonal blocks, both triangles in one launch — K7.

The panel LU inverts the diagonal blocks of L and U once per factor (per
block step in the block-pivot factor), so that both triangular phases of
its apply are batched matmuls. From packed LU blocks ``lu`` [..., P, P]
(strict lower part: L without its unit diagonal; upper part with the
diagonal: U) K7 writes

    linv = (tril(lu, -1) + I)⁻¹,   uinv = triu(lu)⁻¹,

each zero outside its triangle. The CUDA source is ``csrc/tri_inverse.cu``.
It replaces no Pallas kernel: the JAX package inverts these blocks by
batched matmuls (`morfem_tpu/ops/panel_lu.py::_unit_lower_inv`,
`_upper_inv`); the plain version here is the port's earlier route, two
`torch.linalg.solve_triangular` calls against an identity.

Contract: float32, [B, P, P] or [B1, B2, P, P] with P a multiple of 32;
the blocks may be a strided view with a unit column stride (the
panel LU passes the diagonal blocks of its factor ``lug`` so). On the card
the view must start 16-byte aligned and its other strides be multiples of
4 elements. A zero pivot gives non-finite entries in uinv, as a triangular
solve does. A CPU tensor takes `tri_inverse_plain`; a CUDA tensor launches
the kernel.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

TILE = 32


def _check(lu: torch.Tensor) -> None:
    if lu.ndim not in (3, 4):
        raise ValueError(
            f"tri_inverse needs [B, P, P] or [B1, B2, P, P] blocks, got "
            f"{tuple(lu.shape)}"
        )
    if lu.dtype != torch.float32:
        raise ValueError(f"tri_inverse is f32-only, got {lu.dtype}")
    p = lu.shape[-1]
    if lu.shape[-2] != p:
        raise ValueError(f"tri_inverse needs square blocks, got "
                         f"{tuple(lu.shape)}")
    if p == 0 or p % TILE:
        raise ValueError(f"tri_inverse needs P a positive multiple of "
                         f"{TILE}, got P={p}")


def tri_inverse_plain(lu: torch.Tensor):
    """The same function in plain PyTorch: (linv, uinv) by two triangular
    solves against an identity."""
    _check(lu)
    eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
    lower = torch.tril(lu, -1) + eye
    upper = torch.triu(lu)
    linv = torch.linalg.solve_triangular(
        lower, eye.expand_as(lower), upper=False, unitriangular=True
    )
    uinv = torch.linalg.solve_triangular(upper, eye.expand_as(upper),
                                         upper=True)
    return linv, uinv


def tri_inverse(lu: torch.Tensor):
    """(linv, uinv), each shaped as ``lu`` (contiguous from the kernel)."""
    if lu.device.type == "cpu":
        return tri_inverse_plain(lu)
    _check(lu)
    _lib.check_cuda_tensor("lu", lu, torch.float32)
    if lu.stride(-1) != 1:
        raise ValueError("tri_inverse needs a unit column stride")
    v = lu if lu.ndim == 4 else lu.unsqueeze(0)
    b1, b2, p, _ = v.shape
    # a batch dimension of one is never stepped over
    s_b1, s_b2, s_r, _ = (0 if n == 1 else s for n, s in zip(v.shape,
                                                            v.stride()))
    if v.data_ptr() % 16 or any(s % 4 for s in (s_b1, s_b2, s_r)):
        raise ValueError(
            f"tri_inverse needs a 16-byte aligned view with strides in "
            f"multiples of 4 elements, got strides {tuple(lu.stride())}"
        )
    linv = torch.empty(lu.shape, dtype=torch.float32, device=lu.device)
    uinv = torch.empty_like(linv)
    if linv.numel():
        _lib.load().call(
            "morfem_tri_inverse", v.data_ptr(), linv.data_ptr(),
            uinv.data_ptr(), b1, b2, p, s_b1, s_b2, s_r,
            _lib.stream_handle(lu),
        )
        tri_inverse.launches += 1
    return linv, uinv


tri_inverse.launches = 0
