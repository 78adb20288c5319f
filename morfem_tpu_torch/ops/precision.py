"""Accurate products: the API of `morfem_tpu/ops/precision.py`.

The JAX package needs this module because its chip's float64 is emulated
and loses about eight digits in contractions wider than ~2.5k, and its
float32 products run in bf16 unless split into words: it builds f64
products from Ozaki-scheme bf16 slices and f32-true products from 3-word
bf16 splits. The card has native float64 and full-rate FP32, so each
function here is one plain product that computes what the reference's
computes: float64 operands give a float64 product, and float32 operands an
FP32 product with TF32 off (`morfem_tpu_torch/__init__.py` turns TF32 off
for the whole package). The reference's `split_bf16` and `ozaki_*`
functions are its chip's mechanism and have no counterpart.
"""

from __future__ import annotations

import torch


def precise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """matmul(a, b), accurate to the operands' dtype ([..., m, k] @
    [..., k, n], or a vector b)."""
    return torch.matmul(a, b)


def precise_matmul_chunked(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's chunked-contraction product; the same product
    here."""
    return precise_matmul(a, b)


def matmul_f32_accurate(a: torch.Tensor, b: torch.Tensor,
                        pieces: int = 3) -> torch.Tensor:
    """f32-true product: FP32 with TF32 off. ``pieces`` (the reference's
    bf16 word count) is accepted for the same signature."""
    return precise_matmul(a, b)


def precise_matmul_many(a: torch.Tensor, bs, impl: str = "auto") -> tuple:
    """``(a @ b for b in bs)``. ``impl`` ("auto" or "chunked", the
    reference's compile-cost choice) gives the same products here."""
    return tuple(precise_matmul(a, b) for b in bs)


def precise_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ·b contracting the leading axis: [n, k]ᵀ·[n, l] → [k, l]."""
    return precise_matmul(a.transpose(-1, -2), b)
