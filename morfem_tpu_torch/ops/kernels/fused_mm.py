"""f32-true batched GEMM ``t + sign·(c @ r)`` — kernel K2 of the panel LU.

Counterpart of `morfem_tpu/ops/pallas/fused_mm.py::mm_words`; the CUDA
source is ``csrc/fused_mm.cu``. It carries every O(N³) trailing update of
the panel-LU factors.

`words` was the TPU's bf16 word count of the split product; on the card
every value gives the same FP32 product, so it is checked and otherwise
ignored. The reference's 128-divisibility and VMEM contract does not bind
here: ragged M, N and K are masked in the kernel, and the operands may be
strided views. A CPU tensor takes `mm_words_plain`; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from morfem_tpu_torch.ops.kernels import _lib


def _check(c, r, t, words, sign):
    if c.ndim != 3 or r.ndim != 3:
        raise ValueError(
            f"mm_words needs c [G, M, K] and r [G, K, N], got "
            f"{tuple(c.shape)} and {tuple(r.shape)}"
        )
    g, m, k = c.shape
    g2, k2, n = r.shape
    if g != g2 or k != k2:
        raise ValueError(f"shape mismatch {tuple(c.shape)} @ {tuple(r.shape)}")
    if t is not None and tuple(t.shape) != (g, m, n):
        raise ValueError(f"addend shape {tuple(t.shape)} != {(g, m, n)}")
    if words < 1:
        raise ValueError(f"words must be >= 1, got {words}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    for name, x in (("c", c), ("r", r), ("t", t)):
        if x is not None and x.dtype != torch.float32:
            raise ValueError(f"mm_words needs f32 {name}, got {x.dtype}")


def mm_words_plain(c, r, t=None, words: int = 3, sign: int = 1):
    """The same function in plain PyTorch (FP32 matmul, TF32 off)."""
    _check(c, r, t, words, sign)
    prod = torch.matmul(c, r)
    if t is None:
        return prod if sign > 0 else -prod
    return t + sign * prod


def mm_words(
    c: torch.Tensor,
    r: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    words: int = 3,
    sign: int = 1,
) -> torch.Tensor:
    """t + sign·(c @ r) in FP32, output written once → [G, M, N]."""
    if c.device.type == "cpu":
        return mm_words_plain(c, r, t, words, sign)
    _check(c, r, t, words, sign)
    for name, x in (("c", c), ("r", r), ("t", t)):
        if x is not None:
            _lib.check_cuda_tensor(name, x, torch.float32)
            if x.device != c.device:
                raise ValueError(f"{name} is on {x.device}, c on {c.device}")
    g, m, k = c.shape
    n = r.shape[2]
    out = torch.empty((g, m, n), dtype=torch.float32, device=c.device)
    ts = t.stride() if t is not None else (0, 0, 0)
    lib = _lib.load()
    lib.call(
        "morfem_mm_f32", c.data_ptr(), r.data_ptr(),
        t.data_ptr() if t is not None else None, out.data_ptr(),
        g, m, n, k, *c.stride(), *r.stride(), *ts, float(sign),
        _lib.stream_handle(c),
    )
    mm_words.launches += 1
    return out


mm_words.launches = 0
