"""f32-true batched GEMM ``t + sign·(c @ r)`` — kernel K2 of the panel LU.

Counterpart of `morfem_tpu/ops/pallas/fused_mm.py::mm_words`; the CUDA
source is ``csrc/fused_mm.cu``. It carries every O(N³) trailing update of
the panel-LU factors.

The card computes it as the TPU kernel does: both operands split exactly
into ``words`` = 3 bf16 words (`split_words_plain` is the rounding), and
the six word products of weight ≥ 2⁻¹⁶ accumulated in f32, smallest
weight first — here on the bf16 tensor cores (`wgmma`), after a split
pass that writes K-major word planes. `mm_words_split_plain` repeats that
arithmetic in plain PyTorch. The reference's 128-divisibility and VMEM
contract does not bind: ragged M, N and K are handled, and the operands
may be strided views.

A CPU tensor takes `mm_words_plain`, an FP32 product — the JAX package
too computes these products as plain f32 matmuls off the TPU
(`ops/precision.py::matmul_f32_accurate`), so the CPU tests compare like
with like. A CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from morfem_tpu_torch.ops.kernels import _lib

WORDS = 3  # bf16 words per f32 operand, as in the reference
K_ALIGN = 64  # the word planes' row length is K rounded up to this
# the six word pairs (c word, r word), smallest weight first (the
# reference's `_mm_kernel` order)
PAIRS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))


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
    if k < 1:
        raise ValueError(f"mm_words needs K >= 1, got K={k}")
    if t is not None and tuple(t.shape) != (g, m, n):
        raise ValueError(f"addend shape {tuple(t.shape)} != {(g, m, n)}")
    if words != WORDS:
        raise ValueError(
            f"mm_words splits each operand into {WORDS} bf16 words (the "
            f"reference's f32-true scheme), got words={words}"
        )
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    for name, x in (("c", c), ("r", r), ("t", t)):
        if x is not None and x.dtype != torch.float32:
            raise ValueError(f"mm_words needs f32 {name}, got {x.dtype}")


def split_words_plain(x: torch.Tensor, words: int = WORDS):
    """Exact bf16 word split of an f32 tensor, `_split_words`' rounding.

    Word w is the bit pattern of the residual plus 0x8000 with the low 16
    bits masked (round half away from zero on the magnitude; a mantissa
    carry rolls into the exponent); the residual minus that word is exact
    in f32. A NaN residual gives a quiet NaN word of its sign (0x7FC0 |
    sign), and stays NaN. Subnormal operands and results of the residual
    subtraction flush to a zero of their sign, as the reference's
    arithmetic does on the TPU and in XLA on the CPU. Returns ``words``
    bf16 tensors shaped like x.
    """
    if x.dtype != torch.float32:
        raise ValueError(f"split_words_plain needs f32, got {x.dtype}")
    parts = []
    rem = x
    for _ in range(words):
        bits = rem.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        h = (bits + 0x8000) & 0xFFFF0000
        nan = torch.isnan(rem)
        hi = torch.where(nan, ((bits >> 16) & 0x8000) | 0x7FC0, h >> 16)
        parts.append(
            torch.where(hi >= 0x8000, hi - 0x10000, hi)
            .to(torch.int16).view(torch.bfloat16)
        )
        h32 = torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
        sub = torch.where(nan, rem, h32.view(torch.float32))
        rem = _flush(_flush(rem) - _flush(sub))
    return parts


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign (NaN and the rest unchanged)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(v.abs() < tiny, torch.copysign(torch.zeros_like(v), v),
                       v)


def mm_words_split_plain(c, r, t=None, words: int = WORDS, sign: int = 1):
    """The kernel's arithmetic in plain PyTorch: the six word products
    (each exact in f32) summed in f32, smallest weight first, then the
    addend and sign."""
    _check(c, r, t, words, sign)
    cw = [w.float() for w in split_words_plain(c.contiguous())]
    rw = [w.float() for w in split_words_plain(r.contiguous())]
    acc = None
    for i, j in PAIRS:
        term = torch.matmul(cw[i], rw[j])
        acc = term if acc is None else acc + term
    if t is None:
        return acc if sign > 0 else -acc
    return t + sign * acc


def mm_words_plain(c, r, t=None, words: int = WORDS, sign: int = 1):
    """The same function as one FP32 product (TF32 off): f32-true."""
    _check(c, r, t, words, sign)
    prod = torch.matmul(c, r)
    if t is None:
        return prod if sign > 0 else -prod
    return t + sign * prod


def mm_words(
    c: torch.Tensor,
    r: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    words: int = WORDS,
    sign: int = 1,
) -> torch.Tensor:
    """t + sign·(c @ r), f32-true, output written once → [G, M, N].

    On the card: one split pass per operand into bf16 word planes
    (scratch from `torch.empty`), then the tensor-core GEMM over them.
    """
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
    kp = -(-k // K_ALIGN) * K_ALIGN
    a_words = torch.empty((WORDS, g, m, kp), dtype=torch.bfloat16,
                          device=c.device)
    b_words = torch.empty((WORDS, g, n, kp), dtype=torch.bfloat16,
                          device=c.device)
    out = torch.empty((g, m, n), dtype=torch.float32, device=c.device)
    stream = _lib.stream_handle(c)
    lib = _lib.load()
    # c[g, m, k] as rows m; r[g, k, n] as rows n (its transpose, K-major)
    lib.call("morfem_split_words", c.data_ptr(), a_words.data_ptr(), g, m, k,
             kp, c.stride(0), c.stride(1), c.stride(2), stream)
    lib.call("morfem_split_words", r.data_ptr(), b_words.data_ptr(), g, n, k,
             kp, r.stride(0), r.stride(2), r.stride(1), stream)
    ts = t.stride() if t is not None else (0, 0, 0)
    lib.call(
        "morfem_mm_words", a_words.data_ptr(), b_words.data_ptr(),
        t.data_ptr() if t is not None else None, out.data_ptr(),
        g, m, n, kp, *ts, float(sign), stream,
    )
    mm_words.launches += 1
    return out


mm_words.launches = 0
