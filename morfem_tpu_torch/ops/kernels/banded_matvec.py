"""Banded matvec in diagonal storage — kernel K5.

Counterpart of the Pallas kernel behind
`morfem_tpu/ops/pallas/banded_matvec.py::banded_matvec_padded`; the CUDA
source is ``csrc/banded_matvec.cu``. It computes

    y[i] = Σ_d band[i, d] · x[i + d − half]        (x zero outside [0, N))

in f32, for a band of ``bw = 2·half + 1`` diagonals. `BandedAffineOperator`
(`ops/banded_matvec.py`) runs it for bands up to ``WIDE_BW`` diagonals,
inside the Krylov snapshot solves, through `bind_banded_matvec`: the band
is checked once, and each call checks only x and launches once.

The band may be padded (the reference's `pad_band` layout, ≥ N rows and
≥ bw columns) or not: only rows < N and columns < bw are read. x is
float32 or float64 (the kernel rounds a float64 x to f32 as it loads it,
as ``x.to(torch.float32)`` would; other types are cast to float32 first),
and y is float32 or float64 (``out_dtype``: the f32 sums, exactly as
``.to(out_dtype)`` gives them). A CPU tensor takes
`banded_matvec_padded_plain`; a CUDA tensor launches the kernel (64
columns of x per launch at most).
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

_MAX_COLS = 64  # columns of x per launch (the x halo lives in shared memory)
_BYTES = {torch.float32: 4, torch.float64: 8}


def _check_band(band_p, n, bw, half):
    if band_p.ndim != 2 or band_p.shape[0] < n or band_p.shape[1] < bw:
        raise ValueError(
            f"band must be [≥{n}, ≥{bw}], got {tuple(band_p.shape)}"
        )
    if bw != 2 * half + 1:
        raise ValueError(f"bw must be 2·half+1, got bw={bw}, half={half}")


def _check_x(n, x, out_dtype):
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, M], got {tuple(x.shape)}")
    if out_dtype not in _BYTES:
        raise ValueError(
            f"out_dtype must be float32 or float64, got {out_dtype}")


def banded_matvec_padded_plain(band_p, n: int, bw: int, half: int, x,
                               out_dtype=torch.float32):
    """The same function in plain PyTorch → [N, M] `out_dtype`: one shifted
    multiply-add per diagonal in f32, in the order d = 0 … bw−1, then
    ``.to(out_dtype)``."""
    _check_band(band_p, n, bw, half)
    _check_x(n, x, out_dtype)
    band = band_p[:n, :bw].to(torch.float32)
    m = x.shape[1]
    x_pad = torch.zeros((n + 2 * half, m), dtype=torch.float32,
                        device=x.device)
    x_pad[half:half + n] = x
    y = torch.zeros((n, m), dtype=torch.float32, device=x.device)
    for d in range(bw):
        y = y + band[:, d:d + 1] * x_pad[d:d + n]
    return y.to(out_dtype)


def _out_dtype(x, out_dtype):
    """`out_dtype`, or by default x's type where the kernel writes it (float32
    or float64), else float32."""
    if out_dtype is not None:
        return out_dtype
    return x.dtype if x.dtype in _BYTES else torch.float32


def bind_banded_matvec(band_p, n: int, bw: int, half: int):
    """Check the band once and return ``mv(x, out_dtype=None)``, the banded
    matvec of x [N, M] → [N, M] `out_dtype` (by default x's type when that
    is float32 or float64, else float32).

    On a CUDA band the closure holds the bound launcher, the band's
    pointer and the sizes; each call checks x's device, dtype and shape,
    allocates y and launches (one launch per 64 columns of x, none to cast
    x or y). On a CPU band it runs `banded_matvec_padded_plain`.
    """
    _check_band(band_p, n, bw, half)
    if band_p.device.type == "cpu":
        def plain(x, out_dtype=None):
            if x.device.type != "cpu":
                raise ValueError(f"x is on {x.device}, band on the CPU")
            return banded_matvec_padded_plain(band_p, n, bw, half, x,
                                              _out_dtype(x, out_dtype))

        return plain
    _lib.check_cuda_tensor("band", band_p, torch.float32)
    if band_p.stride(1) != 1:
        raise ValueError("banded_matvec_padded needs a unit column stride")
    fn = _lib.load().function("morfem_banded_matvec")
    dev, ptr, ld = band_p.device, band_p.data_ptr(), band_p.stride(0)

    def launch(xc, yc, stream):
        _lib.raise_on_error("morfem_banded_matvec", fn(
            ptr, ld, xc.data_ptr(), _BYTES[xc.dtype], yc.data_ptr(),
            _BYTES[yc.dtype], n, bw, half, xc.shape[1], stream))
        banded_matvec_padded.launches += 1

    def mv(x, out_dtype=None):
        out_dtype = _out_dtype(x, out_dtype)
        _check_x(n, x, out_dtype)
        if x.device != dev:
            raise ValueError(f"x is on {x.device}, band on {dev}")
        if x.dtype not in _BYTES:
            x = x.to(torch.float32)
        m = x.shape[1]
        y = torch.empty((n, m), dtype=out_dtype, device=dev)
        stream = _lib.stream_handle(y)
        if 0 < m <= _MAX_COLS:
            launch(x if x.is_contiguous() else x.contiguous(), y, stream)
            return y
        for lo in range(0, m, _MAX_COLS):
            xc = x[:, lo:lo + _MAX_COLS].contiguous()
            yc = torch.empty(xc.shape, dtype=out_dtype, device=dev)
            launch(xc, yc, stream)
            y[:, lo:lo + _MAX_COLS] = yc
        return y

    # the band stays alive as long as the closure that reads it
    mv.band = band_p
    return mv


def banded_matvec_padded(band_p, n: int, bw: int, half: int, x,
                         out_dtype=torch.float32):
    """y = A·x for a banded A → [N, M] `out_dtype` (x [N, M], float32 or
    float64; the sums in f32)."""
    return bind_banded_matvec(band_p, n, bw, half)(x, out_dtype)


banded_matvec_padded.launches = 0
