"""Banded matvec in diagonal storage — kernel K5.

Counterpart of the Pallas kernel behind
`morfem_tpu/ops/pallas/banded_matvec.py::banded_matvec_padded`; the CUDA
source is ``csrc/banded_matvec.cu``. It computes

    y[i] = Σ_d band[i, d] · x[i + d − half]        (x zero outside [0, N))

in f32, for a band of ``bw = 2·half + 1`` diagonals. `BandedAffineOperator`
(`ops/banded_matvec.py`) runs it for bands up to ``WIDE_BW`` diagonals,
inside the Krylov snapshot solves.

The band may be padded (the reference's `pad_band` layout, ≥ N rows and
≥ bw columns) or not: only rows < N and columns < bw are read. A CPU
tensor takes `banded_matvec_padded_plain`; a CUDA tensor launches the
kernel (64 columns of x per launch at most).
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

_MAX_COLS = 64  # columns of x per launch (the x halo lives in shared memory)


def _check(band_p, n, bw, half, x):
    if band_p.ndim != 2 or band_p.shape[0] < n or band_p.shape[1] < bw:
        raise ValueError(
            f"band must be [≥{n}, ≥{bw}], got {tuple(band_p.shape)}"
        )
    if bw != 2 * half + 1:
        raise ValueError(f"bw must be 2·half+1, got bw={bw}, half={half}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, M], got {tuple(x.shape)}")


def banded_matvec_padded_plain(band_p, n: int, bw: int, half: int, x):
    """The same function in plain PyTorch → [N, M] f32: one shifted
    multiply-add per diagonal, in the order d = 0 … bw−1."""
    _check(band_p, n, bw, half, x)
    band = band_p[:n, :bw].to(torch.float32)
    m = x.shape[1]
    x_pad = torch.zeros((n + 2 * half, m), dtype=torch.float32,
                        device=x.device)
    x_pad[half:half + n] = x
    y = torch.zeros((n, m), dtype=torch.float32, device=x.device)
    for d in range(bw):
        y = y + band[:, d:d + 1] * x_pad[d:d + n]
    return y


def banded_matvec_padded(band_p, n: int, bw: int, half: int, x):
    """y = A·x for a banded A → [N, M] f32 (x [N, M], any float dtype)."""
    if x.device.type == "cpu":
        return banded_matvec_padded_plain(band_p, n, bw, half, x)
    _check(band_p, n, bw, half, x)
    _lib.check_cuda_tensor("band", band_p, torch.float32)
    if x.device != band_p.device:
        raise ValueError(f"x is on {x.device}, band on {band_p.device}")
    if band_p.stride(1) != 1:
        raise ValueError("banded_matvec_padded needs a unit column stride")
    x32 = x.to(torch.float32)
    m = x32.shape[1]
    y = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    stream = _lib.stream_handle(x32)
    for lo in range(0, m, _MAX_COLS):
        xc = x32[:, lo:lo + _MAX_COLS].contiguous()
        yc = y if xc.shape[1] == m else torch.empty_like(xc)
        lib.call(
            "morfem_banded_matvec", band_p.data_ptr(), band_p.stride(0),
            xc.data_ptr(), yc.data_ptr(), n, bw, half, xc.shape[1], stream,
        )
        banded_matvec_padded.launches += 1
        if yc is not y:
            y[:, lo:lo + _MAX_COLS] = yc
    return y


banded_matvec_padded.launches = 0
