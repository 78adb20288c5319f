"""The upstream 10× tiled waveguide (``fake_interpolate_bigger_sample.py``),
N = 34,110, M = 2: the frozen input maker and the plain reference.

The input maker is the 3,411 waveguide's (`waveguide_3411.py`: the bundled
stand-in, its shapes and its fingerprint) plus the tiling rate; the
program tiles the blocks itself. The reference builds the tiled pencil as
one dense float64 matrix on the device and solves it whole, point by
point: no step of its solve knows that the matrix is block diagonal.

    C_N = diag(C, …, C),  Γ_N = diag(Γ, …, Γ),  B_N = [B; …; B]   (rate times)
"""

from __future__ import annotations

import numpy as np

from benchmark.configs import waveguide_3411
from benchmark.harness import reference as ref


def make_inputs(config, root):
    """{"c", "t", "wp", "kte", "rate"}: the raw waveguide block on the host
    (checked: N, M and the fingerprint) and the tiling rate."""
    rate = int(config["rate"])
    if rate < 1:
        raise ValueError(f"tiling rate {rate} is not a positive count")
    return {**waveguide_3411.make_inputs(config, root), "rate": rate}


def tiled_gsm(c, t, wp, kte, rate, freqs, dtype, device) -> np.ndarray:
    """The full-order GSM [P, M, M] (complex128 on the host) of the pencil
    tiled `rate` times at `freqs`, every step in `dtype` (TF32 off): both
    operators symmetrised, (A + Aᵀ)/2, as `harness/reference.py` does,
    then placed on the diagonal of one dense N×N matrix; one dense solve a
    point."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def put(a):
        a = torch.as_tensor(np.asarray(a, np.float64), device=device)
        return a.to(dtype)

    cb, tb = put(c), put(t)
    cm = torch.block_diag(*[(cb + cb.T) * 0.5] * rate)
    gamma = torch.block_diag(*[(tb + tb.T) * (0.5 * ref.GAMMA_SCALE)] * rate)
    del cb, tb
    b = put(np.tile(np.asarray(wp, np.float64) * ref.B_SCALE, (rate, 1)))
    f = put(np.asarray(freqs, np.float64))
    rhs = ref.port_coefficient(f, kte)[:, None, None] * b[None]
    x = torch.stack([torch.linalg.solve(cm + (fi * fi) * gamma, ri)
                     for fi, ri in zip(f, rhs)])
    return ref.gsm(f, x, rhs).to(torch.complex128).cpu().numpy()


def reference(config, freqs, dtype, device, inputs):
    """("gsm_err", the full-order GSM [P, M, M] at `freqs` in `dtype`)."""
    import torch

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    return "gsm_err", tiled_gsm(inputs["c"], inputs["t"], inputs["wp"],
                                inputs["kte"], inputs["rate"], freqs, dt,
                                device)
