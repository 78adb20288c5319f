"""Upstream's equally-distributed basis (``implementation.py:13-14``,
``:197-214``) on the 10× tiled waveguide
(``fake_interpolate_bigger_sample.py``), N = 34,110, M = 2: the frozen
input maker (`waveguide_34110.py`'s) and the plain reference.

The reference is upstream's construction in plain PyTorch on the tiled
pencil built as one dense matrix, with nothing of its solve knowing that
the matrix is block diagonal:

    seeds  = the call's grid at linspace(0, I−1, floor(I·(1 − rate))),
             truncated to integers
    X      = [x(f_s) for each seed],  x(f) = (C + f²·Γ)⁻¹·t_b(f)·B
    Q      = the thin SVD's left singular vectors of X
    C_r, Γ_r, B_r = QᵀCQ, QᵀΓQ, QᵀB
    x_r(f) = (C_r + f²·Γ_r)⁻¹·t_b(f)·B_r,  the GSM from x_r and t_b(f)·B_r

(upstream ``test_helpers.py:53-67``: the GSM of the reduced solutions with
the reduced B). The check hands over the sampled frequencies only, so the
reference first finds the call's grid from them (`call_grid`).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.configs import waveguide_34110
from benchmark.harness import reference as ref

make_inputs = waveguide_34110.make_inputs

# a sampled frequency lies on the call's grid to within this share of a
# grid step (the grids' own rounding is ~1e-14 of a step)
ON_GRID = 1e-6


def call_grid(config, freqs) -> np.ndarray:
    """The call's grid [I]: the configuration's ``points`` equally spaced
    over [``lo_hz``, ``hi_hz``], shifted by less than half a step
    (`harness/traffic.py`), that holds every frequency of `freqs`. Raises
    ValueError when no such grid holds them all."""
    lo, hi = float(config["lo_hz"]), float(config["hi_hz"])
    n = int(config["points"])
    step = (hi - lo) / (n - 1)
    f = np.atleast_1d(np.asarray(freqs, np.float64))
    k = np.rint((f[0] - lo) / step)
    off = f[0] - lo - k * step
    if not (0 <= k < n and abs(off) < 0.5 * step * (1 - ON_GRID)):
        raise ValueError(f"{f[0]!r} Hz lies on no grid of {n} points over "
                         f"[{lo!r}, {hi!r}] shifted by less than half a step")
    grid = np.linspace(lo + off, hi + off, n)
    j = np.rint((f - grid[0]) / step)
    inside = (j >= 0) & (j < n)
    if not inside.all() or np.any(
            np.abs(f - grid[j.astype(int)]) > ON_GRID * step):
        raise ValueError(f"the frequencies {f!r} lie on no one shifted grid "
                         f"of {n} points over [{lo!r}, {hi!r}]")
    return grid


def seed_points(grid: np.ndarray, rate: float) -> np.ndarray:
    """Upstream's seeds: ``linspace(0, I−1, floor(I·(1 − rate)))`` of the
    grid, truncated to integers."""
    count = math.floor(len(grid) * (1 - rate))
    if count < 1:
        raise ValueError(f"rate {rate!r} leaves no seed of {len(grid)} "
                         "points")
    return grid[np.linspace(0, len(grid) - 1, count).astype(int)]


def equally_gsm(c, t, wp, kte, rate, seeds, freqs, dtype, device
                ) -> np.ndarray:
    """The GSM [P, M, M] (complex128 on the host) at `freqs` of the
    reduced model whose basis is the thin SVD of the full-order solutions
    at `seeds`, every step in `dtype` (TF32 off); the pencil tiled `rate`
    times, both operators symmetrised, placed on the diagonal of dense
    N×N matrices, and one dense solve a seed."""
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
    fs = put(np.asarray(seeds, np.float64))
    ts = ref.port_coefficient(fs, kte)
    x = torch.cat([torch.linalg.solve(cm + (fi * fi) * gamma, ti * b)
                   for fi, ti in zip(fs, ts)], dim=1)
    q = torch.linalg.svd(x, full_matrices=False)[0]
    del x
    c_r, g_r, b_r = q.T @ (cm @ q), q.T @ (gamma @ q), q.T @ b
    del cm, gamma
    f = put(np.asarray(freqs, np.float64))
    rhs = ref.port_coefficient(f, kte)[:, None, None] * b_r[None]
    x_r = torch.linalg.solve(c_r[None] + (f * f)[:, None, None] * g_r[None],
                             rhs)
    return ref.gsm(f, x_r, rhs).to(torch.complex128).cpu().numpy()


def reference(config, freqs, dtype, device, inputs):
    """("gsm_err", the GSM [P, M, M] at `freqs` of upstream's
    equally-distributed reduced model of the call's grid, in `dtype`)."""
    import torch

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    grid = call_grid(config, freqs)
    seeds = seed_points(
        grid, float(config["morfem"]["equally_distributed_reduction_rate"]))
    return "gsm_err", equally_gsm(inputs["c"], inputs["t"], inputs["wp"],
                                  inputs["kte"], inputs["rate"], seeds,
                                  freqs, dt, device)
