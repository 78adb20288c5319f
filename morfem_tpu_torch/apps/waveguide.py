"""Waveguide application: problem setup and GSM post-processing.

Counterpart of `morfem_tpu/apps/waveguide.py` (the reference example's
test_helpers.py + main.py): a 2-port waveguide, N = 3,411 DOF, swept over
3–5 GHz, with the generalized scattering matrix (S-parameters)

    gim = j·2πf·ε0·EᵀB,  gam = gim⁻¹,  gsm = 2·(I + gam)⁻¹ − I

computed for all points at once in native complex128 (the reference's
real Cayley form exists only because its chip has no complex128).

`tiled_waveguide_system` prepares the upstream stress case, the waveguide
tiled along a block diagonal (``fake_interpolate_bigger_sample.py``: 10×,
N = 34,110), as a SciPy-sparse pencil for the matrix-free route; its
full-order GSM sweep (`full_order_gsm`) runs the banded sweep.

`load_waveguide_data` reads the bundled synthetic stand-in
``data/synthetic_cache/synthetic_wg_<N>.npz`` and never writes into the
repository; other sizes are synthesized in memory (and cached only in a
``cache_dir`` the caller names).
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from scipy.constants import c as C_LIGHTSPEED
from scipy.constants import epsilon_0 as EPSILON_0
from scipy.constants import pi as PI

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.api import (
    MatfreeSystem,
    _run_sweep,
    build_reduced_model,
)
from morfem_tpu_torch.ops.solve import solve_sweep
from morfem_tpu_torch.system import AffineSystem
from morfem_tpu_torch.utils.timing import PhaseTimer

# TE-mode cutoff wavenumber of the bundled waveguide's ports
KTE_DEFAULT = 54.5976295582387
# physical scalings applied to the raw Ct/Tt/WP data
GAMMA_SCALE = -((2 * PI) / C_LIGHTSPEED) ** 2
B_SCALE = math.sqrt(1 / (8 * 1e-7 * PI**2))
BUNDLED_CACHE = Path(__file__).resolve().parents[2] / "data" / "synthetic_cache"


def b_coefficient(t, kte: float = KTE_DEFAULT):
    """Port-mode coefficient √(√((2πt/c)² − kTE²)/t); real above cutoff."""
    k0_sq = ((2 * PI * t) / C_LIGHTSPEED) ** 2
    return torch.sqrt(torch.sqrt(k0_sq - kte**2) / t)


def generalized_scattering_matrix(frequency, e, b) -> torch.Tensor:
    """GSM [..., M, M] complex128 from solved fields e and impulse vectors
    b in the same space (reduced solutions pair with the reduced b_r).

    The M×M inverses are `inv_ex`: a singular GIM gives non-finite
    values, as the reference's `jnp.linalg.inv` does, and nothing
    synchronises the host."""
    e = torch.as_tensor(e)
    b = torch.as_tensor(b, device=e.device)
    f = torch.as_tensor(frequency, device=e.device).to(torch.float64)
    etb = (e.transpose(-1, -2) @ b).to(torch.complex128)
    gim = 1j * (2 * PI * EPSILON_0) * f[..., None, None] * etb
    m = gim.shape[-1]
    eye = torch.eye(m, dtype=torch.complex128, device=e.device)
    gam = torch.linalg.inv_ex(gim)[0]
    return 2 * torch.linalg.inv_ex(eye + gam)[0] - eye


class WaveguideData(NamedTuple):
    """Raw (unscaled) waveguide FEM data: C, T, B port columns, kTE."""

    c_mat: np.ndarray
    t_mat: np.ndarray
    wp: np.ndarray
    kte: float
    synthetic: bool


def _spectral_ct_tt(rng, n: int, modes_in_band: int, shuffle: bool):
    """SPD C = V·diag(λ)·Vᵀ with `modes_in_band` of λ inside the 3–5 GHz
    k₀² band (off the 100-point grid), a tail below it and the bulk above,
    and T = I + a small banded symmetric part. Returns (C, T, V, n_below);
    with `shuffle` the λ are permuted before V is drawn."""
    k0sq_lo = (2 * PI * 3e9 / C_LIGHTSPEED) ** 2
    k0sq_hi = (2 * PI * 5e9 / C_LIGHTSPEED) ** 2
    n_below = max(2, n // 20)
    band_pos = (np.arange(modes_in_band) + 0.37) / modes_in_band
    lam = np.concatenate(
        [
            k0sq_lo * np.geomspace(1e-3, 0.8, n_below),
            k0sq_lo + band_pos * (k0sq_hi - k0sq_lo),
            k0sq_hi * np.geomspace(1.3, 300.0, n - n_below - modes_in_band),
        ]
    )
    if shuffle:
        rng.shuffle(lam)
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    c_mat = (v * lam) @ v.T
    c_mat = (c_mat + c_mat.T) / 2
    t_band = np.zeros((n, n))
    for k in range(1, 6):
        d = rng.uniform(-1.0, 1.0, size=n - k) * (0.3**k)
        idx = np.arange(n - k)
        t_band[idx, idx + k] = d
    t_mat = np.eye(n) + 0.05 * (t_band + t_band.T)
    return c_mat, t_mat, v, n_below


def synthesize_ct_tt(
    n: int, seed: int = 2024, modes_in_band: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic stand-ins for the missing Ct/Tt blobs: SPD (C, T)
    whose generalized spectrum has exactly `modes_in_band` modes in the
    3–5 GHz band (the reference package's numbers for the same seed)."""
    c_mat, t_mat, _, _ = _spectral_ct_tt(
        np.random.default_rng(seed), n, modes_in_band, shuffle=True)
    return c_mat, t_mat


def synthesize_waveguide(
    n: int, m: int = 2, seed: int = 2024, modes_in_band: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic waveguide (C, T, WP): the (C, T) of `_spectral_ct_tt` and
    port columns coupling strongly to the in-band modes plus a broadband
    background (the reference package's construction and numbers)."""
    rng = np.random.default_rng(seed)
    c_mat, t_mat, v, n_below = _spectral_ct_tt(rng, n, modes_in_band,
                                               shuffle=False)
    v_band = v[:, n_below:n_below + modes_in_band]
    alpha = rng.uniform(0.5, 1.5, size=(modes_in_band, m)) * rng.choice(
        [-1.0, 1.0], size=(modes_in_band, m)
    )
    wp = v_band @ alpha + 0.05 * rng.standard_normal((n, m))
    return c_mat, t_mat, wp


def calibrate_port_amplitude(c_mat, t_mat, wp, f_probe: float = 4.1e9,
                             kte: float = KTE_DEFAULT) -> np.ndarray:
    """Rescale port columns so the GIM is O(1) at mid-band (one probe
    solve; the GIM is quadratic in the port amplitude)."""
    gamma = t_mat * GAMMA_SCALE
    b = wp * B_SCALE
    a = c_mat + (f_probe**2) * gamma
    tb = math.sqrt(
        math.sqrt(((2 * PI * f_probe) / C_LIGHTSPEED) ** 2 - kte**2) / f_probe
    )
    e = np.linalg.solve(a, tb * b)
    y = 2 * PI * f_probe * EPSILON_0 * np.abs(e.T @ (tb * b))
    return wp * (1.0 / math.sqrt(max(np.linalg.norm(y), 1e-300)))


def load_waveguide_data(
    data_dir: Optional[str] = None,
    n_fallback: int = 3411,
    m_fallback: int = 2,
    cache_dir: Optional[str] = None,
) -> WaveguideData:
    """Load the waveguide data (reference layout: Ct.npy, Tt.npy, WP.npy,
    kTE1.npy in `data_dir`), else the synthetic stand-in.

    The stand-in is read from ``<cache_dir>/synthetic_wg_<N>.npz`` when a
    cache_dir is given, else from the bundled cache; when absent it is
    synthesized, and written only into a cache_dir the caller named.
    """
    def find(name):
        if data_dir is None:
            return None
        for cand in (name, name.lower(), name.upper()):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
        return None

    kte = KTE_DEFAULT
    p = find("kTE1.npy")
    if p:
        kte = float(np.asarray(np.load(p)).reshape(-1)[0])
    wp_path = find("WP.npy")
    if wp_path:
        wp = np.asarray(np.load(wp_path), dtype=np.float64)
        if wp.ndim == 1:
            wp = wp[:, None]
    else:
        rng = np.random.default_rng(7)
        wp = np.zeros((n_fallback, m_fallback))
        for j in range(m_fallback):
            rows = rng.choice(n_fallback, size=19, replace=False)
            wp[rows, j] = rng.uniform(0.3, 1.2, size=19)
    n = wp.shape[0]
    ct_path, tt_path = find("Ct.npy"), find("Tt.npy")
    if ct_path and tt_path:
        c_mat = np.asarray(np.load(ct_path), dtype=np.float64)
        t_mat = np.asarray(np.load(tt_path), dtype=np.float64)
        return WaveguideData(c_mat, t_mat, wp, kte, False)
    folder = Path(cache_dir) if cache_dir is not None else BUNDLED_CACHE
    cache = folder / f"synthetic_wg_{n}.npz"
    if cache.exists():
        with np.load(cache) as z:
            c_mat, t_mat, wp = z["c"], z["t"], z["wp"]
    else:
        c_mat, t_mat, wp = synthesize_waveguide(n, m=wp.shape[1])
        wp = calibrate_port_amplitude(c_mat, t_mat, wp, kte=kte)
        if cache_dir is not None:
            folder.mkdir(parents=True, exist_ok=True)
            np.savez(cache, c=c_mat, t=t_mat, wp=wp)
    return WaveguideData(c_mat, t_mat, wp, kte, True)


def waveguide_system(
    frequency_points, data: WaveguideData, dtype=torch.float64,
    device="cuda",
) -> AffineSystem:
    """The swept waveguide: slots (C, 0, Γ = scaled T) with coefficients
    (1, f, f²) and t_b the port-mode coefficient."""
    n = data.c_mat.shape[0]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    kte = data.kte
    return AffineSystem.create(
        np.asarray(frequency_points, np_dtype),
        np.asarray(data.c_mat, np_dtype),
        np.zeros((n, n), np_dtype),
        np.asarray(data.t_mat * GAMMA_SCALE, np_dtype),
        np.asarray(data.wp * B_SCALE, np_dtype),
        t_b=lambda t: b_coefficient(t, kte),
        dtype=dtype,
        device=device,
    )


def tiled_waveguide_pencil(data: WaveguideData, rate: int):
    """The waveguide tiled `rate` times along a block diagonal, as SciPy
    sparse matrices: (C, 0, Γ = scaled T, B) with C and Γ placed `rate`
    times on the diagonal and the port columns B stacked `rate` times
    (upstream ``fake_interpolate_bigger_sample.py``). Γ is tiled in its
    own slot: the upstream script tiles C there too, which would make the
    pencil a scalar multiple of C."""
    import scipy.sparse as sp

    if rate < 1:
        raise ValueError(f"rate must be ≥ 1, got {rate}")
    c = sp.csr_matrix(np.asarray(data.c_mat, np.float64))
    gamma = sp.csr_matrix(np.asarray(data.t_mat, np.float64) * GAMMA_SCALE)
    c_t = sp.block_diag([c] * rate, format="csr")
    gamma_t = sp.block_diag([gamma] * rate, format="csr")
    b = np.tile(np.asarray(data.wp, np.float64) * B_SCALE, (rate, 1))
    return c_t, sp.csr_matrix(c_t.shape), gamma_t, b


def tiled_waveguide_system(
    frequency_points, data: WaveguideData, rate: int,
    config: MorfemConfig = DEFAULT_CONFIG, device="cuda",
    timer: Optional[PhaseTimer] = None,
):
    """The tiled waveguide (`tiled_waveguide_pencil`) prepared once for
    the matrix-free route (`mor/api.py::MatfreeSystem`, with `config`'s
    ``symmetrize`` and ``band_max_half``); `mor_gsm` and `full_order_gsm`
    sweep it, re-gridded by ``with_domain``."""
    kte = data.kte
    return MatfreeSystem.create(
        np.asarray(frequency_points, np.float64),
        *tiled_waveguide_pencil(data, rate),
        t_b=lambda t: b_coefficient(t, kte), config=config, device=device,
        timer=timer,
    )


def full_order_gsm(
    sys,
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
) -> torch.Tensor:
    """Full-order ("No MOR") GSM sweep — the oracle path — of an
    `AffineSystem` (the dense route) or a prepared `MatfreeSystem` (the
    banded sweep, `solve_sweep`). The GSM of a `MatfreeSystem` is formed
    in its operator's row order, in which it holds b: EᵀB is the same
    when E and B are permuted alike."""
    timer = timer or PhaseTimer(disabled=True)
    with timer.span("full_order_gsm"):
        with timer.phase("full-order sweep"):
            x = solve_sweep(sys, config)
        with timer.phase("gsm"):
            if isinstance(sys, MatfreeSystem):
                x = x[:, sys.perm]
            _, cb = sys.coefficients(sys.domain)
            gsm = generalized_scattering_matrix(
                sys.domain, x, cb[:, None, None] * sys.b
            )
    return gsm


def mor_gsm(
    sys,
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
):
    """MOR GSM sweep of an `AffineSystem` (the dense route) or a prepared
    `MatfreeSystem` (the matrix-free route) → (gsm [I, M, M], trimmed
    ReducedModel, GreedyResult or None)."""
    timer = timer or PhaseTimer(disabled=True)
    with timer.span("mor_gsm"):
        rm, greedy_result = build_reduced_model(sys, config, timer)
        rm = rm.trim()
        with timer.phase("reduced sweep"):
            x_r = _run_sweep(rm, config)
        with timer.phase("gsm"):
            _, cb = rm.coefficients(rm.domain)
            gsm = generalized_scattering_matrix(
                rm.domain, x_r, cb[:, None, None] * rm.b_r
            )
    return gsm, rm, greedy_result



def equally_distributed_points(source, amount: int,
                               device="cuda") -> torch.Tensor:
    """Evenly spaced subset of a grid (indices ``linspace(0, I−1, amount)``
    truncated); raises when `amount` exceeds the grid's length. A tensor
    `source` keeps its device; any other grid is put on `device`."""
    if not isinstance(source, torch.Tensor):
        source = torch.as_tensor(source, device=resolve_device(device))
    if amount > source.shape[0]:
        raise ValueError(
            "amount can't be greater than the number of points in the source"
        )
    idx = np.linspace(0, source.shape[0] - 1, amount).astype(int)
    return source[torch.as_tensor(idx, device=source.device)]
