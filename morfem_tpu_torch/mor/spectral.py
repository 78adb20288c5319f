"""Spectral (diagonalized) reduced sweeps for two-term and quadratic pencils.

Counterpart of `morfem_tpu/mor/spectral.py`. The one-time prepare runs on
the host in NumPy/SciPy float64 (K×K work), exactly as in the reference;
the sweep is O(K·M) per point on the model's device:

* two-term ``A(t) = c0·R0 + c2·R2`` with ±R2 (or ±R0) positive definite:
  ``x(t) = W⁻ᵀU · diag(cb/(c_other·λ + σ·c_spd)) · UᵀW⁻¹b_r``;
* quadratic ``R0 + u·R1 + u²·R2`` (wave form c0 = 1, c2 = c1²) through the
  companion linearization. Its eigen-data is complex; the reference stores
  it split into real and imaginary f64 parts because its chip has no
  complex128, the port keeps it in native complex128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg as spl
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.ops.orthonormalize import column_mask
from morfem_tpu_torch.utils.timing import host_read


def _np(t: torch.Tensor) -> np.ndarray:
    return host_read(t.detach().cpu).numpy()


@dataclasses.dataclass(frozen=True)
class SpectralModel:
    """Diagonalized two-term reduced model."""

    lam: torch.Tensor  # [K] generalized eigenvalues
    proj: torch.Tensor  # [K, M] = Uᵀ·W⁻¹·b_r
    back: torch.Tensor  # [K, K] = W⁻ᵀ·U
    sigma: float  # ±scale applied to the SPD term
    swapped: bool  # True if R0 took the SPD role instead of R2
    mask: torch.Tensor  # [K] active-column mask
    rm: ReducedModel

    def sweep(self, ts=None) -> torch.Tensor:
        return spectral_sweep(self, ts)


def _reject_unsupported(rm: ReducedModel, config: MorfemConfig,
                        quadratic: bool):
    """Raise ValueError (the "auto" dispatch falls back to LU) when the
    real-symmetric diagonalization's assumptions do not hold."""
    if rm.r_extra:
        raise ValueError(
            "spectral sweeps support the classic 3-term pencil only; use "
            "the batched-LU sweep"
        )
    c, cb = rm.coefficients(rm.domain)
    named = [("r0", rm.r0), ("r1", rm.r1), ("r2", rm.r2), ("b_r", rm.b_r),
             ("evaluated coefficients", c), ("evaluated t_b", cb)]
    for name, a in named:
        if a.is_complex():
            raise ValueError(
                f"spectral sweep supports real systems only ({name} is "
                "complex); use the batched-LU sweep"
            )
    if not config.symmetrize:
        check = [("r0", rm.r0), ("r2", rm.r2)]
        if quadratic:
            check.append(("r1", rm.r1))
        for name, a in check:
            a = _np(a).astype(np.float64)
            asym = np.linalg.norm(a - a.T)
            if asym > 1e-9 * max(np.linalg.norm(a), 1e-300):
                raise ValueError(
                    f"spectral sweep symmetrizes {name} but "
                    "config.symmetrize=False and it is not numerically "
                    f"symmetric (‖a−aᵀ‖ = {asym:.2e}); use the batched-LU "
                    "sweep"
                )


def _sym(a) -> np.ndarray:
    a = _np(a).astype(np.float64)
    return (a + a.T) * 0.5


def prepare_spectral(
    rm: ReducedModel, config: MorfemConfig = DEFAULT_CONFIG
) -> SpectralModel:
    """Diagonalize a two-term reduced pencil (R1 must be ~zero)."""
    _reject_unsupported(rm, config, quadratic=False)
    r1_norm = host_read(float, torch.linalg.norm(rm.r1))
    scale = host_read(float,
                      torch.linalg.norm(rm.r0) + torch.linalg.norm(rm.r2))
    if r1_norm > 1e-12 * max(scale, 1e-300):
        raise ValueError(
            "spectral sweep requires a two-term pencil (r1 == 0); "
            f"got ‖r1‖ = {r1_norm:.2e}"
        )
    mask = column_mask(rm.k, rm.ncols, rm.r0.dtype, rm.r0.device)
    mask_np = _np(mask)
    pad = np.diag(1.0 - mask_np)
    r0 = _sym(rm.r0) + pad
    r2 = _sym(rm.r2) + pad
    b_masked = _np(rm.b_r).astype(np.float64) * mask_np[:, None]

    def dev(x):
        return torch.as_tensor(x, dtype=rm.r0.dtype, device=rm.r0.device)

    for swapped, (spd_term, other) in ((False, (r2, r0)), (True, (r0, r2))):
        # both terms normalized to unit scale before factorizing (the
        # waveguide pencil has ‖R0‖/‖R2‖ ~ 1e20); scales fold back into
        # lam and sigma
        s_spd = float(np.max(np.abs(spd_term))) or 1.0
        s_other = float(np.max(np.abs(other))) or 1.0
        for sigma in (1.0, -1.0):
            try:
                w = np.linalg.cholesky(sigma * spd_term / s_spd)
            except np.linalg.LinAlgError:
                continue
            wi_other = spl.solve_triangular(w, other / s_other, lower=True)
            btilde = spl.solve_triangular(w, wi_other.T, lower=True).T
            lam, u = np.linalg.eigh((btilde + btilde.T) * 0.5)
            wi_b = spl.solve_triangular(w, b_masked, lower=True)
            back = spl.solve_triangular(w.T, u, lower=False)
            return SpectralModel(
                lam=dev(lam * s_other), proj=dev(u.T @ wi_b), back=dev(back),
                sigma=sigma * s_spd, swapped=swapped, mask=mask, rm=rm,
            )
    raise ValueError(
        "spectral sweep needs ±R0 or ±R2 positive definite; "
        "fall back to the LU sweep"
    )


def spectral_sweep(sm: SpectralModel, ts=None) -> torch.Tensor:
    """Sweep via the precomputed diagonalization → x [I, K, M]."""
    rm = sm.rm
    if ts is None:
        ts = rm.domain
    c, cb = rm.coefficients(ts)
    c_other = c[:, 2] if sm.swapped else c[:, 0]
    c_spd = c[:, 0] if sm.swapped else c[:, 2]
    denom = c_other[:, None] * sm.lam[None, :] + sm.sigma * c_spd[:, None]
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-300), denom)
    coeff = cb[:, None] / denom  # [I, K]
    x = torch.einsum("kl,il,lm->ikm", sm.back, coeff, sm.proj)
    return x * sm.mask[None, :, None]


@dataclasses.dataclass(frozen=True)
class QuadraticSpectralModel:
    """Diagonalized quadratic pencil: x(t) = Re[V_top·diag(cb/(u−λ))·w]."""

    lam: torch.Tensor  # [2K] complex128
    vtop: torch.Tensor  # [K, 2K] complex128
    w: torch.Tensor  # [2K, M] complex128
    mask: torch.Tensor  # [K]
    rm: ReducedModel

    def sweep(self, ts=None) -> torch.Tensor:
        return spectral_sweep_quadratic(self, ts)


def prepare_spectral_quadratic(
    rm: ReducedModel, config: MorfemConfig = DEFAULT_CONFIG
) -> QuadraticSpectralModel:
    """Diagonalize a quadratic pencil with the wave-form coefficients."""
    _reject_unsupported(rm, config, quadratic=True)
    c, _ = rm.coefficients(rm.domain)
    c = _np(c)
    if not np.allclose(c[:, 0], 1.0, rtol=1e-12):
        raise ValueError("quadratic spectral sweep requires t_a0 == 1")
    if not np.allclose(c[:, 2], c[:, 1] ** 2, rtol=1e-12):
        raise ValueError(
            "quadratic spectral sweep requires t_a2 == t_a1**2 "
            "(the wave-equation form)"
        )
    mask = column_mask(rm.k, rm.ncols, rm.r0.dtype, rm.r0.device)
    mask_np = _np(mask)
    pad = np.diag(1.0 - mask_np)
    k = rm.k
    r0 = _sym(rm.r0) + pad
    r1 = _sym(rm.r1)
    r2 = _sym(rm.r2) + pad
    b_m = _np(rm.b_r).astype(np.float64) * mask_np[:, None]
    u_scale = float(np.max(np.abs(c[:, 1]))) or 1.0
    eye, zero = np.eye(k), np.zeros((k, k))
    l0 = np.block([[r0, r1 * u_scale], [zero, -eye]])
    l1 = np.block([[zero, r2 * u_scale**2], [eye, zero]])
    lam, v = spl.eig(l0, -l1)
    rhs0 = np.concatenate([b_m, np.zeros((k, b_m.shape[1]))], axis=0)
    w = np.linalg.solve(l1 @ v, rhs0)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.complex128,
                               device=rm.r0.device)

    return QuadraticSpectralModel(
        lam=dev(lam * u_scale), vtop=dev(v[:k]), w=dev(w * u_scale),
        mask=mask, rm=rm,
    )


def spectral_sweep_quadratic(
    sm: QuadraticSpectralModel, ts=None
) -> torch.Tensor:
    """Quadratic-pencil sweep in complex128 — O(K·M) per point."""
    rm = sm.rm
    if ts is None:
        ts = rm.domain
    c, cb = rm.coefficients(ts)
    denom = c[:, 1, None].to(torch.complex128) - sm.lam[None, :]
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-300), denom)
    y = (cb[:, None] / denom)[:, :, None] * sm.w[None]  # [I, 2K, M]
    x = torch.einsum("kl,ilm->ikm", sm.vtop, y).real
    return x.to(rm.r0.dtype) * sm.mask[None, :, None]
