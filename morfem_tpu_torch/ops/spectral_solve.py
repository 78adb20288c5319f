"""Full-order spectral sweep: diagonalize the N×N two-term pencil once.

Counterpart of `morfem_tpu/ops/spectral_solve.py`. For pencils
A(t) = c0(t)·A0 + c2(t)·A2 with one term (±)definite (the waveguide's
shape), the whole full-order sweep rides one generalized
eigendecomposition:

    W·Wᵀ = σ·A_spd                  (Cholesky)
    W⁻¹·A_other·W⁻ᵀ = U·Λ·Uᵀ        (symmetric eig)
    x(t) = W⁻ᵀU · diag(c_b(t)/(c_other(t)·Λ + σ·c_spd(t))) · UᵀW⁻¹·b

After the one-time O(N³) prepare, every point costs one slice of a float64
product. The reference runs the prepare on the host in NumPy because its
chip's f64 factorizations are emulated or missing; the card has native
f64, so here the Cholesky, the triangular solves and `eigh` run in float64
on the system's device. The general three-term or indefinite case stays on
`solve_sweep`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.system import AffineSystem


@dataclasses.dataclass(frozen=True)
class FullOrderSpectral:
    """Diagonalized full-order two-term pencil:
    x(t) = back · diag(cb/(c_other·λ + σ·c_spd)) · proj."""

    lam: torch.Tensor  # [N]
    proj: torch.Tensor  # [N, M] = Uᵀ·W⁻¹·b
    back: torch.Tensor  # [N, N] = W⁻ᵀ·U
    sigma: float  # ±scale of the SPD term (see prepare)
    swapped: bool  # a0 took the SPD role instead of a2
    sys: AffineSystem

    def sweep(self, ts=None, chunk: int = 512) -> torch.Tensor:
        return spectral_full_sweep(self, ts, chunk=chunk)


def prepare_spectral_full(
    sys: AffineSystem, config: MorfemConfig = DEFAULT_CONFIG
) -> FullOrderSpectral:
    """One-time diagonalization of the full-order pencil (f64, on the
    system's device).

    Raises ValueError when the pencil is not two-term real symmetric with a
    (±)definite term: callers fall back to `solve_sweep`.
    """
    if any(x.is_complex() for x in (sys.a0, sys.a1, sys.a2, sys.b)):
        raise ValueError("spectral full-order sweep supports real pencils only")
    f64 = torch.float64
    a0, a1, a2, b = (x.to(f64) for x in (sys.a0, sys.a1, sys.a2, sys.b))
    scale = float(torch.linalg.norm(a0) + torch.linalg.norm(a2))
    if float(torch.linalg.norm(a1)) > 1e-12 * max(scale, 1e-300):
        raise ValueError(
            "spectral full-order sweep requires a two-term pencil (a1 == 0)"
        )
    c, cb = sys.coefficients(sys.domain)
    if c.is_complex() or cb.is_complex():
        raise ValueError("complex coefficients: use solve_sweep")

    def sym(a, name):
        if not config.symmetrize:
            asym = float(torch.linalg.norm(a - a.T))
            if asym > 1e-9 * max(float(torch.linalg.norm(a)), 1e-300):
                raise ValueError(
                    f"{name} is not symmetric and config.symmetrize=False; "
                    "use solve_sweep"
                )
        return (a + a.T) * 0.5

    a0 = sym(a0, "a0")
    a2 = sym(a2, "a2")
    for swapped, (spd_term, other) in ((False, (a2, a0)), (True, (a0, a2))):
        # both terms normalized to unit scale before factorizing (the
        # waveguide pencil's terms differ by ~1e20); the scales fold back
        # into lam and sigma
        s_spd = float(spd_term.abs().max()) or 1.0
        s_other = float(other.abs().max()) or 1.0
        for sigma in (1.0, -1.0):
            w, info = torch.linalg.cholesky_ex(sigma * spd_term / s_spd)
            if int(info) != 0:
                continue
            wi_other = torch.linalg.solve_triangular(w, other / s_other,
                                                     upper=False)
            btilde = torch.linalg.solve_triangular(w, wi_other.T,
                                                   upper=False).T
            lam, u = torch.linalg.eigh((btilde + btilde.T) * 0.5)
            proj = u.T @ torch.linalg.solve_triangular(w, b, upper=False)
            back = torch.linalg.solve_triangular(w.T, u, upper=True)
            dtype = sys.a0.dtype
            return FullOrderSpectral(
                lam=(lam * s_other).to(dtype), proj=proj.to(dtype),
                back=back.to(dtype), sigma=sigma * s_spd, swapped=swapped,
                sys=sys,
            )
    raise ValueError(
        "spectral full-order sweep needs ±a0 or ±a2 positive definite; "
        "use solve_sweep"
    )


def spectral_full_sweep(
    fs: FullOrderSpectral, ts=None, chunk: int = 512
) -> torch.Tensor:
    """Sweep the diagonalized pencil → x [I, N, M]: one product
    back @ (coeff⊙proj) of width chunk·M per chunk of points."""
    sys = fs.sys
    ts = sys.domain if ts is None else torch.as_tensor(ts, device=sys.device)
    c, cb = sys.coefficients(ts)  # [I, 3], [I]
    n, m = fs.proj.shape
    i_pts = int(ts.shape[0])
    c_other = c[:, 2] if fs.swapped else c[:, 0]
    c_spd = c[:, 0] if fs.swapped else c[:, 2]
    denom = c_other[:, None] * fs.lam[None, :] + fs.sigma * c_spd[:, None]
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-300), denom)
    coeff = cb[:, None] / denom  # [I, N]
    out = torch.empty((i_pts, n, m), dtype=fs.back.dtype, device=sys.device)
    chunk = max(1, min(chunk, i_pts))
    for i0 in range(0, i_pts, chunk):
        cf = coeff[i0:i0 + chunk]
        k = cf.shape[0]
        p2 = (cf.T[:, :, None] * fs.proj[:, None, :]).reshape(n, k * m)
        out[i0:i0 + k] = (fs.back @ p2).reshape(n, k, m).transpose(0, 1)
    return out
