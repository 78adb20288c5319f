"""The plain reference: full-order solves and the waveguide's GSM.

Plain PyTorch, in the precision asked for.
It imports nothing of the program: the physical scalings and the GSM
formula are copied here from the upstream waveguide example
(``test_helpers.py``/``main.py``), and the operators come from the
configuration's own input maker, made again for the check.

    A(f) = C + f²·Γ,  Γ = GAMMA_SCALE·T,  b(f) = t_b(f)·B
    gim = j·2πf·ε0·xᵀb(f),  gam = gim⁻¹,  gsm = 2·(I + gam)⁻¹ − I

Both operators are symmetrised, (A + Aᵀ)/2, as the configuration's
``symmetrize=True`` states.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.constants import c as C_LIGHTSPEED
from scipy.constants import epsilon_0 as EPSILON_0
from scipy.constants import pi as PI

GAMMA_SCALE = -((2 * PI) / C_LIGHTSPEED) ** 2
B_SCALE = math.sqrt(1 / (8 * 1e-7 * PI**2))

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def port_coefficient(f, kte: float):
    """√(√((2πf/c)² − kTE²)/f), the port-mode coefficient (real above
    cutoff); works on tensors and arrays."""
    lib = torch if isinstance(f, torch.Tensor) else np
    k0_sq = ((2 * PI * f) / C_LIGHTSPEED) ** 2
    return lib.sqrt(lib.sqrt(k0_sq - kte**2) / f)


def gsm(f: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GSM [P, M, M] from solutions x [P, N, M] and right-hand sides b
    [P, N, M], in the complex type of x's precision."""
    ctype = _COMPLEX[x.dtype]
    etb = (x.transpose(-1, -2) @ b).to(ctype)
    gim = 1j * (2 * PI * EPSILON_0) * f.to(ctype)[:, None, None] * etb
    eye = torch.eye(gim.shape[-1], dtype=ctype, device=x.device)
    return 2 * torch.linalg.inv(eye + torch.linalg.inv(gim)) - eye


def waveguide_gsm(c, t, wp, kte, freqs, dtype=torch.float64,
                  device="cpu") -> np.ndarray:
    """The full-order GSM [P, M, M] (complex128 on the host) at `freqs`,
    every step in `dtype` (TF32 off), one LU a point (a batch at this
    size would take MAGMA's batched route)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def put(a):
        a = torch.as_tensor(np.asarray(a, np.float64), device=device)
        return a.to(dtype)

    cm, tm = put(c), put(t)
    cm = (cm + cm.T) * 0.5
    gamma = (tm + tm.T) * (0.5 * GAMMA_SCALE)
    b = put(np.asarray(wp) * B_SCALE)
    del tm
    f = put(np.asarray(freqs, np.float64))
    rhs = port_coefficient(f, kte)[:, None, None] * b[None]
    x = torch.stack([torch.linalg.solve(cm + (fi * fi) * gamma, ri)
                     for fi, ri in zip(f, rhs)])
    return gsm(f, x, rhs).to(torch.complex128).cpu().numpy()

