"""Carry state across from the JAX package as NumPy arrays.

`system_from_numpy` and `reduced_model_from_numpy` take the arrays of a
`morfem_tpu` AffineSystem or ReducedModel (converted with ``np.asarray``)
and return the port's objects on a device, so one state can be fed to both
packages. Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.system import (
    AffineSystem,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)


def system_from_numpy(
    domain, a0, a1, a2, b,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, device="cuda",
) -> AffineSystem:
    """AffineSystem from NumPy arrays (domain, a0, a1, a2, b)."""
    return AffineSystem.create(
        np.asarray(domain), np.asarray(a0), np.asarray(a1), np.asarray(a2),
        np.asarray(b), t_a0, t_a1, t_a2, t_b, device=device,
    )


def reduced_model_from_numpy(
    d: dict,
    t_a0=_default_t_a0, t_a1=_default_t_a1, t_a2=_default_t_a2,
    t_b=_default_t_b, device="cuda",
) -> ReducedModel:
    """ReducedModel from a mapping with keys domain, q, r0, r1, r2, b_r and
    ncols (NumPy arrays; ncols a scalar)."""
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(d[name]), device=dev)

    return ReducedModel(
        domain=t("domain"), q=t("q"), r0=t("r0"), r1=t("r1"), r2=t("r2"),
        b_r=t("b_r"), ncols=int(np.asarray(d["ncols"])), t_a0=t_a0,
        t_a1=t_a1, t_a2=t_a2, t_b=t_b,
    )
