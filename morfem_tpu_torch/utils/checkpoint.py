"""Checkpoint / resume for reduced models.

Counterpart of `morfem_tpu/utils/checkpoint.py`, with the same ``.npz``
format (version 2): the arrays ``domain, q, r0, r1, r2, b_r, ncols``, the
coefficient fingerprint ``coeff_probes, coeff_fingerprint`` and a JSON
``meta``. A file written by either package loads in the other.

Coefficient callables are code, not data, and are not stored: the caller
supplies them at load (defaulting to the wave-equation form, as `morfem`
does). The fingerprint, the values of (t_a0, t_a1, t_a2, t_b) at a few
probe points of the domain, lets the load warn when the callables given
differ from those the model was built with (a forgotten waveguide ``t_b``
would otherwise give silently wrong sweeps).

A model with extra addends (``r_extra``/``t_extra``, which the matrix-free
complex route builds) is refused at save: the format has no place for
them, and a three-term reload would sweep wrong without a warning.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.reduced import ReducedModel
from morfem_tpu_torch.system import (
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)

_FORMAT_VERSION = 2
_N_PROBES = 5


def _normalize_path(path: str) -> str:
    """np.savez appends '.npz' when absent; load does the same, so
    save('model') / load('model') round-trips."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _probe_points(domain: np.ndarray) -> np.ndarray:
    idx = np.linspace(0, len(domain) - 1, min(_N_PROBES, len(domain)))
    return domain[idx.astype(int)]


def _fingerprint(rm: ReducedModel, probes: np.ndarray) -> np.ndarray:
    """[4, n_probes] complex: each callable's values at the probes,
    broadcast to the probes' shape (a constant callable may return a
    number)."""
    ts = torch.as_tensor(probes, device=rm.r0.device)
    rows = []
    for fn in (rm.t_a0, rm.t_a1, rm.t_a2, rm.t_b):
        v = torch.as_tensor(fn(ts), device=ts.device)
        rows.append(_np(torch.broadcast_to(v, ts.shape)).astype(complex))
    return np.stack(rows)


def save_reduced_model(path: str, rm: ReducedModel,
                       metadata: Optional[dict] = None):
    """Persist a ReducedModel to one .npz file (on the host), with the
    coefficients' values at a few probe points (see module docstring)."""
    if rm.r_extra or rm.t_extra:
        raise ValueError(
            f"save_reduced_model: the model has {len(rm.r_extra)} extra "
            "addends (r_extra/t_extra) beyond r0, r1, r2; the checkpoint "
            "format stores the three-term pencil only, and the reloaded "
            "model would sweep wrong"
        )
    meta = {"format_version": _FORMAT_VERSION}
    if metadata:
        meta.update(metadata)
    path = _normalize_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    domain = _np(rm.domain)
    probes = _probe_points(domain)
    np.savez(
        path,
        domain=domain,
        q=_np(rm.q),
        r0=_np(rm.r0),
        r1=_np(rm.r1),
        r2=_np(rm.r2),
        b_r=_np(rm.b_r),
        ncols=np.asarray(int(rm.ncols)),
        coeff_probes=probes,
        coeff_fingerprint=_fingerprint(rm, probes),
        meta=json.dumps(meta),
    )


def load_reduced_model(
    path: str,
    t_a0=_default_t_a0,
    t_a1=_default_t_a1,
    t_a2=_default_t_a2,
    t_b=_default_t_b,
    check_coefficients: bool = True,
    rtol: float = 1e-9,
    device="cuda",
) -> ReducedModel:
    """Load a ReducedModel onto `device`; the caller supplies the
    coefficient callables.

    When the file carries a coefficient fingerprint (format ≥ 2) and
    ``check_coefficients`` is on, the callables are evaluated at the
    stored probes; a relative mismatch beyond ``rtol`` warns, naming the
    coefficient.
    """
    dev = resolve_device(device)
    with np.load(_normalize_path(path), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    version = meta.get("format_version")
    if version not in (1, _FORMAT_VERSION):
        raise ValueError(f"unsupported reduced-model format: {version}")

    def t(name):
        return torch.as_tensor(np.ascontiguousarray(arrays[name]), device=dev)

    rm = ReducedModel(
        domain=t("domain"), q=t("q"), r0=t("r0"), r1=t("r1"), r2=t("r2"),
        b_r=t("b_r"), ncols=int(arrays["ncols"]), t_a0=t_a0, t_a1=t_a1,
        t_a2=t_a2, t_b=t_b,
    )
    if check_coefficients and version >= 2 and "coeff_fingerprint" in arrays:
        saved = np.asarray(arrays["coeff_fingerprint"])
        now = _fingerprint(rm, np.asarray(arrays["coeff_probes"]))
        for i, name in enumerate(("t_a0", "t_a1", "t_a2", "t_b")):
            scale = max(float(np.max(np.abs(saved[i]))), 1e-300)
            err = float(np.max(np.abs(now[i] - saved[i]))) / scale
            if err > rtol:
                warnings.warn(
                    f"coefficient {name} supplied at load differs from the "
                    f"one the model was built with (rel mismatch {err:.1e} "
                    "at the stored probe points) — sweeps from this model "
                    "will be wrong; pass the original coefficient callables "
                    "or load with check_coefficients=False to silence",
                    stacklevel=2,
                )
    return rm
