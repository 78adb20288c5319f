"""Self-consistent COMPLEX reduced models from the embedded pipelines.

Counterpart of `morfem_tpu/mor/complex_model.py`. The matrix-free complex
route builds its basis on the interleaved real 2N embedding; the caller is
owed the reference's return tuple ``(x, q, a0_r, a1_r, a2_r, b_r)`` in the
input's (complex) arithmetic, with ``a*_r = qᵀ·a*·q`` and ``b_r = qᵀ·b``.
This module turns the embedded basis into that model, in complex128 on
the basis' device:

* `compress_complex_basis` — the deinterleaved basis [N, Nr] may be
  complex-linearly dependent (v and i·v embed as two real directions but
  span one complex line); a thin complex SVD drops the redundancy;
* `project_complex` — plain-transpose (bilinear) Galerkin projection of
  the ORIGINAL complex operators (SciPy-sparse products on the host, as
  `ops/sparse.py::sparse_project` leaves them; dense operators on the
  device);
* `sweep_complex_reduced` — sweep a complex reduced model over any grid
  with the caller's own (possibly complex-valued) callables;
* `finish_complex_model` — compress, project, re-solve the build grid.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.ops.complex_split import eval_coefficient_table

Coefficient = Callable


def compress_complex_basis(q_c: torch.Tensor, rel_tol=None) -> torch.Tensor:
    """Complex-orthonormal basis for span_ℂ(q_c), redundancy dropped.

    Keeps the left singular directions with σ > rel_tol·σ₀. The default
    tolerance follows the basis' precision: max(N, Nr)·ε of its dtype,
    and never below 1e-13 (the reference's fixed value, which assumes a
    float64 basis).
    """
    q_c = torch.as_tensor(q_c)
    if rel_tol is None:
        eps = torch.finfo(q_c.real.dtype).eps
        rel_tol = max(1e-13, max(q_c.shape) * eps)
    u, s, _ = torch.linalg.svd(q_c, full_matrices=False)
    if s.numel() == 0 or float(s[0]) == 0.0:
        return u[:, :1]
    keep = int((s > rel_tol * s[0]).sum())
    return u[:, :max(keep, 1)]


def _dense_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def project_complex(
    q_hat: torch.Tensor, mats: Sequence, b
) -> Tuple[list, torch.Tensor]:
    """Bilinear Galerkin projection r_i = q̂ᵀ·A_i·q̂, b_r = q̂ᵀ·b.

    ``mats`` entries may be SciPy sparse (the N×Nr product runs on the
    host), arrays or tensors; ``b`` likewise. Returns the [Nr, Nr] list
    and b_r [Nr, M], complex128 on q̂'s device.
    """
    import scipy.sparse as sp

    dev = q_hat.device
    q = q_hat.to(torch.complex128)
    q_host = None
    rs = []
    for m in mats:
        if sp.issparse(m):
            if q_host is None:
                q_host = q.cpu().resolve_conj().numpy()
            mq = torch.from_numpy(m @ q_host).to(dev)
        else:
            mq = _dense_tensor(m, dev).to(torch.complex128) @ q
        rs.append(q.T @ mq.to(torch.complex128))
    b = torch.from_numpy(b.toarray()).to(dev) if sp.issparse(b) \
        else _dense_tensor(b, dev)
    if b.ndim == 1:
        b = b[:, None]
    return rs, q.T @ b.to(torch.complex128)


def sweep_complex_reduced(
    r0, r1, r2, b_r, grid,
    t_a0: Coefficient, t_a1: Coefficient, t_a2: Coefficient,
    t_b: Coefficient, device="cuda",
) -> torch.Tensor:
    """Sweep a complex reduced model over ANY grid → x [I, Nr, M].

    The serving path for complex systems: the model (arrays or tensors)
    moves to `device`, the callables are evaluated once over the grid
    (complex values are fine), and the [I, Nr, Nr] batch is assembled and
    solved in complex128 there. ``b_r`` may be [Nr] or [Nr, M] (a 1-D b_r
    is one right-hand side).
    """
    dev = resolve_device(device)
    ops = [torch.as_tensor(r, device=dev).to(torch.complex128)
           for r in (r0, r1, r2)]
    b_r = torch.as_tensor(b_r, device=dev).to(torch.complex128)
    if b_r.ndim == 1:
        b_r = b_r[:, None]
    grid = torch.as_tensor(grid).to(device=dev, dtype=torch.float64)
    c0, c1, c2, cb = (eval_coefficient_table(grid, fn).to(torch.complex128)
                      for fn in (t_a0, t_a1, t_a2, t_b))
    a = (c0[:, None, None] * ops[0] + c1[:, None, None] * ops[1]
         + c2[:, None, None] * ops[2])
    return torch.linalg.solve(a, cb[:, None, None] * b_r)


def finish_complex_model(
    q_c: torch.Tensor, a0, a1, a2, b, domain,
    t_a0: Coefficient, t_a1: Coefficient, t_a2: Coefficient,
    t_b: Coefficient,
):
    """Embedded-pipeline basis → the reference-contract complex tuple.

    Returns ``(x, q̂, r0, r1, r2, b_r)``, complex128 on q_c's device and
    self-consistent: x solves (Σ t_ai·r_i)·x = t_b·b_r on the build grid.
    """
    q_hat = compress_complex_basis(q_c)
    (r0, r1, r2), b_r = project_complex(q_hat, (a0, a1, a2), b)
    x = sweep_complex_reduced(r0, r1, r2, b_r, domain,
                              t_a0, t_a1, t_a2, t_b, device=q_hat.device)
    return x, q_hat, r0, r1, r2, b_r
