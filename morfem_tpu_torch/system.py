"""The parametric affine system definition.

PyTorch counterpart of `morfem_tpu/system.py`: the problem

    (t_a0(t)·A0 + t_a1(t)·A1 + t_a2(t)·A2) · X = t_b(t) · B     for t ∈ domain

held as dense tensors on one device. Coefficient callables are elementwise
functions of a tensor of points (torch operations), evaluated on the whole
domain at once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device

Coefficient = Callable[[torch.Tensor], torch.Tensor]


def _default_t_a0(t):
    return torch.ones_like(t)


def _default_t_a1(t):
    return t


def _default_t_a2(t):
    return t**2


def _default_t_b(t):
    return t


def _host_symmetric(x) -> bool:
    """Exact host-side symmetry check; False for tensors.

    NumPy arrays compare in ~30 ms at N=3411 and SciPy sparse through the
    structural ``(x != x.T).nnz == 0``. Tensors (possibly on the card)
    conservatively return False: the hint only skips a no-op.
    """
    if isinstance(x, torch.Tensor):
        return False
    if hasattr(x, "nnz") and hasattr(x, "T"):  # SciPy sparse
        return (x != x.T).nnz == 0
    xh = np.asarray(x)
    return (
        xh.ndim == 2
        and xh.shape[0] == xh.shape[1]
        and np.array_equal(xh, xh.T)
    )


def _as_dense(a, dtype, device) -> torch.Tensor:
    """NumPy arrays, tensors or SciPy sparse → a dense tensor on `device`."""
    if hasattr(a, "todense") and not isinstance(a, torch.Tensor):
        a = np.asarray(a.todense())
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass(frozen=True)
class AffineSystem:
    """Immutable parametric affine system on one device.

    ``a0, a1, a2`` are the [N, N] system-matrix addends, ``b`` the [N, M]
    impulse-vector part, ``domain`` the [I] grid of parameter points.
    ``symmetric_ops`` is True when the addends were verified exactly
    symmetric on the host at construction; then ``(A+Aᵀ)/2`` is a bit-exact
    no-op and assembly skips it.
    """

    domain: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    b: torch.Tensor
    t_a0: Coefficient = _default_t_a0
    t_a1: Coefficient = _default_t_a1
    t_a2: Coefficient = _default_t_a2
    t_b: Coefficient = _default_t_b
    symmetric_ops: bool = False

    @staticmethod
    def create(
        domain,
        a0,
        a1,
        a2,
        b,
        t_a0: Coefficient = _default_t_a0,
        t_a1: Coefficient = _default_t_a1,
        t_a2: Coefficient = _default_t_a2,
        t_b: Coefficient = _default_t_b,
        dtype=None,
        device="cuda",
    ) -> "AffineSystem":
        """Build an AffineSystem from array-like operators on `device`.

        Same signature and defaults as `morfem_tpu.AffineSystem.create`
        (t_a0=1, t_a1=t, t_a2=t², t_b=t), plus the device. The symmetry
        probe runs on the host inputs, before they are moved. A complex
        system (complex operators or b, or coefficients returning complex
        values) has all four in one complex dtype.
        """
        dev = resolve_device(device)
        symmetric = all(_host_symmetric(x) for x in (a0, a1, a2))
        domain = _as_dense(domain, dtype, dev)
        a0 = _as_dense(a0, dtype, dev)
        a1 = _as_dense(a1, dtype, dev)
        a2 = _as_dense(a2, dtype, dev)
        b = _as_dense(b, dtype, dev)
        n = a0.shape[0]
        if a0.shape != (n, n) or a1.shape != (n, n) or a2.shape != (n, n):
            raise ValueError(
                f"a0/a1/a2 must be square and same shape, got "
                f"{tuple(a0.shape)}, {tuple(a1.shape)}, {tuple(a2.shape)}"
            )
        if b.ndim == 1:
            b = b[:, None]
        if b.shape[0] != n:
            raise ValueError(f"b must have {n} rows, got {tuple(b.shape)}")
        # a system is complex when an operator, b or a coefficient's values
        # are: then operators and b are cast to the promoted complex dtype
        # here, once, and everything downstream reads their dtype
        c, cb = _coefficients((t_a0, t_a1, t_a2), t_b, domain[:1])
        dt = functools.reduce(
            torch.promote_types, (x.dtype for x in (a0, a1, a2, b, c, cb)))
        if dt.is_complex:
            a0, a1, a2, b = (x.to(dt) for x in (a0, a1, a2, b))
        return AffineSystem(
            domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b,
            symmetric_ops=symmetric,
        )

    @property
    def n(self) -> int:
        return self.a0.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[1]

    @property
    def num_points(self) -> int:
        return self.domain.shape[0]

    @property
    def dtype(self):
        return self.a0.dtype

    @property
    def device(self) -> torch.device:
        return self.a0.device

    def coefficients(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c [..., 3], cb [...]) for a tensor (or scalar) of points."""
        return _coefficients((self.t_a0, self.t_a1, self.t_a2), self.t_b, t)

    def operators(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (self.a0, self.a1, self.a2)

    def with_domain(self, domain) -> "AffineSystem":
        domain = torch.as_tensor(domain, device=self.device)
        return dataclasses.replace(self, domain=domain)


def _coefficients(fns, t_b, t):
    """Evaluate coefficient callables on points `t`, broadcast to t.shape.

    A callable may return a Python number; it is taken in t's dtype.
    """
    t = torch.as_tensor(t)

    def ev(fn):
        v = fn(t)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, dtype=t.dtype, device=t.device)
        return torch.broadcast_to(v, t.shape)

    c = torch.stack([ev(fn) for fn in fns], dim=-1)
    return c, ev(t_b)
