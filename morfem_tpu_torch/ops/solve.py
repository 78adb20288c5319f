"""Dense linear solvers: mixed-precision LU with adaptive refinement.

Counterpart of `morfem_tpu/ops/solve.py`. The factorization runs in the
factor dtype (float32 by default) and the solution is refined in the
working dtype (float64): ``r = b − A·x;  x += LU⁻¹·r`` until the residual
reaches working precision or stops improving. Single solves use
`torch.linalg.lu_factor`/`lu_solve` (the reference leaves them to XLA, not
to a Pallas kernel). Residual products are plain float64 matmuls: the card
has native f64, so the reference's Ozaki and chunked-product workarounds
have no counterpart here.

Batched full-order sweeps of real systems with a float32 factor on a CUDA
device go to the blocked panel LU (`ops/panel_lu.py`) under
``factorization="auto"``, as the reference routes them on its accelerator.
``factorization="gj"`` solves real operators through the blocked
Gauss–Jordan inverse (`gj_solve_refined`, `ops/blocked_inverse.py`), point
by point.

The refinement is `ops/refine.py::refine`, a host loop that reads one
norm per iteration. Beside it, ``masked=True`` runs the masked fixed trip
`ops/refine.py::refine_masked`, which synchronises nothing and so can be
captured in a CUDA graph (the flagship step, `morfem_tpu_torch/entry.py`);
it always runs ``refine_iterations`` passes, so the host loop stays the
default.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.ops.assembly import assemble_at
from morfem_tpu_torch.ops.refine import host_norm, refine, refine_masked
from morfem_tpu_torch.system import AffineSystem

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


def factor_dtype_like(dtype: torch.dtype, factor_dtype_name: str):
    """Factorization dtype for a working dtype: complex stays complex, and
    the factor is never wider than the working dtype."""
    if dtype.is_complex:
        if dtype == torch.complex64 or factor_dtype_name == "float32":
            return torch.complex64
        return torch.complex128
    fd = getattr(torch, factor_dtype_name)
    return dtype if _bits(dtype) < _bits(fd) else fd


def lu_factor_each(a: torch.Tensor):
    """`lu_factor_ex` of each matrix of a batch [..., N, N] alone.

    Returns (lu, piv) as `torch.linalg.lu_factor` does, with no info check
    and no host synchronisation: PyTorch factors a batch of one with
    cuSOLVER on the current stream, which a CUDA graph captures, where a
    batched call may go to MAGMA, which it does not (PyTorch 2.11 on an
    H100 sends [6, 3411, 3411] and [100, 32, 32] there).
    """
    n = a.shape[-1]
    facs = [torch.linalg.lu_factor_ex(m)[:2] for m in a.reshape(-1, n, n)]
    lu = torch.stack([f[0] for f in facs]).reshape(a.shape)
    piv = torch.stack([f[1] for f in facs]).reshape(a.shape[:-1])
    return lu, piv


def lu_solve_refined(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    factor_dtype=torch.float32,
    refine_iterations: int = 2,
    masked: bool = False,
) -> torch.Tensor:
    """Solve ``a @ x = b`` by LU in `factor_dtype` + refinement in a's dtype
    (residuals are working-precision matmuls with ``a``).

    ``masked=True`` takes a's leading axes as independent systems (the
    reference's `vmap` of this function) and synchronises nothing: the
    factor is `lu_factor_each`'s, and each system refines to its own
    stopping rule through `refine_masked`.
    """
    work = torch.promote_types(a.dtype, b.dtype)
    if work.is_complex and not factor_dtype.is_complex:
        factor_dtype = _COMPLEX_OF[factor_dtype]
    factor = lu_factor_each if masked else torch.linalg.lu_factor
    lu, piv = factor(a.to(factor_dtype))

    def apply_factor(rhs):
        return torch.linalg.lu_solve(lu, piv, rhs.to(factor_dtype)).to(work)

    x = apply_factor(b)
    if refine_iterations > 0 and _bits(work) > _bits(factor_dtype):
        if masked:
            return refine_masked(a, b, x, apply_factor, refine_iterations,
                                 per_lane=True)
        a_w, b_w = a.to(work), b.to(work)
        tol = 10 * torch.finfo(work).eps * host_norm(b_w)
        x = refine(x, lambda x: b_w - a_w @ x, apply_factor, tol,
                   refine_iterations, norm=host_norm,
                   span_name="refine.step")[0]
    return x


def gj_solve_refined(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    refine_iterations: int = 2,
    panel: int = 256,
    sub: int = 8,
    masked: bool = False,
) -> torch.Tensor:
    """Solve ``a @ x = b`` through the blocked Gauss–Jordan f32 inverse
    + refinement in the working dtype.

    Real operators only. A complex right-hand side rides the same real
    inverse as a stacked [Re(b) | Im(b)] solve. Every apply of the inverse
    is an f32-true product (a coarser one would enter the refinement's
    iteration matrix as ‖E‖·cond(A) and diverge it): a plain FP32 `@` with
    TF32 off (`NUMERICS.md` row 33). ``masked=True``: a's leading axes are
    independent systems, each refined to its own stopping rule through
    `refine_masked` (as in `lu_solve_refined`).
    """
    from morfem_tpu_torch.ops.blocked_inverse import gj_inverse_f32

    if a.is_complex():
        raise ValueError(
            "gj_solve_refined factorizes real operators only; use "
            "lu_solve_refined (or the split-real path) for complex systems"
        )
    work = torch.promote_types(a.dtype, b.dtype)
    ainv = gj_inverse_f32(a, panel=panel, sub=sub)
    complex_rhs = work.is_complex

    def apply_factor(rhs):
        if complex_rhs:
            m = rhs.shape[-1]
            stacked = torch.cat([rhs.real, rhs.imag], dim=-1)
            sol = ainv @ stacked.to(torch.float32)
            sol = sol.to(rhs.real.dtype)
            return torch.complex(sol[..., :m], sol[..., m:]).to(work)
        return (ainv @ rhs.to(torch.float32)).to(work)

    x = apply_factor(b)
    if refine_iterations > 0 and (_bits(work) > 32 or complex_rhs):
        if masked:
            return refine_masked(a, b, x, apply_factor, refine_iterations,
                                 per_lane=True)
        a_w, b_w = a.to(work), b.to(work)
        tol = 10 * torch.finfo(work).eps * host_norm(b_w)
        x = refine(x, lambda x: b_w - a_w @ x, apply_factor, tol,
                   refine_iterations, norm=host_norm,
                   span_name="refine.step")[0]
    return x


def inv_refined(
    a: torch.Tensor,
    *,
    factor_dtype=torch.float32,
    refine_iterations: int = 2,
) -> torch.Tensor:
    """Matrix inverse by LU in `factor_dtype` + a fixed number of
    refinement steps in a's dtype (leading batch axes allowed)."""
    work = a.dtype
    eye = torch.eye(a.shape[-1], dtype=work, device=a.device).expand(
        a.shape)
    lu, piv = torch.linalg.lu_factor(a.to(factor_dtype))
    x = torch.linalg.lu_solve(lu, piv, eye.to(factor_dtype)).to(work)
    if refine_iterations > 0 and _bits(work) > _bits(factor_dtype):
        for _ in range(refine_iterations):
            r = eye - a @ x
            x = x + torch.linalg.lu_solve(lu, piv, r.to(factor_dtype)).to(
                work)
    return x


def use_gj_factorization(a_dtype: torch.dtype, n: int,
                         config: MorfemConfig) -> bool:
    """Whether a dense solve takes the Gauss–Jordan backend: only under an
    explicit ``factorization="gj"``, which refuses complex operators."""
    if config.factorization == "gj":
        if a_dtype.is_complex:
            raise ValueError(
                "factorization='gj' supports real operators only"
            )
        return True
    return False


def use_panel_factorization(
    a_dtype: torch.dtype, config: MorfemConfig, device: torch.device
) -> bool:
    """Whether a batched sweep takes the blocked panel-LU path.

    "panel" forces it (real operators only); "auto" picks it for real
    systems with a float32 factor on a CUDA device.
    """
    if config.factorization == "panel":
        if a_dtype.is_complex:
            raise ValueError(
                "factorization='panel' supports real operators only"
            )
        return True
    if config.factorization == "auto":
        return (
            not a_dtype.is_complex
            and config.factor_dtype_name == "float32"
            and torch.device(device).type == "cuda"
        )
    return False


def solve_dense(
    a: torch.Tensor,
    b: torch.Tensor,
    config: MorfemConfig = DEFAULT_CONFIG,
    masked: bool = False,
) -> torch.Tensor:
    """Direct dense solve honouring `config.factorization`.

    Only an explicit ``"panel"`` sends a single solve through the panel
    LU; ``"gj"`` takes the Gauss–Jordan inverse; ``"auto"`` keeps single
    solves on `torch.linalg` LU.

    ``masked=True`` takes a batch [G, N, N] of independent systems, the
    reference's `vmap(solve_dense)`: each refines to its own stopping rule
    as a masked fixed trip (`refine_masked`) and nothing synchronises the
    host, so a CUDA graph can capture the call. Under ``"panel"`` the
    panel LU (K1–K3) factors the whole batch at once.
    """
    if config.factorization == "panel" and not a.dtype.is_complex:
        from morfem_tpu_torch.ops.panel_lu import solve_batch_panel

        if masked:
            return solve_batch_panel(a, b, config, masked=True)
        return solve_batch_panel(a[None], b[None], config)[0]
    if use_gj_factorization(a.dtype, a.shape[-1], config):
        return gj_solve_refined(
            a, b, refine_iterations=config.refine_iterations, masked=masked)
    return lu_solve_refined(
        a,
        b,
        factor_dtype=factor_dtype_like(a.dtype, config.factor_dtype_name),
        refine_iterations=config.refine_iterations,
        masked=masked,
    )


def solve_point(
    sys: AffineSystem, t, config: MorfemConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Full-order solve at one point: assemble A(t), b(t), solve → [N, M]."""
    a, b = assemble_at(sys, t, symmetrize=config.symmetrize)
    return solve_dense(a, b, config)


def solve_batch(
    sys: AffineSystem, ts: torch.Tensor, config: MorfemConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Full-order solves at a batch of points, one after another → [B, N, M].

    Each point keeps its own adaptive refinement, as under the reference's
    `vmap`.
    """
    return torch.stack([solve_point(sys, t, config) for t in ts])


def solve_sweep(sys, config: MorfemConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Full-order sweep over the whole domain — the no-MOR baseline.

    Returns x [I, N, M]. Of an `AffineSystem`: real systems with a float32
    factor on a CUDA device (or any real system under
    ``factorization="panel"``) run the chunked panel-LU sweep; the rest
    solve point by point. A prepared sparse pencil (`mor/api.py::
    MatfreeSystem`) runs the banded sweep (`solve_sweep_banded`), and x
    comes back in the caller's row order.
    """
    if not isinstance(sys, AffineSystem):
        from morfem_tpu_torch.ops.block_tridiag import solve_sweep_banded

        sys.check_knobs(config)
        return solve_sweep_banded(sys, config)
    if use_panel_factorization(sys.b.dtype, config, sys.device):
        from morfem_tpu_torch.ops.panel_lu import solve_sweep_panel

        return solve_sweep_panel(sys, config)
    return solve_batch(sys, sys.domain, config)
