"""Fused reduced-sweep solve — kernel K4 — and the reduced LU sweep on it.

Counterpart of `morfem_tpu/ops/pallas/reduced_sweep.py`; the CUDA source
is ``csrc/reduced_sweep.cu``. For every frequency point i the kernel
assembles ``A_i = Σ_p c_p(t_i)·R_p`` (R pre-symmetrized in f32, identity
on the inactive diagonal) and solves ``A_i·x_i = rhs_i`` by Gauss–Jordan
elimination with implicit partial pivoting (largest unused |entry|, the
lowest row index winning a tie), in f32, without materialising the
[I, K, K] batch in device memory.

`gauss_jordan_sweep_solve` is the kernel's wrapper: a CPU tensor takes
`gauss_jordan_sweep_solve_plain`, a CUDA tensor launches the kernel in
one of its two variants, picked by `sweep_variant` from (K, M) alone: one
warp per point for K ≤ 64 and M ≤ 8 (the waveguide's K = 40, M = 2), one
thread block per point otherwise.
`fused_reduced_sweep` is the reduced sweep of `mor/reduced.py::sweep`
under ``use_pallas_reduced_sweep=True`` (the reference's
`pallas_reduced_sweep`): the f32 solve plus a fixed
``min(refine_iterations, 3)`` f64 refinement passes whose residual is
three [K, K] × [I, K, M] products.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

WARP_MAX_K, WARP_MAX_M = 64, 8  # the warp variant's register budget


def sweep_variant(k: int, m: int) -> str:
    """The K4 variant that solves K×K systems with M right-hand sides:
    ``"warp"`` (one warp per point, rows in registers) for K ≤ 64 and
    M ≤ 8, else ``"block"`` (one thread block per point, A in shared
    memory)."""
    return "warp" if k <= WARP_MAX_K and m <= WARP_MAX_M else "block"


def _prep(r0, r1, r2, c, rhs, inactive_diag, symmetrize):
    """f32 operands: R cast to f32 and THEN symmetrized (the reference's
    order), coefficients [I, 3], rhs [I, K, M], inactive diagonal [K]."""
    if rhs.ndim != 3:
        raise ValueError(f"rhs must be [I, K, M], got {tuple(rhs.shape)}")
    i_pts, k, _ = rhs.shape
    f32 = torch.float32

    def op(r):
        if tuple(r.shape) != (k, k):
            raise ValueError(f"R must be [{k}, {k}], got {tuple(r.shape)}")
        r = r.to(f32)
        if symmetrize:
            r = (r + r.T) * 0.5
        return r.contiguous()

    if tuple(c.shape) != (i_pts, 3):
        raise ValueError(f"c must be [{i_pts}, 3], got {tuple(c.shape)}")
    if tuple(inactive_diag.shape) != (k,):
        raise ValueError(
            f"inactive_diag must be [{k}], got {tuple(inactive_diag.shape)}"
        )
    return (op(r0), op(r1), op(r2), c.to(f32).contiguous(),
            rhs.to(f32).contiguous(), inactive_diag.to(f32).contiguous())


def gauss_jordan_sweep_solve_plain(
    r0, r1, r2, c, rhs, inactive_diag, symmetrize: bool = True
) -> torch.Tensor:
    """The same function in plain PyTorch, batched over the I points.

    Updates the whole K×K matrix each step, as the reference does; the
    kernel skips the columns left of the pivot column, which are never
    read again, so both give the same solution.
    """
    r0, r1, r2, c, b, diag = _prep(r0, r1, r2, c, rhs, inactive_diag,
                                   symmetrize)
    i_pts, k, _ = b.shape
    a = (c[:, 0, None, None] * r0 + c[:, 1, None, None] * r1
         + c[:, 2, None, None] * r2)
    a = a + torch.diag(diag)
    dev = a.device
    rows = torch.arange(i_pts, device=dev)
    lanes = torch.arange(k, device=dev)
    used = torch.zeros((i_pts, k), dtype=a.dtype, device=dev)
    piv = torch.empty((i_pts, k), dtype=torch.long, device=dev)
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=dev)
    for j in range(k):
        col = a[:, :, j].clone()
        score = col.abs() * (1.0 - used) - used
        top = score.max(dim=1, keepdim=True).values
        first = torch.where(score >= top, lanes, k).min(dim=1).values
        none = first == k  # NaN in the column: no pivot, NaN solution
        p = first.clamp(max=k - 1)
        inv = 1.0 / torch.where(none, nan, col[rows, p])
        row_a = a[rows, p] * inv[:, None]
        row_b = b[rows, p] * inv[:, None]
        a = a - col[:, :, None] * row_a[:, None, :]
        a[rows, p] = row_a
        b = b - row_b[:, None, :] * col[:, :, None]
        b[rows, p] = row_b
        used[rows, p] = 1.0
        piv[:, j] = p
    return b[rows[:, None], piv]


def gauss_jordan_sweep_solve(
    r0, r1, r2, c, rhs, inactive_diag, symmetrize: bool = True
) -> torch.Tensor:
    """Solve A(t_i)·x_i = rhs_i for all points → x [I, K, M] in f32.

    r0, r1, r2 [K, K], c [I, 3], rhs [I, K, M], inactive_diag [K] (1.0
    where the identity pads an inactive column), any float dtype.
    """
    if rhs.device.type == "cpu":
        return gauss_jordan_sweep_solve_plain(r0, r1, r2, c, rhs,
                                              inactive_diag, symmetrize)
    ops = _prep(r0, r1, r2, c, rhs, inactive_diag, symmetrize)
    for name, t in zip(("r0", "r1", "r2", "c", "rhs", "inactive_diag"), ops):
        _lib.check_cuda_tensor(name, t, torch.float32)
        if t.device != rhs.device:
            raise ValueError(f"{name} is on {t.device}, rhs on {rhs.device}")
    r0p, r1p, r2p, c32, rhs32, diag = ops
    i_pts, k, m = rhs32.shape
    x = torch.empty_like(rhs32)
    lib = _lib.load()
    lib.call(
        f"morfem_gj_sweep_{sweep_variant(k, m)}", r0p.data_ptr(),
        r1p.data_ptr(), r2p.data_ptr(), c32.data_ptr(), rhs32.data_ptr(),
        diag.data_ptr(), x.data_ptr(), i_pts, k, m,
        _lib.stream_handle(rhs32),
    )
    gauss_jordan_sweep_solve.launches += 1
    return x


gauss_jordan_sweep_solve.launches = 0


def fused_reduced_sweep(rm, ts, config) -> torch.Tensor:
    """Reduced sweep through K4 + f64 refinement → x [I, K, M].

    Matches `mor/reduced.py::sweep`'s batched-LU semantics: the f32
    elimination (the kernel), then ``min(config.refine_iterations, 3)``
    refinement passes whose residuals use the f64 R's, symmetrized in f64.
    Reduced systems are benign (cond ≲ 1e6), so three passes reach
    working precision. Models with addends beyond the 3-term pencil
    (``r_extra``) take the batched LU, as in the reference, and so do
    complex models: the kernel's operands are real f32, and a complex
    model handed to it would lose its imaginary parts.
    """
    from morfem_tpu_torch.mor.reduced import (
        assemble_reduced,
        solve_reduced_batch,
    )
    from morfem_tpu_torch.ops.orthonormalize import column_mask

    c, cb = rm.coefficients(ts)
    if rm.r_extra or any(x.is_complex() for x in (rm.r0, c, cb)):
        a, rhs = assemble_reduced(rm, ts, config)
        return solve_reduced_batch(a, rhs, config)
    mask = column_mask(rm.k, rm.ncols, rm.b_r.dtype, rm.b_r.device)
    rhs = cb[:, None, None] * (rm.b_r * mask[:, None])
    inactive = 1.0 - mask
    ops = (rm.r0, rm.r1, rm.r2)
    # the kernel's f32 operands once for all the solves (the wrapper's own
    # cast, then symmetrize), so that each solve only casts its rhs
    r0s, r1s, r2s, c32, _, diag32 = _prep(*ops, c, rhs, inactive,
                                          config.symmetrize)

    def solve(r):
        return gauss_jordan_sweep_solve(
            r0s, r1s, r2s, c32, r, diag32, symmetrize=False,
        ).to(rhs.dtype)

    def residual(x):
        ax = torch.zeros_like(x)
        for p, r in enumerate(ops):
            rx = r @ x
            if config.symmetrize:
                rx = (rx + r.T @ x) * 0.5
            ax = ax + c[:, p, None, None] * rx
        return rhs - (ax + inactive[None, :, None] * x)

    x = solve(rhs)
    for _ in range(min(config.refine_iterations, 3)):
        x = x + solve(residual(x))
    return x
