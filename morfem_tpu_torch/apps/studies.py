"""Parameter studies: basis-size tradeoff and problem upscaling.

Counterpart of `morfem_tpu/apps/studies.py`:

* `basis_size_study` — MOR error against the number of equally
  distributed seed points (the reference study's 3..29). Every unique
  seed point is solved once; each size's basis is gathered from that bank
  into a padded [N, K_max] buffer with a column mask, orthonormalized,
  projected (`project`, one size at a time) and swept.
* `upscale_block_diag` — block-diagonal tiling of a system into a
  `rate`×-larger stress problem (each operator tiles itself).
* `upscale_interpolate` — bilinear resampling of an operator onto a
  rate×-finer index grid, symmetrized.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.reduced import (
    assemble_reduced,
    project,
    solve_reduced_batch,
)
from morfem_tpu_torch.ops.orthonormalize import orthonormalize_svd_masked
from morfem_tpu_torch.ops.solve import solve_batch, solve_sweep
from morfem_tpu_torch.system import AffineSystem


class BasisSizeStudy(NamedTuple):
    sizes: np.ndarray  # [S] number of seed points per variant
    ncols: np.ndarray  # [S] basis column counts (= sizes · M)
    x: torch.Tensor  # [S, I, K_max, M] reduced solutions (padded)
    q: torch.Tensor  # [S, N, K_max] padded bases
    rel_error: np.ndarray  # [S] relative solution error vs full-order


def basis_size_study(
    sys: AffineSystem,
    sizes: Sequence[int],
    config: MorfemConfig = DEFAULT_CONFIG,
    x_full=None,
) -> BasisSizeStudy:
    """Equally-distributed MOR accuracy for many basis sizes.

    sizes: seed-point counts (e.g. range(3, 30)); x_full: the full-order
    sweep [I, N, M] (computed here when omitted). rel_error[s] is
    ‖Q_s·x_s − x_full‖ / ‖x_full‖ over the whole grid.
    """
    sizes = np.asarray(sorted(sizes))
    i_pts, m, n = sys.num_points, sys.m, sys.n
    k_max = int(sizes.max()) * m
    # union of seed indices over all sizes → each snapshot solved once
    per_size_idx = [np.linspace(0, i_pts - 1, int(s)).astype(int)
                    for s in sizes]
    unique_idx = np.unique(np.concatenate(per_size_idx))
    pos = {int(t): j for j, t in enumerate(unique_idx)}
    snaps = solve_batch(
        sys, sys.domain[torch.as_tensor(unique_idx, device=sys.device)],
        config)
    bank = snaps.transpose(0, 1).reshape(n, -1)  # [N, U·M]
    gather_cols = np.zeros((len(sizes), k_max), dtype=np.int64)
    valid = np.zeros((len(sizes), k_max), dtype=bool)
    for si, idx in enumerate(per_size_idx):
        cols = np.concatenate([np.arange(m) + pos[int(t)] * m for t in idx])
        gather_cols[si, :len(cols)] = cols
        valid[si, :len(cols)] = True
    q_stack = bank[:, torch.as_tensor(gather_cols, device=sys.device)]
    q_stack = q_stack.permute(1, 0, 2) * torch.as_tensor(
        valid, device=sys.device)[:, None, :]
    ncols = sizes * m
    q_orth = torch.stack([orthonormalize_svd_masked(q_s, int(nc))
                          for q_s, nc in zip(q_stack, ncols)])
    if x_full is None:
        x_full = solve_sweep(sys, config)
    x_full = torch.as_tensor(x_full, device=sys.device)
    denom = torch.linalg.norm(x_full)
    xs, rel = [], []
    for s in range(len(sizes)):
        rm = project(sys, q_orth[s], ncols=int(ncols[s]))
        a, rhs = assemble_reduced(rm, sys.domain, config)
        x = solve_reduced_batch(a, rhs, config)
        rec = torch.einsum("nk,ikm->inm", q_orth[s], x)
        rel.append(float(torch.linalg.norm(rec - x_full) / denom))
        xs.append(x)
    return BasisSizeStudy(sizes=sizes, ncols=ncols, x=torch.stack(xs),
                          q=q_orth, rel_error=np.asarray(rel))


def upscale_block_diag(
    mats: Sequence[np.ndarray], b: np.ndarray, rate: int
) -> Tuple[list, np.ndarray]:
    """A `rate`×-larger system by block-diagonal tiling: each operator
    placed `rate` times along the diagonal, B stacked vertically."""
    out = []
    for a in mats:
        a = np.asarray(a)
        n = a.shape[0]
        big = np.zeros((rate * n, rate * n), dtype=a.dtype)
        for r in range(rate):
            big[r * n:(r + 1) * n, r * n:(r + 1) * n] = a
        out.append(big)
    return out, np.tile(np.asarray(b), (rate, 1))


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of the triangle-filter resampling that the
    reference's `jax.image.resize(..., "bilinear")` applies along one
    axis: half-pixel centres, the filter widened by 1/scale when
    shrinking (antialiasing), weights normalized per output sample, and
    samples whose centre falls outside the input left at zero."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def upscale_interpolate(a: np.ndarray, rate: float,
                        device="cuda") -> np.ndarray:
    """Bilinear upscaling of an operator onto a rate×-finer index grid,
    symmetrized after resampling. The two f64 resampling products run on
    `device`; the result comes back as numpy."""
    a = np.asarray(a)
    n = a.shape[0]
    new_n = int(round(n * rate))
    dev = resolve_device(device)
    w = torch.from_numpy(_bilinear_weights(n, new_n)).to(dev)
    big = w.T @ torch.as_tensor(a, device=dev).to(w.dtype) @ w
    return ((big + big.T) / 2).cpu().numpy()
