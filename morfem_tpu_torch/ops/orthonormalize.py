"""Orthonormalization of padded snapshot bases.

Counterpart of `morfem_tpu/ops/orthonormalize.py`: thin SVD of the whole
padded basis (the reference default) or twice-iterated classical
Gram-Schmidt of new columns (the USE_OPM path), each followed or guarded as
in the reference. The basis lives in a fixed [N, K] buffer whose first
``ncols`` columns are active and the rest exactly zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from morfem_tpu_torch.utils.timing import host_read


def column_mask(k: int, ncols, dtype=torch.float32, device=None):
    """[K] mask: 1 for columns < ncols, else 0."""
    return (torch.arange(k, device=device) < int(ncols)).to(dtype)


def cholesky_qr_refine(q: torch.Tensor, mask=None) -> torch.Tensor:
    """One CholeskyQR pass: G = QᴴQ, L = chol(G), Q ← Q·L⁻ᴴ.

    Padded (zero) columns get a unit diagonal in G and stay zero. Returns
    q unchanged when G is numerically singular, selected on the device, so
    nothing synchronises the host. (The reference needs this pass because
    the TPU's large-N f64 SVD is only ~3e-7 orthonormal; it is kept so
    both packages return the same basis class.)
    """
    k = q.shape[1]
    g = q.conj().T @ q
    if mask is not None:
        g = g + torch.diag(1.0 - mask)
    l, info = torch.linalg.cholesky_ex(g)
    eye = torch.eye(k, dtype=q.dtype, device=q.device)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    ok = (info == 0) & torch.isfinite(l).all()
    return torch.where(ok, q @ linv.conj().T, q)


def orthonormalize_svd(q: torch.Tensor) -> torch.Tensor:
    """Left singular vectors of q (thin SVD) + one CholeskyQR pass."""
    u = torch.linalg.svd(q, full_matrices=False)[0]
    return cholesky_qr_refine(u)


def orthonormalize_svd_masked(q: torch.Tensor, ncols) -> torch.Tensor:
    """Thin-SVD orthonormalization of a padded basis; inactive columns
    come back exactly zero."""
    n, k = q.shape
    mask = column_mask(k, ncols, q.dtype, q.device)
    u = torch.linalg.svd(q * mask, full_matrices=False)[0]
    if u.shape[1] < k:  # K > N: thin SVD returns [N, N]
        u = torch.nn.functional.pad(u, (0, k - u.shape[1]))
    u = u * mask
    return cholesky_qr_refine(u, mask) * mask


def orthonormalize_append_cgs2(
    q: torch.Tensor, ncols, new: torch.Tensor
) -> Tuple[torch.Tensor, int]:
    """Append `new` columns to a padded orthonormal basis via CGS2.

    A numerically dependent column (residual norm ≤ 1e-14 of its original
    norm) is skipped and the column count does not advance. Returns
    (q_updated, new_ncols).
    """
    n, k = q.shape
    q = q.clone()
    nc = int(ncols)
    tiny = torch.finfo(q.real.dtype).tiny
    for j in range(new.shape[1]):
        v = new[:, j]
        v0_norm = host_read(float, torch.linalg.norm(v))
        mask = column_mask(k, nc, q.dtype, q.device)
        for _ in range(2):
            v = v - q @ ((q.conj().T @ v) * mask)
        norm = host_read(float, torch.linalg.norm(v))
        if norm > max(1e-14 * v0_norm, tiny) and nc < k:
            q[:, nc] = v / norm
            nc += 1
    return q, nc
