"""Complex systems through real embeddings, and coefficient tables.

Counterpart of `morfem_tpu/ops/complex_split.py`. For ``A = Ar + i·Ai``
and ``b = br + i·bi``

    A·x = b   ⇔   K·[xr; xi] = [br; bi],   K = [[Ar, −Ai], [Ai, Ar]]

K is real, so the real solvers apply unchanged. The card has native
complex128 and the dense `morfem()` route runs complex systems natively;
the embeddings serve two purposes here:

* the dense helpers (`real_embedding`, `solve_complex_split`,
  `solve_complex`, `embed_affine_system`) keep the reference's API, so a
  caller can run a complex problem through the real pipeline;
* the INTERLEAVED sparse embedding (`embed_sparse_interleaved`: entry
  a_ij becomes the 2×2 block [[Re, −Im], [Im, Re]]) keeps band structure
  (half-bandwidth h → 2h+1), so the matrix-free route's RCM-banded solves
  and the banded matvec kernel K5 run complex pencils on real storage, as
  the reference does.

`eval_coefficient_table` evaluates a coefficient callable once over a
whole grid; `grid_lookup_coefficient` turns such a table into a real
callable that is exact on the grid (the matrix-free complex route's build
runs only on the grid).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.system import AffineSystem


def _host_array(a) -> np.ndarray:
    """Dense NumPy copy of an array, tensor or SciPy sparse matrix (never
    ``np.asarray`` of a sparse matrix: that is a 0-d object array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    if hasattr(a, "toarray"):
        return a.toarray()
    return np.asarray(a)


def real_embedding(a_re: torch.Tensor, a_im: torch.Tensor) -> torch.Tensor:
    """[[Ar, −Ai], [Ai, Ar]] — the real 2N×2N image of Ar + i·Ai (batched)."""
    top = torch.cat([a_re, -a_im], dim=-1)
    bot = torch.cat([a_im, a_re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def embed_rhs(b_re: torch.Tensor, b_im: torch.Tensor) -> torch.Tensor:
    """[br; bi] — real and imaginary parts stacked along the row axis."""
    return torch.cat([b_re, b_im], dim=-2)


def split_solution(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an embedded [..., 2N, M] solution into (x_re, x_im)."""
    n = x.shape[-2] // 2
    return x[..., :n, :], x[..., n:, :]


def solve_complex_split(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    config: MorfemConfig = DEFAULT_CONFIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve (Ar + i·Ai)·x = (br + i·bi) in real arithmetic.

    The 2N×2N embedding goes through `ops/solve.py::solve_dense` (an f32
    factor plus f64 refinement by default). Returns ``(x_re, x_im)``, each
    [..., N, M], on the inputs' device.
    """
    from morfem_tpu_torch.ops.solve import solve_dense

    x = solve_dense(real_embedding(a_re, a_im), embed_rhs(b_re, b_im),
                    config)
    return split_solution(x)


def solve_complex(a, b, config: MorfemConfig = DEFAULT_CONFIG,
                  device="cuda") -> torch.Tensor:
    """Complex in, complex out: split ``a`` (array, tensor or SciPy sparse)
    and ``b`` on the host, solve the real embedding on `device`, and return
    the complex solution there."""
    dev = resolve_device(device)
    a, b = _host_array(a), _host_array(b)
    work = np.zeros((), np.result_type(a.dtype, b.dtype)).real.dtype

    def part(x, imag):
        return torch.from_numpy(
            np.ascontiguousarray((x.imag if imag else x.real).astype(work))
        ).to(dev)

    x_re, x_im = solve_complex_split(part(a, False), part(a, True),
                                     part(b, False), part(b, True), config)
    return torch.complex(x_re, x_im)


def embed_affine_system(
    domain, a0, a1, a2, b,
    t_a0: Callable | None = None,
    t_a1: Callable | None = None,
    t_a2: Callable | None = None,
    t_b: Callable | None = None,
    config: MorfemConfig = DEFAULT_CONFIG,
    device="cuda",
) -> AffineSystem:
    """Lift a complex affine system to a real 2N-DOF `AffineSystem`.

    The embedding commutes with REAL linear combinations, so with
    coefficients that are real on the domain the embedded pipeline solves
    the complex problem; recover solutions with `split_solution`. Raises
    when ``config.symmetrize`` is on while an operator has a nonzero
    imaginary part: the embedding is then not symmetric, and (K + Kᵀ)/2
    would solve another problem.
    """
    arrs = [_host_array(x) for x in (a0, a1, a2, b)]
    work = np.zeros((), np.result_type(*(x.dtype for x in arrs))).real.dtype
    if config.symmetrize and any(
        np.iscomplexobj(x) and bool(np.any(x.imag != 0)) for x in arrs
    ):
        raise ValueError(
            "embed_affine_system: the real embedding of a complex operator "
            "is non-symmetric; run with config.symmetrize=False (the "
            "(A+Aᵀ)/2 step would change the problem)"
        )

    def split(x):
        return (torch.from_numpy(np.ascontiguousarray(x.real.astype(work))),
                torch.from_numpy(np.ascontiguousarray(x.imag.astype(work))))

    a0e, a1e, a2e = (real_embedding(*split(x)) for x in arrs[:3])
    be = embed_rhs(*split(arrs[3] if arrs[3].ndim == 2
                          else arrs[3][:, None]))
    kwargs = {name: fn for name, fn in (("t_a0", t_a0), ("t_a1", t_a1),
                                        ("t_a2", t_a2), ("t_b", t_b))
              if fn is not None}
    return AffineSystem.create(domain, a0e, a1e, a2e, be, device=device,
                               **kwargs)


def eval_coefficient_table(domain, fn) -> torch.Tensor:
    """A coefficient callable's values over the whole grid, in one call.

    The callable gets the grid as one float64 tensor (on the grid's device
    when `domain` is a tensor, else on the CPU); the table keeps the dtype
    it returns (float64 or complex128) and the grid's shape.
    """
    dom = torch.as_tensor(domain).to(torch.float64)
    vals = fn(dom)
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals), device=dom.device)
        if not (vals.is_complex() or vals.is_floating_point()):
            vals = vals.to(torch.float64)
    return torch.broadcast_to(vals.to(dom.device), dom.shape).clone()


def grid_lookup_coefficient(domain, table) -> Callable:
    """Exact grid-point coefficient callable from a per-point table.

    Returns t ↦ table[i(t)] with i(t) = searchsorted(domain, t), on t's
    device: exact at every grid point, which is where the build evaluates
    it (snapshots, estimator, sweeps). Off the grid it snaps to the right
    neighbour; the complex routes return a complex reduced model that is
    re-swept with the caller's own callables (`sweep_complex_reduced`).
    """
    dom = torch.as_tensor(domain).to(torch.float64).cpu()
    tab = torch.as_tensor(table).cpu()
    on_device = {}

    def fn(t):
        t = torch.as_tensor(t)
        dev = t.device
        if dev not in on_device:
            on_device[dev] = (dom.to(dev), tab.to(dev))
        d, tb = on_device[dev]
        idx = torch.searchsorted(d, t.to(torch.float64))
        return tb[idx.clamp(0, d.shape[0] - 1)]

    return fn


def embed_sparse_interleaved(a):
    """Sparse real 2N image of a complex sparse matrix, INTERLEAVED.

    Each entry a_ij becomes the 2×2 rotation block [[Re, −Im], [Im, Re]]
    at rows (2i, 2i+1) × cols (2j, 2j+1):

        E = Re(A) ⊗ I₂ + Im(A) ⊗ [[0, −1], [1, 0]]

    A half-bandwidth-h matrix embeds with half-bandwidth 2h+1, so the
    RCM-banded direct path and the banded kernels keep working at 2N.
    Returns SciPy CSR; nothing is densified.
    """
    import scipy.sparse as sp

    a = a.tocsr() if sp.issparse(a) else sp.csr_matrix(_host_array(a))
    eye2 = sp.csr_matrix(np.array([[1.0, 0.0], [0.0, 1.0]]))
    rot2 = sp.csr_matrix(np.array([[0.0, -1.0], [1.0, 0.0]]))
    re = sp.csr_matrix((np.real(a.data), a.indices, a.indptr),
                       shape=a.shape)
    e = sp.kron(re, eye2, format="csr")
    if np.iscomplexobj(a.data) and np.any(a.data.imag != 0):
        im = sp.csr_matrix((np.imag(a.data), a.indices, a.indptr),
                           shape=a.shape)
        e = (e + sp.kron(im, rot2, format="csr")).tocsr()
    return e


def embed_rhs_interleaved(b) -> np.ndarray:
    """[N, M] complex → [2N, M] real with rows (2i, 2i+1) = (Re, Im)."""
    b = _host_array(b)
    if b.ndim == 1:
        b = b[:, None]
    out = np.empty((2 * b.shape[0], b.shape[1]), b.real.dtype)
    out[0::2] = b.real
    out[1::2] = b.imag
    return out


def deinterleave(x):
    """[..., 2N, M] real (interleaved) → [..., N, M] complex (tensor or
    array alike)."""
    return x[..., 0::2, :] + 1j * x[..., 1::2, :]
