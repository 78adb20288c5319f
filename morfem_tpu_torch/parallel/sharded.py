"""Sharded execution paths: tp projection, sp sweeps, dp geometry batches.

Counterpart of `morfem_tpu/parallel/sharded.py`, on `torch.distributed`.

**Contract of every entry point of the parallel layer.** A JAX function
takes and returns global arrays; its counterpart here is called on every
rank with the same signature and a `DeviceMesh` (`parallel/mesh.py`) as
``mesh``. Every rank passes the whole input tensors and takes its own
rows, points or geometries by its coordinate on the mesh axis
(`mesh.get_local_rank(axis)`, the reference's `lax.axis_index`). Every
rank returns the whole output, gathered, as the JAX function returns its
global array. The collectives: `lax.psum` → `dist.all_reduce` on the
axis' process group, a tiled `lax.all_gather` → the list form of
`dist.all_gather` and `torch.cat`.

Blocks of rows or points are ceil(N / size) wide, the last one possibly
short; point grids that do not divide the axis are padded with the last
point and trimmed, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.greedy import GreedyResult, greedy_basis
from morfem_tpu_torch.mor.reduced import (
    ReducedModel,
    assemble_reduced,
    solve_reduced_batch,
)
from morfem_tpu_torch.ops.orthonormalize import orthonormalize_svd
from morfem_tpu_torch.ops.solve import solve_dense, solve_sweep
from morfem_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
    chunk,
    gather_rows,
)
from morfem_tpu_torch.system import AffineSystem, _coefficients


# ---------------------------------------------------------------------------
# tp: tensor-parallel projection over the DOF axis N
# ---------------------------------------------------------------------------


def tp_operator_images_and_project(
    ops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    b: torch.Tensor,
    q: torch.Tensor,
    mesh,
    axis: str = "tp",
):
    """U_p = A_p·Q and the Galerkin projections, N-axis sharded.

    Each rank takes its block of rows of A_p ([N/tp, N]), Q and B; one
    all_gather rebuilds Q from the row blocks, each rank computes its rows
    of U_p by a full local product, and the small contractions Qᵀ·U_p,
    Qᵀ·B (plain transpose), which reduce over N, are summed by one
    all_reduce each.

    Returns (u [3, N, K], r [3, K, K], b_r [K, M]), all whole.
    """
    n = q.shape[0]
    r0, r1, _ = chunk(n, axis_size(mesh, axis), axis_index(mesh, axis))
    q_l, b_l = q[r0:r1], b[r0:r1]
    q_full = gather_rows(q_l, n, mesh, axis)
    u_l = torch.stack([a[r0:r1] @ q_full for a in ops])
    r = all_reduce(torch.einsum("nk,pnl->pkl", q_l, u_l), mesh, axis)
    b_r = all_reduce(q_l.T @ b_l, mesh, axis)
    return gather_rows(u_l, n, mesh, axis, dim=1), r, b_r


# ---------------------------------------------------------------------------
# sp: frequency-axis sharded sweeps
# ---------------------------------------------------------------------------


def _sharded_points(ts: torch.Tensor, mesh, axis: str, fn) -> torch.Tensor:
    """fn over this rank's block of the points ts (padded with the last
    point to a multiple of the axis size), gathered and trimmed."""
    size = axis_size(mesh, axis)
    i_pts = ts.shape[0]
    pad = (-i_pts) % size
    if pad:
        ts = torch.cat([ts, ts[-1:].expand(pad)])
    start, stop, _ = chunk(ts.shape[0], size, axis_index(mesh, axis))
    return all_gather_cat(fn(ts[start:stop]), mesh, axis)[:i_pts]


def sharded_sweep(
    rm: ReducedModel,
    mesh,
    config: MorfemConfig = DEFAULT_CONFIG,
    ts: Optional[torch.Tensor] = None,
    axis: str = "sp",
) -> torch.Tensor:
    """Reduced sweep with the domain axis sharded across the mesh.

    Each rank assembles and LU-solves its block of points (the reduced
    operators are replicated: they are K×K-small); no communication but
    the final gather. Returns x [I, K, M].
    """
    ts = rm.domain if ts is None else torch.as_tensor(ts,
                                                      device=rm.r0.device)

    def local(ts_l):
        a, rhs = assemble_reduced(rm, ts_l, config)
        return solve_reduced_batch(a, rhs, config)

    return _sharded_points(ts, mesh, axis, local)


def sharded_spectral_sweep(
    sm,
    mesh,
    ts: Optional[torch.Tensor] = None,
    axis: str = "sp",
) -> torch.Tensor:
    """Spectral (diagonalized) reduced sweep, domain axis sharded.

    Works for `SpectralModel` and `QuadraticSpectralModel`
    (`mor/spectral.py`): each point is an independent O(K·M) evaluation
    against replicated eigen-data. Returns x [I, K, M].
    """
    ts = sm.rm.domain if ts is None else torch.as_tensor(
        ts, device=sm.rm.r0.device)
    return _sharded_points(ts, mesh, axis, sm.sweep)


def sharded_full_order_sweep(
    sys,
    mesh,
    config: MorfemConfig = DEFAULT_CONFIG,
    axis: str = "sp",
) -> torch.Tensor:
    """FULL-ORDER sweep with the frequency axis sharded across the mesh.

    The no-MOR baseline (`ops/solve.py::solve_sweep`) on each rank's block
    of the domain: on the card the panel-LU sweep with its kernels K1–K3
    runs on every rank. The operators are replicated (read-only) and the
    points are independent. Returns x [I, N, M].
    """
    return _sharded_points(
        sys.domain, mesh, axis,
        lambda dom: solve_sweep(sys.with_domain(dom), config))


# ---------------------------------------------------------------------------
# dp: multi-geometry MOR batches
# ---------------------------------------------------------------------------


def batch_systems(systems) -> Tuple[torch.Tensor, ...]:
    """Stack same-shape AffineSystems into batched operator tensors
    (a0, a1, a2, b, domain), each with a leading geometry axis."""
    return tuple(torch.stack([getattr(s, f) for s in systems])
                 for f in ("a0", "a1", "a2", "b", "domain"))


def _geometry_block(g: int, mesh):
    """Indices of this rank's geometries: the batch is padded with the last
    geometry to a multiple of the dp size."""
    if mesh is None:
        return list(range(g))
    dp = axis_size(mesh, "dp")
    start, stop, _ = chunk(g + (-g) % dp, dp, axis_index(mesh, "dp"))
    return [min(i, g - 1) for i in range(start, stop)]


def _gather_geometries(t: torch.Tensor, g: int, mesh) -> torch.Tensor:
    return t if mesh is None else all_gather_cat(t, mesh, "dp")[:g]


def multi_geometry_mor(
    a0: torch.Tensor,  # [G, N, N]
    a1: torch.Tensor,
    a2: torch.Tensor,
    b: torch.Tensor,  # [G, N, M]
    domain: torch.Tensor,  # [G, I]
    seed_indices,  # [S] seed positions
    coeffs,  # (t_a0, t_a1, t_a2, t_b), shared
    config: MorfemConfig = DEFAULT_CONFIG,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equally-distributed MOR for a batch of independent geometries.

    BASELINE config 5: each geometry runs the full pipeline — snapshot
    solves at the seed points, SVD orthonormalization, projection, reduced
    sweep. With a mesh the geometry axis is split over ``dp`` and the
    results gathered; the ranks of one dp block (its sp and tp ranks)
    compute the same geometries (the reference's tp/sp shardings inside a
    geometry are layout annotations that do not change the result).

    Returns (x [G, I, K, M] reduced solutions, q [G, N, K] bases).
    """
    t_a0, t_a1, t_a2, t_b = coeffs
    idx = torch.as_tensor(seed_indices, device=domain.device)

    def one_geometry(a0g, a1g, a2g, bg, dom):
        ts = dom[idx]
        c, cb = _coefficients((t_a0, t_a1, t_a2), t_b, ts)
        snaps = []
        for s in range(ts.shape[0]):
            a = c[s, 0] * a0g + c[s, 1] * a1g + c[s, 2] * a2g
            if config.symmetrize:
                a = (a + a.T) * 0.5
            snaps.append(solve_dense(a, cb[s] * bg, config))
        q = orthonormalize_svd(torch.cat(snaps, dim=1))  # [N, S·M]
        qt = q.T  # plain transpose (see mor/reduced.py)
        rm = ReducedModel(
            domain=dom, q=q, r0=qt @ (a0g @ q), r1=qt @ (a1g @ q),
            r2=qt @ (a2g @ q), b_r=qt @ bg, ncols=q.shape[1],
            t_a0=t_a0, t_a1=t_a1, t_a2=t_a2, t_b=t_b,
        )
        a_red, rhs_red = assemble_reduced(rm, dom, config)
        return solve_reduced_batch(a_red, rhs_red, config), q

    mine = _geometry_block(a0.shape[0], mesh)
    out = [one_geometry(a0[g], a1[g], a2[g], b[g], domain[g]) for g in mine]
    x = torch.stack([o[0] for o in out])
    q = torch.stack([o[1] for o in out])
    g = a0.shape[0]
    return _gather_geometries(x, g, mesh), _gather_geometries(q, g, mesh)


def multi_geometry_greedy(
    a0: torch.Tensor,  # [G, N, N]
    a1: torch.Tensor,
    a2: torch.Tensor,
    b: torch.Tensor,  # [G, N, M]
    domain: torch.Tensor,  # [G, I]
    coeffs,
    config: MorfemConfig = DEFAULT_CONFIG,
    mesh=None,
):
    """GREEDY MOR for a batch of independent geometries.

    Each geometry runs the greedy (`mor/greedy.py`) to its own basis size;
    with a mesh the geometry axis is split over ``dp``. Returns one
    batched `GreedyResult`, as the reference's vmapped greedy does: q [G,
    N, K] (every lane padded to the same K), and ncols, iterations,
    converged, failed_snapshot [G] and err_hist [G, max_greedy_iterations
    + 1, I] as tensors.
    """
    t_a0, t_a1, t_a2, t_b = coeffs
    mine = _geometry_block(a0.shape[0], mesh)
    res = [
        greedy_basis(AffineSystem(domain[g], a0[g], a1[g], a2[g], b[g],
                                  t_a0, t_a1, t_a2, t_b), config)
        for g in mine
    ]
    g = a0.shape[0]
    q = _gather_geometries(torch.stack([r.q for r in res]), g, mesh)
    err = _gather_geometries(torch.stack([r.err_hist for r in res]), g,
                             mesh)
    # the per-lane scalars travel as one small f64 block (exact integers)
    scal = _gather_geometries(torch.tensor(
        [[r.ncols, r.iterations, r.converged, r.failed_snapshot]
         for r in res], dtype=torch.float64, device=q.device), g, mesh)
    return GreedyResult(
        q=q, ncols=scal[:, 0].long(), iterations=scal[:, 1].long(),
        converged=scal[:, 2].bool(), err_hist=err,
        failed_snapshot=scal[:, 3].bool(),
    )
