"""SPIKE distributed banded direct solves (gloo CPU ranks, tp=4) against
SciPy and the JAX package's (tp=4 on the conftest's virtual devices), the
"auto" routing of `solve_point_iterative` to SPIKE, the matrix-free greedy
on SPIKE snapshot solves, and the singular-Schur-block repair of the
banded direct solve (both packages).

Inputs are made with numpy from fixed seeds; the bars are those of
`tests/test_tp_banded.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import morfem_tpu.parallel as jpar
from morfem_tpu.ops.pallas.banded_matvec import (
    BandedAffineOperator as JBandedOp,
)
from morfem_tpu.ops.sparse import sparse_snapshot_basis as j_snapshot_basis
from morfem_tpu.parallel.tp_banded import spike_solve as j_spike_solve

from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
from morfem_tpu_torch.mor.reduced import sweep
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.ops.block_tridiag import banded_direct_solve
from morfem_tpu_torch.ops.sparse import (
    solve_point_iterative,
    sparse_snapshot_basis,
)
from morfem_tpu_torch.parallel.launch import MESH, Call, call_on_mesh, run_spmd
from morfem_tpu_torch.parallel.tp_banded import (
    SpikeBandedOperator,
    spike_solve,
)
from morfem_tpu_torch.system import (
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded_mat(n, half, seed, indefinite_shift=0.0):
    """Symmetric banded test matrix in diagonal storage + SciPy CSR."""
    rng = np.random.default_rng(seed)
    diags = [(6.0 + rng.random(n)) - indefinite_shift]
    offs = [0]
    for d in range(1, half + 1):
        diags.append(-0.4 * rng.random(n - d) - 0.1)
        offs.append(d)
    a = sp.diags(diags, offs)
    a = (a + a.T - sp.diags([diags[0]], [0])).tocsr()
    band = np.zeros((n, 2 * half + 1))
    acoo = a.tocoo()
    band[acoo.row, half + acoo.col - acoo.row] = acoo.data
    return a, band


def _helmholtz_pencil(n=4096, half=4, m=2, seed=7):
    """A0 − t²·I with A0's eigenvalues straddling t² ∈ [0.81, 2.56]."""
    rng = np.random.default_rng(seed)
    main = 1.2 + 1.1 * rng.random(n)
    a0 = sp.diags([main] + [np.full(n - d, -0.08)
                            for d in range(1, half + 1)],
                  [0] + list(range(1, half + 1)))
    a0 = (a0 + a0.T - sp.diags([main], [0])).tocsr()
    return a0, sp.csr_matrix((n, n)), (-1.0 * sp.eye(n)).tocsr(), \
        rng.standard_normal((n, m))


CASES = {
    "definite": dict(n=1500, half=6, seed=0, shift=0.0, rhs_seed=1, m=3),
    "indefinite": dict(n=2000, half=4, seed=2, shift=5.5, rhs_seed=3, m=2),
    "uneven": dict(n=1111, half=3, seed=4, shift=0.0, rhs_seed=5, m=1),
}


def _case(name):
    c = CASES[name]
    a, band = _banded_mat(c["n"], c["half"], c["seed"], c["shift"])
    rhs = np.random.default_rng(c["rhs_seed"]).standard_normal(
        (c["n"], c["m"]))
    return a, band, rhs


@pytest.fixture(scope="module")
def tp4():
    """One world of 4 ranks on a (1, 1, 4) mesh: SPIKE on three systems,
    the "auto" and "spike" and "direct" routes on one banded operator, and
    the matrix-free greedy with SPIKE snapshot solves."""
    calls = []
    for name in CASES:
        a, band, rhs = _case(name)
        tol = 1e-12 if name != "uneven" else 1e-10
        calls.append(Call(spike_solve, (torch.from_numpy(band),
                                        CASES[name]["half"],
                                        torch.from_numpy(rhs), MESH),
                          {"tol": tol}))
    a0, _ = _banded_mat(1024, 4, seed=9, indefinite_shift=7.0)
    a1 = sp.csr_matrix((1024, 1024))
    a2 = (-1.0 * sp.eye(1024)).tocsr()
    rhs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1024, 2)))
    c = torch.tensor([1.0, 0.0, 1.3], dtype=torch.float64)
    op = Call(SpikeBandedOperator, (a0, a1, a2),
              {"mesh": MESH, "symmetrize": False, "bandwidth": 4,
               "device": CPU})
    for method in ("auto", "spike", "direct"):
        calls.append(Call(solve_point_iterative, (op, c, rhs),
                          {"method": method, "return_residual": True}))
    h0, h1, h2, hb = _helmholtz_pencil()
    domain = torch.linspace(0.9, 1.6, 24, dtype=torch.float64)
    from morfem_tpu_torch import MorfemConfig

    cfg = MorfemConfig(symmetrize=False, error_threshold=1e-16,
                       max_greedy_iterations=30)
    hop = Call(SpikeBandedOperator, (h0, h1, h2),
               {"mesh": MESH, "symmetrize": False, "bandwidth": 4,
                "device": CPU})
    # t_a0 = 1, t_a2 = t², t_b = t (a1 = 0, so t_a1 is immaterial)
    calls.append(Call(greedy_basis_matfree,
                      (hop, torch.from_numpy(hb), domain, _default_t_a0,
                       _default_t_a1, _default_t_a2, _default_t_b),
                      {"config": cfg}))
    out = run_spmd(call_on_mesh, 4, "gloo", CPU, (1, 1, 4), calls)
    if len(jax.devices()) < 4:
        pytest.skip("needs the conftest's virtual devices")
    return dict(out=out, jm=jpar.make_mesh(dp=1, sp=1, tp=4),
                routed=(a0 + 1.3 * a2, rhs.numpy()),
                pencil=(h0, h2, hb, domain, cfg))


@pytest.mark.parametrize("idx,name", list(enumerate(CASES)))
def test_spike_matches_scipy_and_the_jax_package(tp4, idx, name):
    a, band, rhs = _case(name)
    x, relres, iters = tp4["out"][idx]
    half = CASES[name]["half"]
    assert x.shape == rhs.shape and iters >= 1
    ref = spla.spsolve(a.tocsc(), rhs).reshape(rhs.shape)
    if name == "uneven":  # N not divisible by tp·block: identity padding
        assert float(relres.max()) < 1e-9
        np.testing.assert_allclose(x.numpy()[:, 0], ref[:, 0], rtol=1e-7)
    else:
        assert float(relres.max()) < 1e-10
        np.testing.assert_allclose(x.numpy(), ref, rtol=1e-8, atol=1e-10)
    assert np.linalg.norm(x.numpy() - ref) < 1e-8 * np.linalg.norm(ref)
    # the JAX package at the same partition count
    tol = 1e-12 if name != "uneven" else 1e-10
    xj, rj, _ = j_spike_solve(jnp.asarray(band), half, jnp.asarray(rhs),
                              tp4["jm"], tol=tol)
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) < \
        1e-8 * np.linalg.norm(ref)


def test_auto_routes_a_sharded_banded_operator_to_spike(tp4):
    """`solve_point_iterative(method="auto")` picks SPIKE when the banded
    operator carries a mesh: its result equals method="spike" bit for bit
    (the tp=4 partitioning rounds differently from the single block-Thomas
    chain of "direct"), and matches SciPy."""
    (x_auto, r_auto), (x_spike, r_spike), (x_direct, _) = tp4["out"][3:6]
    assert torch.equal(x_auto, x_spike) and torch.equal(r_auto, r_spike)
    assert not torch.equal(x_auto, x_direct)
    mat, rhs = tp4["routed"]
    ref = spla.spsolve(mat.tocsc(), rhs)
    assert np.linalg.norm(x_auto.numpy() - ref) < 1e-9 * np.linalg.norm(ref)
    assert float(r_auto.max()) < 1e-9


def test_greedy_matfree_on_spike_snapshot_solves(tp4):
    """tp=4 matrix-free greedy on an indefinite banded Helmholtz pencil
    (N=4096): every snapshot solve runs SPIKE, and the reduced sweep
    reproduces SciPy's solutions within 1e-8."""
    res, rm = tp4["out"][6]
    h0, h2, hb, domain, cfg = tp4["pencil"]
    x = sweep(rm, cfg)
    worst = 0.0
    for i in (0, 11, 23):
        t = float(domain[i])
        ref = spla.spsolve((h0 + t * t * h2).tocsc(), t * hb)
        rec = (rm.q @ x[i]).numpy()
        worst = max(worst, np.linalg.norm(rec - ref) / np.linalg.norm(ref))
    assert worst < 1e-8, worst


# -- the singular Schur block ------------------------------------------------

def _swapped_identity(n=512):
    """The identity with a 2×2 swap on rows 127–128: block 0's diagonal
    block (rows 0..127) is singular, A is not."""
    a0 = sp.eye(n, format="lil")
    a0[127, 127] = a0[128, 128] = 0.0
    a0[127, 128] = a0[128, 127] = 1.0
    z = sp.csr_matrix((n, n))
    return a0.tocsr(), z, z


def test_singular_schur_block_escalates_in_both_packages():
    """A singular Schur complement gives non-finite factors, not an
    exception: the scan solve returns NaN residuals, the snapshot basis
    escalates to the shifted solve, and both packages' bases span SciPy's
    solution within 1e-12."""
    mats = _swapped_identity()
    n = mats[0].shape[0]
    b = np.random.default_rng(0).standard_normal((n, 2))
    dom = np.linspace(1.0, 2.0, 5)
    ref = spla.spsolve(mats[0].tocsc(), b)

    op = BandedAffineOperator(*mats, device=CPU)
    c = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    _, relres, iters = banded_direct_solve(op, c, torch.from_numpy(b))
    assert not bool(torch.isfinite(relres).any()) and iters == 0

    ones = torch.ones_like
    q = sparse_snapshot_basis(
        mats, torch.from_numpy(b), torch.from_numpy(dom), [0, 4],
        (ones, lambda t: t, lambda t: t * t, ones), op=op).numpy()
    jones = jnp.ones_like
    qj = np.asarray(j_snapshot_basis(
        mats, jnp.asarray(b), jnp.asarray(dom), jnp.asarray([0, 4]),
        (jones, lambda t: t, lambda t: t * t, jones), op=JBandedOp(*mats)))
    for basis in (q, qj):
        assert np.isfinite(basis).all()
        gap = ref - basis @ (basis.T @ ref)
        assert np.linalg.norm(gap) < 1e-12 * np.linalg.norm(ref)
