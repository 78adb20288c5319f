"""The port's Gauss–Jordan factorization against the JAX package's, on the
CPU: `gj_inverse_f32` (blocked pivot-masked inverse), `gj_solve_refined`,
`inv_refined` and ``factorization="gj"`` through `morfem()`. Inputs are
made with numpy from fixed seeds; tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morfem_tpu as mt
from morfem_tpu.ops.solve import inv_refined as jax_inv_refined

import morfem_tpu_torch as pt
from morfem_tpu_torch.compat import system_from_numpy
from morfem_tpu_torch.ops.blocked_inverse import gj_panel_factor
from morfem_tpu_torch.ops.solve import inv_refined, use_gj_factorization

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _well_conditioned(rng, n, shift=3.0):
    a = rng.normal(size=(n, n)).astype(np.float32)
    return a + np.eye(n, dtype=np.float32) * shift


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize(
    "n,panel,sub",
    # (37, 20, 8): a panel that is not a multiple of sub (rounded up to 24)
    [(8, 4, 2), (37, 16, 4), (37, 20, 8), (100, 32, 8), (300, 64, 8)],
)
def test_gj_inverse_residual_and_the_jax_package(n, panel, sub):
    rng = np.random.default_rng(n + panel)
    a = _well_conditioned(rng, n)
    ai = _np(pt.gj_inverse_f32(torch.from_numpy(a), panel=panel, sub=sub))
    assert ai.dtype == np.float32
    ref = np.linalg.inv(a.astype(np.float64))
    # f32 elimination: relative error ~cond·ε_f32 (the reference's bound,
    # tests/test_blocked_inverse.py), and a residual below 1e-3 where the
    # matrix is well conditioned
    bound = 50 * np.linalg.cond(a.astype(np.float64)) * np.finfo(
        np.float32).eps
    assert np.linalg.norm(ai - ref) / np.linalg.norm(ref) < bound
    if n <= 100:
        assert np.linalg.norm(ai.astype(np.float64) @ a - np.eye(n)) < 1e-3
    aj = np.asarray(mt.gj_inverse_f32(jnp.asarray(a), panel=panel, sub=sub))
    # the same algorithm in f32: the two differ by f32 rounding only
    assert np.linalg.norm(ai - aj) / np.linalg.norm(aj) < bound


def test_gj_inverse_needs_pivoting_and_scales():
    rng = np.random.default_rng(3)
    n = 24
    a = _well_conditioned(rng, n)
    a[0, 0] = 0.0  # unpivoted elimination would divide by zero
    ai = _np(pt.gj_inverse_f32(torch.from_numpy(a), panel=8, sub=4))
    assert np.isfinite(ai).all()
    assert np.linalg.norm(ai @ a - np.eye(n)) < 1e-3
    # rows of very different scale: the row equilibration keeps 1/piv
    big = a * np.logspace(0, 9, n, dtype=np.float32)[:, None]
    bi = _np(pt.gj_inverse_f32(torch.from_numpy(big), panel=8, sub=4))
    assert np.linalg.norm(bi.astype(np.float64) @ big - np.eye(n)) < 1e-3


def test_gj_inverse_batched_and_rejections():
    rng = np.random.default_rng(5)
    a = np.stack([_well_conditioned(rng, 50) for _ in range(3)])
    ai = _np(pt.gj_inverse_f32(torch.from_numpy(a), panel=16, sub=4))
    for i in range(3):
        assert np.linalg.norm(ai[i] @ a[i] - np.eye(50)) < 1e-3
    with pytest.raises(ValueError, match="square"):
        pt.gj_inverse_f32(torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="real"):
        pt.gj_inverse_f32(torch.zeros((4, 4), dtype=torch.complex128))


def test_panel_factor_pivots_like_the_jax_package():
    from morfem_tpu.ops.blocked_inverse import gj_panel_factor as jax_pf

    rng = np.random.default_rng(8)
    pb = rng.normal(size=(40, 16)).astype(np.float32)
    avail = np.ones(40, bool)
    avail[[3, 17]] = False
    cp, piv, av = gj_panel_factor(torch.from_numpy(pb),
                                  torch.from_numpy(avail), 8)
    cpj, pivj, avj = jax_pf(jnp.asarray(pb), jnp.asarray(avail), 8)
    np.testing.assert_array_equal(_np(piv), np.asarray(pivj))
    np.testing.assert_array_equal(_np(av), np.asarray(avj))
    assert np.abs(_np(cp) - np.asarray(cpj)).max() <= 1e-5 * np.abs(
        np.asarray(cpj)).max()
    # a batch of one gives the same
    cpb, pivb, _ = gj_panel_factor(torch.from_numpy(pb)[None],
                                   torch.from_numpy(avail)[None], 8)
    assert torch.equal(cpb[0], cp) and torch.equal(pivb[0], piv)


@pytest.mark.parametrize("rhs_kind", ["real", "complex"])
def test_gj_solve_refined_matches_the_jax_package(rhs_kind):
    rng = np.random.default_rng(11)
    n = 120
    a = rng.normal(size=(n, n)) + 4 * np.eye(n)
    b = rng.normal(size=(n, 3))
    if rhs_kind == "complex":
        b = b + 1j * rng.normal(size=(n, 3))
    x = _np(pt.gj_solve_refined(torch.from_numpy(a), torch.from_numpy(b),
                                refine_iterations=25))
    xj = np.asarray(mt.gj_solve_refined(jnp.asarray(a), jnp.asarray(b),
                                        refine_iterations=25))
    assert x.dtype == b.dtype
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()
    ref = np.linalg.solve(a, b)
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()


def test_complex_operators_are_refused():
    a = torch.eye(8, dtype=torch.complex128)
    b = torch.ones((8, 1), dtype=torch.complex128)
    with pytest.raises(ValueError, match="real operators"):
        pt.gj_solve_refined(a, b)
    with pytest.raises(ValueError, match="real operators"):
        mt.gj_solve_refined(jnp.asarray(_np(a)), jnp.asarray(_np(b)))
    cfg = pt.MorfemConfig(factorization="gj")
    with pytest.raises(ValueError, match="real operators"):
        use_gj_factorization(torch.complex128, 8, cfg)
    with pytest.raises(ValueError, match="real operators"):
        pt.solve_dense(a, b, cfg)
    assert not use_gj_factorization(torch.float64, 8, pt.MorfemConfig())


def test_inv_refined_matches_numpy():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(2, 30, 30)) + 5 * np.eye(30)
    x = _np(inv_refined(torch.from_numpy(a)))
    ref = np.linalg.inv(a)
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()
    xj = np.asarray(jax_inv_refined(jnp.asarray(a)))
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(ref).max()


def _pencil(n=60, m=2, pts=30, seed=3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = (q * np.linspace(1.0, 400.0, n)) @ q.T
    k = (k + k.T) / 2
    m_mat = -(np.eye(n) + 0.05 * np.diag(rng.uniform(size=n)))
    b = rng.standard_normal((n, m))
    return np.linspace(2.1, 9.7, pts), k, np.zeros((n, n)), m_mat, b


def test_morfem_gj_matches_the_jax_package():
    arrays = _pencil()
    x, q, *_ = pt.morfem(*arrays, config=pt.MorfemConfig(
        factorization="gj", error_threshold=1e-10), device=CPU)
    xj, qj, *_ = mt.morfem(*arrays, config=mt.MorfemConfig(
        factorization="gj", error_threshold=1e-10))
    assert q.shape[1] == qj.shape[1]
    rec = np.einsum("nk,ikm->inm", _np(q), _np(x))
    recj = np.einsum("nk,ikm->inm", np.asarray(qj), np.asarray(xj))
    assert np.linalg.norm(rec - recj) <= 1e-10 * np.linalg.norm(recj)


def test_solve_sweep_under_gj_solves_point_by_point():
    arrays = _pencil(n=40, pts=6)
    sys_t = system_from_numpy(*arrays, device=CPU)
    x = pt.solve_sweep(sys_t, pt.MorfemConfig(factorization="gj"))
    ref = pt.solve_sweep(sys_t, pt.MorfemConfig(factorization="lu"))
    assert torch.linalg.norm(x - ref) <= 1e-12 * torch.linalg.norm(ref)
