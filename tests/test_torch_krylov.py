"""The port's block BiCGStab and restarted GMRES against the JAX package.

The reference's solvers are `lax.while_loop`s; the port's are host loops
with the same stopping rules. Both run the same matvec (a dense f64
product) on the same inputs, made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morfem_tpu.ops import krylov as jk

from morfem_tpu_torch.ops import krylov as tk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(n=120, m=2, seed=0, shift=6.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    a = (a + a.T) / 2 + shift * np.eye(n) + np.diag(rng.uniform(0, 3, n))
    return a, rng.standard_normal((n, m))


def _both(a):
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    return (lambda x: at @ x), (lambda x: aj @ x)


@pytest.mark.parametrize("m", [1, 2])
def test_bicgstab_matches(m):
    a, b = _system(m=m, seed=m)
    mv_t, mv_j = _both(a)
    d = np.diag(a).copy()
    x, rel = tk.bicgstab(mv_t, torch.from_numpy(b),
                         precond=lambda v: v / torch.from_numpy(d)[:, None],
                         tol=1e-12)
    xj, relj = jk.bicgstab(mv_j, jnp.asarray(b),
                           precond=lambda v: v / jnp.asarray(d)[:, None],
                           tol=1e-12)
    ref = np.linalg.solve(a, b)
    assert float(rel.max()) < 1e-12 and float(jnp.max(relj)) < 1e-12
    # the same iteration in the same f64 arithmetic: equal to roundoff
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-11 * np.abs(ref).max()
    assert np.abs(x.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


def test_bicgstab_vector_rhs_and_iteration_cap():
    a, b = _system(m=1, seed=7, shift=0.2)  # indefinite-ish: slow
    mv_t, mv_j = _both(a)
    x, rel = tk.bicgstab(mv_t, torch.from_numpy(b[:, 0]), maxiter=3)
    xj, relj = jk.bicgstab(mv_j, jnp.asarray(b[:, 0]), maxiter=3)
    assert x.shape == (a.shape[0],) and rel.ndim == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(rel), float(relj), rtol=1e-8)


@pytest.mark.parametrize("restart,maxiter", [(32, 5), (8, 3)])
def test_gmres_matches(restart, maxiter):
    a, b = _system(seed=restart, shift=1.0)
    mv_t, mv_j = _both(a)
    x, rel = tk.gmres(mv_t, torch.from_numpy(b), tol=1e-11,
                      maxiter=maxiter, restart=restart)
    xj, relj = jk.gmres(mv_j, jnp.asarray(b), tol=1e-11, maxiter=maxiter,
                        restart=restart)
    ref = np.linalg.solve(a, b)
    # the same restarted Arnoldi in f64: equal to roundoff, and the
    # achieved residuals agree (converged or capped alike)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-8 * np.abs(ref).max()
    np.testing.assert_allclose(rel.numpy(), np.asarray(relj), rtol=1e-3,
                               atol=1e-14)
    if restart == 32:
        assert float(rel.max()) < 1e-11


def test_gmres_right_preconditioned_vector():
    a, b = _system(m=1, seed=9, shift=2.0)
    d = torch.from_numpy(np.diag(a).copy())
    x, rel = tk.gmres(lambda v: torch.from_numpy(a) @ v,
                      torch.from_numpy(b[:, 0]),
                      precond=lambda v: v / (d[:, None] if v.ndim == 2 else d),
                      tol=1e-12, maxiter=4, restart=16)
    assert x.shape == (a.shape[0],)
    assert float(rel) < 1e-12
    ref = np.linalg.solve(a, b[:, 0])
    assert np.abs(x.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
