"""The port's block cyclic reduction against its block Thomas and the JAX
package's cyclic reduction, on the CPU: the factors at the block level, and
`banded_direct_solve(factorization="cr")` with its f64 refinement on
indefinite Helmholtz pencils, including odd block counts (padded with
identity blocks). Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morfem_tpu.ops import block_tridiag as jbt
from morfem_tpu.ops.pallas import banded_matvec as jbm

from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
from morfem_tpu_torch.ops import banded_matvec as tbm
from morfem_tpu_torch.ops import block_tridiag as tbt
from morfem_tpu_torch.utils.synthetic import banded_waveguide_system_2d

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _helmholtz(n, half=4, seed=6):
    """Indefinite banded A = C − k²·T, k² between two interior modes."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    c = np.zeros((n, n))
    c[i, i] = 2.0
    c[i[:-1], i[:-1] + 1] = c[i[:-1] + 1, i[:-1]] = -1.0
    c *= (n + 1) ** 2 / 40.0
    t = np.eye(n) * 1.5
    for d in range(1, half + 1):
        v = rng.uniform(-1, 1, n - d) * 0.1 / n
        t[i[:-d], i[:-d] + d] += v
        t[i[:-d] + d, i[:-d]] += v
    evals = np.linalg.eigvalsh(np.linalg.solve(t, c))
    k2 = float((evals[n // 3] + evals[n // 3 + 1]) / 2)
    return c - k2 * t


@pytest.mark.parametrize("n,block", [(512, 64), (300, 64), (900, 64)])
def test_cr_factors_match_the_jax_package(n, block):
    """n=300: 5 blocks, n=900: 15 (odd counts, padded at two levels)."""
    a = _helmholtz(n)
    band, h = jbm.to_banded(a)
    lj, dj, uj = jbt.band_to_blocks(jnp.asarray(band), h, block)
    lt, dt, ut = tbt.band_to_blocks(torch.from_numpy(np.asarray(band)), h,
                                    block)
    rhs = np.random.default_rng(13).normal(size=(n, 2))
    xj = np.asarray(jbt.cyclic_reduction_apply(
        jbt.cyclic_reduction_factor(lj, dj, uj, n), jnp.asarray(rhs)))
    crf = tbt.cyclic_reduction_factor(lt, dt, ut, n)
    assert len(crf.levels) == int(np.ceil(np.log2(dt.shape[0])))
    xt = _np(tbt.cyclic_reduction_apply(crf, torch.from_numpy(rhs)))
    ref = np.linalg.solve(a, rhs)
    # f32 factors: both approximate A⁻¹ to f32 quality and agree closely
    assert np.linalg.norm(xt - ref) / np.linalg.norm(ref) < 1e-3
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 1e-4


def _op_pair(mats):
    return (tbm.BandedAffineOperator(*mats, device=CPU),
            jbm.BandedAffineOperator(*mats))


@pytest.mark.parametrize("n", [512, 300])
def test_cr_solve_matches_scan_and_the_jax_package(n):
    a = _helmholtz(n)
    zero = np.zeros_like(a)
    op_t, op_j = _op_pair((a, zero, zero))
    c = np.array([1.0, 0.0, 0.0])
    rhs = np.random.default_rng(2).normal(size=(n, 2))
    kw = dict(block=64)
    x_cr, rr_cr, it_cr = tbt.banded_direct_solve(
        op_t, torch.from_numpy(c), torch.from_numpy(rhs),
        factorization="cr", **kw)
    x_sc, rr_sc, _ = tbt.banded_direct_solve(
        op_t, torch.from_numpy(c), torch.from_numpy(rhs), **kw)
    x_j, rr_j, it_j = jbt.banded_direct_solve(
        op_j, jnp.asarray(c), jnp.asarray(rhs), factorization="cr", **kw)
    ref = np.linalg.solve(a, rhs)
    scale = np.linalg.norm(ref)
    assert float(rr_cr.max()) < 1e-12 and float(rr_sc.max()) < 1e-12
    assert np.linalg.norm(_np(x_cr) - ref) < 1e-10 * scale
    assert np.linalg.norm(_np(x_cr) - _np(x_sc)) < 1e-10 * scale
    assert np.linalg.norm(_np(x_cr) - np.asarray(x_j)) < 1e-10 * scale
    # the same refinement in both packages: the f32 factors differ in
    # rounding, and once the residual sits at its roundoff floor (~10·ε·‖b‖)
    # the 3 % stagnation test stops after one or two more noise steps
    assert abs(it_cr - int(it_j)) <= 2


@pytest.mark.parametrize("f", [3.1e9, 4.0e9, 4.9e9])
def test_cr_on_the_2d_waveguide_pencil_like_the_jax_package(f):
    """The matrix-free route's pencil at p=36 (N=1,296; RCM half-bandwidth
    ≤ 128, so 11 blocks of 128: an odd count): CR agrees with scan within
    1e-10 and takes the refinement steps the JAX package's CR takes."""
    c_sp, t_sp, wp = banded_waveguide_system_2d(36, m=2, seed=1)
    mats = (c_sp, 0.0 * c_sp, (t_sp * GAMMA_SCALE).tocsr())
    op_t, perm = tbt.banded_via_rcm(*mats, device=CPU)
    op_j, perm_j = jbt.banded_via_rcm(*mats)
    np.testing.assert_array_equal(_np(perm), np.asarray(perm_j))
    b = wp[_np(perm)]
    cf = np.array([1.0, f, f * f])
    x_cr, rr_cr, it_cr = tbt.banded_direct_solve(
        op_t, torch.from_numpy(cf), torch.from_numpy(f * b),
        factorization="cr")
    x_sc, rr_sc, it_sc = tbt.banded_direct_solve(
        op_t, torch.from_numpy(cf), torch.from_numpy(f * b))
    x_j, rr_j, it_j = jbt.banded_direct_solve(
        op_j, jnp.asarray(cf), jnp.asarray(f * b), factorization="cr")
    nb = -(-op_t.n // 128)
    assert nb % 2 == 1
    scale = np.linalg.norm(_np(x_sc))
    assert np.linalg.norm(_np(x_cr) - _np(x_sc)) < 1e-10 * scale
    assert np.linalg.norm(_np(x_cr) - np.asarray(x_j)) < 1e-10 * scale
    assert float(rr_cr.max()) < 1e-12
    assert abs(it_cr - int(it_j)) <= 2  # see the test above


def test_unknown_factorization_is_refused():
    a = _helmholtz(64)
    op_t, _ = _op_pair((a, np.zeros_like(a), np.zeros_like(a)))
    with pytest.raises(ValueError, match="scan"):
        tbt.banded_direct_solve(op_t, torch.tensor([1.0, 0.0, 0.0]),
                                torch.ones((64, 1), dtype=torch.float64),
                                factorization="lu")
