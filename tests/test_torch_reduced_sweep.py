"""The port's fused reduced sweep (kernel K4) against the JAX package.

On the CPU the kernel's wrapper runs its plain PyTorch version; the JAX
side runs `gauss_jordan_sweep_solve` with its Pallas kernel in interpret
mode and `pallas_reduced_sweep` as the JAX package's own tests run them.
Inputs are made with numpy from fixed seeds and fed to both. The CUDA
kernel is held against the plain version on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morfem_tpu as mt
from morfem_tpu.ops.pallas.reduced_sweep import (
    gauss_jordan_sweep_solve as jax_gj,
    pallas_reduced_sweep as jax_fused_sweep,
)

import morfem_tpu_torch as pt
from morfem_tpu_torch.compat import reduced_model_from_numpy
from morfem_tpu_torch.mor.reduced import assemble_reduced, solve_reduced_batch
from morfem_tpu_torch.ops.kernels import (
    gauss_jordan_sweep_solve,
    gauss_jordan_sweep_solve_plain,
    launch_counts,
    reset_launch_counts,
)
from morfem_tpu_torch.ops.kernels.reduced_sweep import fused_reduced_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reduced_pencil(k, i_pts, m, seed):
    """R's of a K-column model whose last 3 columns are inactive (zero rows
    and columns, as projection onto a padded basis leaves them), with a
    dominant diagonal in R0; coefficients and right-hand sides per point."""
    rng = np.random.default_rng(seed)
    nc = k - 3
    rs = []
    for _ in range(3):
        r = rng.standard_normal((k, k))
        r[nc:, :] = 0.0
        r[:, nc:] = 0.0
        rs.append(r)
    rs[0] += np.diag(np.r_[np.full(nc, float(k)), np.zeros(k - nc)])
    c = rng.uniform(0.5, 2.0, (i_pts, 3))
    rhs = rng.standard_normal((i_pts, k, m))
    rhs[:, nc:] = 0.0
    inactive = np.r_[np.zeros(nc), np.ones(k - nc)]
    return rs, c, rhs, inactive


@pytest.mark.parametrize("k", [12, 37])
@pytest.mark.parametrize("symmetrize", [True, False])
def test_plain_gj_matches_pallas(k, symmetrize):
    rs, c, rhs, inactive = _reduced_pencil(k, 37, 2, seed=k)
    ref = np.asarray(jax_gj(*rs, c, rhs, inactive, symmetrize=symmetrize,
                            interpret=True))
    got = gauss_jordan_sweep_solve_plain(
        *map(_t, rs), _t(c), _t(rhs), _t(inactive), symmetrize=symmetrize
    ).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    # the same f32 elimination with the same pivots; the reference's
    # compiled arithmetic contracts some products into FMAs, so the two
    # agree to f32 rounding times the systems' growth (≲1e-5 of max|x|)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    # masked (inactive) rows solve the identity rows: exactly zero
    np.testing.assert_array_equal(got[:, k - 3:], 0.0)


def test_pivot_tie_goes_to_the_lowest_row():
    # column 0 holds |3| twice (rows 0 and 1): the lowest row must win.
    # Small integers make the reference's and the port's arithmetic
    # identical along one pivot sequence, and swapping the two rows (so
    # that the other row wins) changes the f32 result: equality with the
    # reference then pins the tie rule.
    a = np.array([[3.0, 8, 1, 1], [-3, 1, 5, -6], [-2, 0, 5, 0],
                  [0, -8, 0, 9]])
    b = np.array([-1.0, -9, 1, 5])[None, :, None]
    zero = np.zeros((4, 4))
    c = np.array([[1.0, 0.0, 0.0]])
    inactive = np.zeros(4)

    def port(a, b):
        return gauss_jordan_sweep_solve(
            _t(a), _t(zero), _t(zero), _t(c), _t(b), _t(inactive),
            symmetrize=False).numpy()

    ref = np.asarray(jax_gj(a, zero, zero, c, b, inactive, symmetrize=False,
                            interpret=True))
    np.testing.assert_array_equal(port(a, b), ref)
    swapped = port(a[[1, 0, 2, 3]], b[:, [1, 0, 2, 3]])
    assert (swapped != ref).any()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rs, c, rhs, inactive = _reduced_pencil(12, 5, 1, seed=1)
    args = (*map(_t, rs), _t(c), _t(rhs), _t(inactive))
    reset_launch_counts()
    assert torch.equal(gauss_jordan_sweep_solve(*args),
                       gauss_jordan_sweep_solve_plain(*args))
    assert launch_counts()["gauss_jordan_sweep_solve"] == 0
    with pytest.raises(ValueError):
        gauss_jordan_sweep_solve(*args[:3], _t(c[:, :2]), *args[4:])


def test_sweep_variant_is_a_pure_function_of_k_and_m():
    import inspect

    from morfem_tpu_torch.ops.kernels.reduced_sweep import sweep_variant

    assert list(inspect.signature(sweep_variant).parameters) == ["k", "m"]
    table = {(1, 1): "warp", (12, 2): "warp", (40, 2): "warp",
             (64, 8): "warp", (65, 1): "block", (84, 2): "block",
             (40, 9): "block", (200, 40): "block"}
    for (k, m), want in table.items():
        assert sweep_variant(k, m) == want
        assert sweep_variant(k, m) == sweep_variant(k, m)


def _jax_reduced_model(seed=4, n=60, pts=30):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = (q * np.linspace(1.0, 400.0, n)) @ q.T
    k = (k + k.T) / 2
    c = 0.1 * rng.standard_normal((n, n))
    m_mat = -(np.eye(n) + 0.05 * np.diag(rng.uniform(size=n)))
    b = rng.standard_normal((n, 2))
    domain = np.linspace(2.1, 9.7, pts)
    sys_ = mt.AffineSystem.create(jnp.asarray(domain), k, c, m_mat, b)
    with warnings.catch_warnings():
        # the basis stagnates short of the threshold; any basis will do
        warnings.simplefilter("ignore", UserWarning)
        rm, _ = mt.build_reduced_model(sys_,
                                       mt.MorfemConfig(error_threshold=1e-6))
    return rm


@pytest.mark.parametrize("trim", [False, True])
def test_sweep_with_the_fused_kernel_matches_pallas_reduced_sweep(trim):
    rm_j = _jax_reduced_model()
    if trim:
        rm_j = rm_j.trim()
    assert trim or int(rm_j.ncols) < rm_j.q.shape[1]  # padded columns
    d = {name: np.asarray(getattr(rm_j, name))
         for name in ("domain", "q", "r0", "r1", "r2", "b_r", "ncols")}
    rm_t = reduced_model_from_numpy(d, device="cpu")
    cfg_j = mt.MorfemConfig(use_pallas_reduced_sweep=True)
    cfg_t = pt.MorfemConfig(use_pallas_reduced_sweep=True)
    ts = np.linspace(2.0, 9.9, 53)  # a serving grid off the build grid
    ref = np.asarray(jax_fused_sweep(rm_j, jnp.asarray(ts), cfg_j))
    got = pt.sweep(rm_t, cfg_t, ts=ts).numpy()
    direct = fused_reduced_sweep(rm_t, torch.from_numpy(ts), cfg_t).numpy()
    np.testing.assert_array_equal(got, direct)
    # three f64 refinement passes around f32 eliminations: both reach
    # ~1e-13 of the solution scale
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    # and agree with the batched-LU sweep of the same model
    a, rhs = assemble_reduced(rm_t, torch.from_numpy(ts), cfg_t)
    lu = solve_reduced_batch(a, rhs, cfg_t).numpy()
    assert np.abs(got - lu).max() <= 1e-10 * np.abs(lu).max()
