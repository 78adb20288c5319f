"""Complex systems in the port against the JAX package, on the CPU.

Mirrors tests/test_complex_split.py: the same inputs, made with numpy from
fixed seeds, with paired torch and jnp coefficient callables, go through
`morfem_tpu` and `morfem_tpu_torch`; results are compared by
basis-invariant quantities (Q·x) and against NumPy/SciPy complex solves,
at the reference tests' bars. The JAX package's banded matvec runs its
jnp path on the CPU; the port's kernel wrappers take their plain versions
for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

import morfem_tpu as mt
from morfem_tpu.mor import complex_model as jcm
from morfem_tpu.ops import complex_split as jcs
from morfem_tpu.ops.pallas.banded_matvec import (
    BandedAffineOperator as JaxBandedOperator,
)

import morfem_tpu_torch as pt
from morfem_tpu_torch.mor import complex_model as tcm
from morfem_tpu_torch.ops import complex_split as tcs
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.ops.block_sparse import BlockSparseAffineOperator
from morfem_tpu_torch.ops.ell import ELLAffineOperator
from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _rec(q, x):
    return np.einsum("nk,ikm->inm", _np(q), _np(x))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _complex_symmetric_system(n=32, m=2, seed=0):
    rng = np.random.default_rng(seed)

    def sym(scale):
        a = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) * scale
        return (a + a.T) / 2

    a0 = sym(1.0 / n) + np.eye(n) * (3.0 + 25.0 + 0.5j)
    a1 = sym(1.0 / n)
    a2 = sym(1.0 / n)
    b = rng.normal(size=(n, m)) + 1j * rng.normal(size=(n, m))
    return a0, a1, a2, b


def _complex_banded_sparse(n=400, half=5, seed=7):
    """Absorbing-Helmholtz-like complex-symmetric banded pencil (the JAX
    package's tests build the same one)."""
    rng = np.random.default_rng(seed)
    offs = list(range(0, half + 1))
    diags = [(8.0 + rng.random(n)) + 1j * 0.4] + [
        (-0.3 + 0.05j) * np.ones(n - d) for d in offs[1:]
    ]
    a0 = sp.diags(diags, offs).tocsr()
    a0 = (a0 + a0.T) * 0.5
    a1 = sp.csr_matrix((n, n))
    a2 = (sp.eye(n) * -1.0).tocsr()
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return a0, a1, a2, b


def _dense(a):
    return a.toarray() if sp.issparse(a) else np.asarray(a)


def _oracle(a0, a1, a2, b, coeffs, t):
    """np.linalg.solve of (Σ c_p(t)·A_p)·x = c_b(t)·b, coeffs as numpy
    callables."""
    c0, c1, c2, cb = (f(t) for f in coeffs)
    a = c0 * _dense(a0) + c1 * _dense(a1) + c2 * _dense(a2)
    return np.linalg.solve(a, cb * np.asarray(b))


WAVE = (lambda t: 1.0, lambda t: t, lambda t: t * t, lambda t: t)


# -- the embeddings and the split solve -------------------------------------

def test_embedding_identities_match_the_reference():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 5)) + 1j * rng.normal(size=(5, 5))
    x = rng.normal(size=(5, 3)) + 1j * rng.normal(size=(5, 3))
    k = tcs.real_embedding(torch.from_numpy(a.real), torch.from_numpy(a.imag))
    np.testing.assert_array_equal(
        _np(k), np.asarray(jcs.real_embedding(a.real, a.imag)))
    xe = tcs.embed_rhs(torch.from_numpy(x.real), torch.from_numpy(x.imag))
    yr, yi = tcs.split_solution(k @ xe)
    np.testing.assert_allclose(_np(yr) + 1j * _np(yi), a @ x, rtol=1e-12)
    # interleaved: entry-wise 2×2 rotation blocks, the same sparse matrix
    # as the reference's; E·[Re x; Im x] interleaved = A·x interleaved
    s = sp.random(40, 40, density=0.1, random_state=3, format="csr")
    s = (s + 1j * sp.random(40, 40, density=0.1, random_state=4)).tocsr()
    e_t = tcs.embed_sparse_interleaved(s)
    e_j = jcs.embed_sparse_interleaved(s)
    assert abs(e_t - e_j).max() == 0.0
    xs = rng.normal(size=(40, 2)) + 1j * rng.normal(size=(40, 2))
    xi = tcs.embed_rhs_interleaved(xs)
    np.testing.assert_array_equal(xi, jcs.embed_rhs_interleaved(xs))
    np.testing.assert_allclose(tcs.deinterleave(e_t @ xi), s @ xs,
                               rtol=1e-12)
    np.testing.assert_array_equal(
        _np(tcs.deinterleave(torch.from_numpy(xi))), xs)
    # a real matrix embeds as Re ⊗ I₂ (no rotation term), a tensor too
    r = sp.random(10, 10, density=0.3, random_state=5, format="csr")
    assert (tcs.embed_sparse_interleaved(r) != sp.kron(r, sp.eye(2))).nnz == 0
    np.testing.assert_array_equal(
        tcs.embed_sparse_interleaved(torch.from_numpy(a)).toarray(),
        jcs.embed_sparse_interleaved(a).toarray())


@pytest.mark.parametrize("factor", ["float32", "float64"])
def test_solve_complex_split_matches_numpy_and_the_reference(factor):
    a0, _, _, b = _complex_symmetric_system(n=48, seed=3)
    cfg_t = pt.MorfemConfig(factor_dtype_name=factor, refine_iterations=8)
    cfg_j = mt.MorfemConfig(factor_dtype_name=factor, refine_iterations=8)
    x_re, x_im = pt.solve_complex_split(
        *(torch.from_numpy(np.ascontiguousarray(v))
          for v in (a0.real, a0.imag, b.real, b.imag)), cfg_t)
    x = _np(x_re) + 1j * _np(x_im)
    ref = np.linalg.solve(a0, b)
    # the f32-factored embedding refines far past complex64 accuracy
    assert np.linalg.norm(a0 @ x - b) / np.linalg.norm(b) < 1e-12
    xj = jcs.solve_complex(a0, b, cfg_j)
    assert _rel(x, np.asarray(xj)) < 1e-12
    xc = pt.solve_complex(sp.csr_matrix(a0), b, cfg_t, device=CPU)
    assert xc.is_complex() and _rel(_np(xc), ref) < 1e-12


def test_embed_affine_system_matches_the_reference():
    a0, a1, a2, b = _complex_symmetric_system(n=8)
    domain = np.linspace(3, 5, 4)
    cfg = pt.MorfemConfig(symmetrize=False)
    sys_t = pt.embed_affine_system(domain, a0, a1, a2, b, config=cfg,
                                   device=CPU)
    sys_j = mt.embed_affine_system(domain, a0, a1, a2, b,
                                   config=mt.MorfemConfig(symmetrize=False))
    for name in ("a0", "a1", "a2", "b", "domain"):
        np.testing.assert_array_equal(_np(getattr(sys_t, name)),
                                      np.asarray(getattr(sys_j, name)))
    with pytest.raises(ValueError, match="symmetrize"):
        pt.embed_affine_system(domain, a0, a1, a2, b,
                               config=pt.MorfemConfig(symmetrize=True),
                               device=CPU)
    # complex dtype with zero imaginary part: symmetrize stays allowed
    r = np.random.default_rng(4).normal(size=(8, 8)) + 0j
    sys_r = pt.embed_affine_system(domain, r, r, r, b.real + 0j,
                                   config=pt.MorfemConfig(), device=CPU)
    assert tuple(sys_r.a0.shape) == (16, 16)


def test_coefficient_tables_and_grid_lookup_match_the_reference():
    domain = np.linspace(0.8, 2.0, 11)
    pairs = [
        (lambda t: t * torch.exp(1j * 0.7 * t),
         lambda t: t * jnp.exp(1j * 0.7 * t)),
        (lambda t: t ** 2, lambda t: t ** 2),
        (lambda t: 2.5, lambda t: 2.5),  # a constant broadcasts
    ]
    for fn_t, fn_j in pairs:
        tab = tcs.eval_coefficient_table(domain, fn_t)
        tab_j = jcs.eval_coefficient_table(domain, fn_j)
        assert tab.shape == (11,) and tab.is_complex() == np.iscomplexobj(
            tab_j)
        np.testing.assert_allclose(_np(tab), tab_j, rtol=1e-15)
        look = tcs.grid_lookup_coefficient(domain, tab)
        look_j = jcs.grid_lookup_coefficient(domain, tab_j)
        # exact on the grid, a scalar point too
        np.testing.assert_array_equal(_np(look(torch.from_numpy(domain))),
                                      _np(tab))
        assert complex(look(torch.tensor(domain[3]))) == complex(tab[3])
        # off the grid: the right neighbour, as the reference's lookup
        off = np.array([0.7, 0.85, 1.999, 2.5])
        np.testing.assert_array_equal(_np(look(torch.from_numpy(off))),
                                      np.asarray(look_j(jnp.asarray(off))))


# -- the dense complex route (native complex128) ----------------------------

def _dense_cases():
    rng = np.random.default_rng(9)
    n = 96
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a0c = (g + g.T) * 0.5 + (6.0 + 1.5j) * np.eye(n)
    gr = rng.standard_normal((n, n))
    a0r = (gr + gr.T) * 0.5 + 6.0 * np.eye(n)
    a1 = np.zeros((n, n))
    a2 = -np.eye(n)
    bc = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    br = rng.standard_normal((n, 2))
    return {
        "complex_operators": ((a0c, a1, a2 + 0j, bc), {}, {}),
        "complex_b": ((a0r, a1, a2, bc), {}, {}),
        "complex_t_a0": (
            (a0r, a1, a2, br),
            dict(t_a0=lambda t: torch.exp(1j * 0.2 * t)),
            dict(t_a0=lambda t: jnp.exp(1j * 0.2 * t))),
    }


@pytest.mark.parametrize("case", ["complex_operators", "complex_b",
                                  "complex_t_a0"])
def test_dense_complex_morfem_matches_the_reference(case):
    (a0, a1, a2, b), ft, fj = _dense_cases()[case]
    domain = np.linspace(0.8, 1.6, 16)
    kw = dict(symmetrize=False, error_threshold=1e-18,
              max_greedy_iterations=20)
    x, q, r0, r1, r2, b_r = pt.morfem(domain, a0, a1, a2, b,
                                      config=pt.MorfemConfig(**kw),
                                      device=CPU, **ft)
    assert all(v.is_complex() for v in (x, q, r0, b_r))
    rec = _rec(q, x)
    c0 = (lambda t: np.exp(1j * 0.2 * t)) if ft else WAVE[0]
    coeffs = (c0,) + WAVE[1:]
    for i in (0, 6, 15):
        ref = _oracle(a0, a1, a2, b, coeffs, domain[i])
        assert _rel(rec[i], ref) < 1e-9, (i, _rel(rec[i], ref))
    if case == "complex_b":
        return  # the reference drops b's imaginary part: see below
    # both packages run the same native complex pipeline
    xj, qj, *_ = mt.morfem(domain, a0, a1, a2, b,
                           config=mt.MorfemConfig(**kw), **fj)
    assert _rel(rec, _rec(qj, xj)) < 1e-9


@pytest.mark.xfail(strict=True, reason=(
    "reference defect: with real operators and a complex b, morfem_tpu's "
    "dense greedy works in the operators' real dtype and casts the "
    "complex snapshots to it, dropping their imaginary parts"))
def test_dense_complex_b_reference_route():
    (a0, a1, a2, b), _, _ = _dense_cases()["complex_b"]
    domain = np.linspace(0.8, 1.6, 16)
    kw = dict(symmetrize=False, error_threshold=1e-18,
              max_greedy_iterations=20)
    xj, qj, *_ = mt.morfem(domain, a0, a1, a2, b,
                           config=mt.MorfemConfig(**kw))
    ref = _oracle(a0, a1, a2, b, WAVE, domain[6])
    assert _rel(_rec(qj, xj)[6], ref) < 1e-9


def test_dense_complex_route_skips_the_panel_lu_and_k4():
    """A complex system never reaches the real-only kernels: solve_sweep
    takes torch.linalg LU (no panel LU, even when asked for "auto"), and
    the K4 reduced sweep hands complex models to the batched LU."""
    (a0, a1, a2, b), _, _ = _dense_cases()["complex_operators"]
    domain = np.linspace(0.8, 1.6, 8)
    from morfem_tpu_torch.ops.solve import use_panel_factorization

    sys_t = pt.AffineSystem.create(domain, a0, a1, a2, b, device=CPU)
    assert sys_t.dtype == sys_t.b.dtype == torch.complex128
    assert not use_panel_factorization(sys_t.b.dtype, pt.MorfemConfig(),
                                       "cuda")
    x = pt.solve_sweep(sys_t, pt.MorfemConfig(symmetrize=False))
    for i in (0, 7):
        ref = _oracle(a0, a1, a2, b, WAVE, domain[i])
        assert _rel(_np(x[i]), ref) < 1e-12
    # real operators, complex coefficient: `create` casts the system to
    # complex128 all the same, operators and b alike
    sys_r = pt.AffineSystem.create(domain, a0.real, a1, a2.real, b.real,
                                   t_b=lambda t: t * torch.exp(1j * t),
                                   device=CPU)
    assert all(x.dtype == torch.complex128
               for x in (*sys_r.operators(), sys_r.b))


def test_complex_reduced_sweep_takes_the_batched_lu():
    """`use_pallas_reduced_sweep` on a complex model gives the batched-LU
    result (K4 is real f32: a complex model must not reach it), and no
    kernel is launched for it."""
    (a0, a1, a2, b), _, _ = _dense_cases()["complex_operators"]
    domain = np.linspace(0.8, 1.6, 16)
    kw = dict(symmetrize=False, error_threshold=1e-14, sweep_method="lu")
    x_lu, q, *_ = pt.morfem(domain, a0, a1, a2, b,
                            config=pt.MorfemConfig(**kw), device=CPU)
    reset_launch_counts()
    x_k4, q_k4, *_ = pt.morfem(
        domain, a0, a1, a2, b, device=CPU,
        config=pt.MorfemConfig(use_pallas_reduced_sweep=True, **kw))
    assert launch_counts()["gauss_jordan_sweep_solve"] == 0
    assert torch.equal(q, q_k4) and torch.equal(x_lu, x_k4)
    for i in (0, 8, 15):
        ref = _oracle(a0, a1, a2, b, WAVE, domain[i])
        assert _rel(_rec(q_k4, x_k4)[i], ref) < 1e-9


@pytest.mark.xfail(strict=True, reason=(
    "reference defect: morfem_tpu's pallas_reduced_sweep hands a complex "
    "reduced model to its real f32 kernel and drops the imaginary part"))
def test_complex_reduced_sweep_reference_pallas_route():
    (a0, a1, a2, b), _, _ = _dense_cases()["complex_operators"]
    domain = np.linspace(0.8, 1.6, 16)
    kw = dict(symmetrize=False, error_threshold=1e-14, sweep_method="lu",
              use_pallas_reduced_sweep=True)
    xj, qj, *_ = mt.morfem(domain, a0, a1, a2, b,
                           config=mt.MorfemConfig(**kw))
    ref = _oracle(a0, a1, a2, b, WAVE, domain[8])
    assert _rel(_rec(qj, xj)[8], ref) < 1e-9


def test_small_sparse_complex_operators_take_the_dense_route():
    """SciPy-sparse complex operators at N ≤ dense_cutoff are densified,
    never read through ``np.asarray`` of a sparse matrix (the reference's
    TPU-only embedded-dense route crashes there)."""
    a0, a1, a2, b = _complex_banded_sparse(n=120)
    domain = np.linspace(0.8, 2.0, 12)
    cfg = pt.MorfemConfig(symmetrize=False, error_threshold=1e-18)
    x, q, r0, *_ = pt.morfem(domain, a0, a1, a2, b, config=cfg, device=CPU)
    rec = _rec(q, x)
    for i in (0, 11):
        ref = _oracle(a0, a1, a2, b, WAVE, domain[i])
        assert _rel(rec[i], ref) < 1e-9
    # the projection itself takes sparse complex operators
    rs, b_r = tcm.project_complex(q, (a0, a1, a2), b)
    assert _rel(_np(rs[0]), _np(q).T @ (a0 @ _np(q))) < 1e-13
    assert _rel(_np(rs[0]), _np(r0)) < 1e-12


@pytest.mark.parametrize("route", ["dense", "matfree"])
def test_coefficient_real_at_the_first_point_takes_the_complex_route(route):
    """A coefficient that is real at domain[0] and complex elsewhere makes
    the system complex (the routing reads the whole grid)."""
    a0, a1, a2, b = _complex_banded_sparse(n=200 if route == "dense" else 400)
    a0 = sp.csr_matrix(a0.real)
    b = b.real
    domain = np.linspace(0.8, 2.0, 12)
    t0 = domain[0]
    ft = dict(t_a2=lambda t: t ** 2 * torch.exp(1j * 0.3 * (t - t0)))
    fj = dict(t_a2=lambda t: t ** 2 * jnp.exp(1j * 0.3 * (t - t0)))
    kw = dict(symmetrize=False, error_threshold=1e-18,
              dense_cutoff=256 if route == "dense" else 128)
    x, q, *_ = pt.morfem(domain, a0, a1, a2, b, config=pt.MorfemConfig(**kw),
                         device=CPU, **ft)
    assert x.is_complex() and q.is_complex()
    xj, qj, *_ = mt.morfem(domain, a0, a1, a2, b,
                           config=mt.MorfemConfig(**kw), **fj)
    coeffs = (WAVE[0], WAVE[1],
              lambda t: t * t * np.exp(1j * 0.3 * (t - t0)), WAVE[3])
    rec, rec_j = _rec(q, x), _rec(qj, xj)
    for i in (0, 5, 11):
        ref = _oracle(a0, a1, a2, b, coeffs, domain[i])
        assert _rel(rec[i], ref) < 1e-9, (i, _rel(rec[i], ref))
        assert _rel(rec_j[i], ref) < 1e-9


# -- the matrix-free complex route (interleaved embedding) ------------------

def _matfree_cases():
    """name → (seed, torch callables, jnp callables, numpy coefficients,
    real operators?, config extras, bar, points checked): the reference
    tests' cases, each at the points its test checks."""
    return {
        "complex_operators": (7, {}, {}, WAVE, False,
                              dict(error_threshold=1e-11), 1e-8, (0, 8, 15)),
        "complex_operators_equally": (
            7, {}, {}, WAVE, False,
            dict(use_equally_distributed=True,
                 equally_distributed_reduction_rate=0.5), 1e-7,
            (0, 8, 15)),
        "complex_t_b": (
            7, dict(t_b=lambda t: t * torch.exp(1j * 0.7 * t)),
            dict(t_b=lambda t: t * jnp.exp(1j * 0.7 * t)),
            WAVE[:3] + (lambda t: t * np.exp(1j * 0.7 * t),), False,
            dict(error_threshold=1e-18), 1e-11, (0, 7, 15)),
        "complex_t_a2": (
            7, dict(t_a2=lambda t: t ** 2 * torch.exp(1j * 0.25 * t)),
            dict(t_a2=lambda t: t ** 2 * jnp.exp(1j * 0.25 * t)),
            WAVE[:2] + (lambda t: t * t * np.exp(1j * 0.25 * t), WAVE[3]),
            False, dict(error_threshold=1e-18), 1e-10, (0, 7, 15)),
        "real_operators_complex_t_a0": (
            3, dict(t_a0=lambda t: torch.exp(1j * 0.2 * t)),
            dict(t_a0=lambda t: jnp.exp(1j * 0.2 * t)),
            (lambda t: np.exp(1j * 0.2 * t),) + WAVE[1:], True,
            dict(error_threshold=1e-18), 1e-9, (0, 5, 11)),
        "real_operators_complex_t_a0_equally": (
            3, dict(t_a0=lambda t: torch.exp(1j * 0.2 * t)),
            dict(t_a0=lambda t: jnp.exp(1j * 0.2 * t)),
            (lambda t: np.exp(1j * 0.2 * t),) + WAVE[1:], True,
            dict(use_equally_distributed=True,
                 equally_distributed_reduction_rate=0.5), 1e-6, (0, 5, 11)),
        "fully_complex": (
            11,
            dict(t_a0=lambda t: torch.exp(1j * 0.1 * t),
                 t_a1=lambda t: (0.02 + 0.01j) * t,
                 t_a2=lambda t: t ** 2 * torch.exp(1j * 0.3 * t),
                 t_b=lambda t: t * torch.exp(1j * 0.7 * t)),
            dict(t_a0=lambda t: jnp.exp(1j * 0.1 * t),
                 t_a1=lambda t: (0.02 + 0.01j) * t,
                 t_a2=lambda t: t ** 2 * jnp.exp(1j * 0.3 * t),
                 t_b=lambda t: t * jnp.exp(1j * 0.7 * t)),
            (lambda t: np.exp(1j * 0.1 * t), lambda t: (0.02 + 0.01j) * t,
             lambda t: t * t * np.exp(1j * 0.3 * t),
             lambda t: t * np.exp(1j * 0.7 * t)),
            False, dict(error_threshold=1e-18), 1e-9, tuple(range(12))),
    }


@pytest.mark.parametrize("case", list(_matfree_cases()))
def test_matfree_complex_morfem_matches_the_reference(case):
    seed, ft, fj, coeffs, real_ops, extra, bar, points = \
        _matfree_cases()[case]
    n = 400
    a0, a1, a2, b = _complex_banded_sparse(n=n, seed=seed)
    if real_ops:
        rng = np.random.default_rng(3)
        main, off = 8.0 + rng.random(n), -0.4 * np.ones(n - 1)
        a0 = sp.diags([off, main, off], [-1, 0, 1]).tocsr()
        b = rng.standard_normal((n, 2))
    domain = np.linspace(0.8, 2.0, 12 if real_ops or len(points) == 12
                         else 16)
    kw = dict(symmetrize=False, dense_cutoff=128, **extra)
    x, q, r0, r1, r2, b_r = pt.morfem(domain, a0, a1, a2, b,
                                      config=pt.MorfemConfig(**kw),
                                      device=CPU, **ft)
    assert all(v.is_complex() for v in (x, q, r0, r1, r2, b_r))
    assert q.shape[0] == n
    xj, qj, *_ = mt.morfem(domain, a0, a1, a2, b,
                           config=mt.MorfemConfig(**kw), **fj)
    rec, rec_j = _rec(q, x), _rec(qj, xj)
    for i in points:
        ref = _oracle(a0, a1, a2, b, coeffs, domain[i])
        assert _rel(rec[i], ref) < bar, (i, _rel(rec[i], ref))
        assert _rel(rec_j[i], ref) < bar
    # the same picks on both sides: the same reduced size, and the same
    # reduced solutions at every grid point (between snapshot points the
    # MOR error itself is up to ~1e-7 at the coarser thresholds)
    assert q.shape[1] == qj.shape[1]
    assert _rel(rec, rec_j) < 1e-9


def test_matfree_complex_rejects_symmetrize():
    n = 300
    a0 = (sp.eye(n) * (3.0 + 1j)).tocsr()
    a1 = sp.csr_matrix((n, n))
    a2 = (sp.eye(n) * -1.0).tocsr()
    with pytest.raises(ValueError, match="symmetrize"):
        pt.morfem(np.linspace(0.5, 1.0, 4), a0, a1, a2, np.ones((n, 1)),
                  config=pt.MorfemConfig(dense_cutoff=128,
                                         use_equally_distributed=True),
                  device=CPU)


def test_matfree_complex_k4_sweep_on_the_embedded_model(monkeypatch):
    """The complex matrix-free route builds the embedded real model and
    never sweeps it (the reference sweeps it and discards the result), so
    K4's flag leaves the returned complex model unchanged."""
    from morfem_tpu_torch.mor import api

    def no_sweep(rm, config):
        raise AssertionError("the embedded real model was swept")

    monkeypatch.setattr(api, "_run_sweep", no_sweep)
    a0, a1, a2, b = _complex_banded_sparse(n=400)
    domain = np.linspace(0.8, 2.0, 16)
    kw = dict(symmetrize=False, dense_cutoff=128, error_threshold=1e-11)
    x, q, *_ = pt.morfem(domain, a0, a1, a2, b, config=pt.MorfemConfig(**kw),
                         device=CPU)
    x4, q4, *_ = pt.morfem(
        domain, a0, a1, a2, b, device=CPU,
        config=pt.MorfemConfig(sweep_method="lu",
                               use_pallas_reduced_sweep=True, **kw))
    assert torch.equal(q, q4) and torch.equal(x, x4)


def test_complex_return_contract_self_consistent():
    """x re-derives from (r0, r1, r2, b_r) alone; q complex-orthonormal;
    r_i = qᵀ·a_i·q of the ORIGINAL operators; b_r = qᵀ·b."""
    n = 400
    a0, a1, a2, b = _complex_banded_sparse(n=n)
    domain = np.linspace(0.8, 2.0, 16)
    cfg = pt.MorfemConfig(symmetrize=False, dense_cutoff=128,
                          error_threshold=1e-18)
    t_b = lambda t: t * torch.exp(1j * 0.7 * t)  # noqa: E731
    x, q, r0, r1, r2, b_r = pt.morfem(domain, a0, a1, a2, b, t_b=t_b,
                                      config=cfg, device=CPU)
    qn = _np(q)
    assert np.linalg.norm(qn.conj().T @ qn - np.eye(qn.shape[1])) < 1e-12
    assert np.linalg.norm(_np(r0) - qn.T @ (a0 @ qn)) \
        < 1e-10 * np.linalg.norm(_np(r0))
    assert np.linalg.norm(_np(b_r) - qn.T @ b) < 1e-12 * np.linalg.norm(
        _np(b_r))
    x_re = pt.sweep_complex_reduced(
        r0, r1, r2, b_r, domain, lambda t: torch.ones_like(t),
        lambda t: t, lambda t: t ** 2, t_b, device=CPU)
    assert np.linalg.norm(_np(x_re - x)) < 1e-12 * np.linalg.norm(_np(x))
    # the reference's re-sweep of the same model agrees
    x_j = jcm.sweep_complex_reduced(
        _np(r0), _np(r1), _np(r2), _np(b_r), domain,
        lambda t: jnp.ones_like(t), lambda t: t, lambda t: t ** 2,
        lambda t: t * jnp.exp(1j * 0.7 * t))
    assert np.linalg.norm(_np(x) - x_j) < 1e-12 * np.linalg.norm(x_j)


def test_sweep_complex_reduced_takes_a_1d_b_r():
    """A 1-D b_r is one right-hand side (the reference mis-broadcasts it)."""
    rng = np.random.default_rng(2)
    k = 6
    r0, r1, r2 = (rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
                  + 5 * np.eye(k) * (p == 0) for p in range(3))
    b_r = rng.normal(size=k) + 1j * rng.normal(size=k)
    grid = np.linspace(0.5, 1.5, 7)
    fns = (lambda t: torch.ones_like(t), lambda t: t, lambda t: t ** 2,
           lambda t: t * torch.exp(1j * t))
    x1 = pt.sweep_complex_reduced(r0, r1, r2, b_r, grid, *fns, device=CPU)
    x2 = pt.sweep_complex_reduced(r0, r1, r2, b_r[:, None], grid, *fns,
                                  device=CPU)
    assert tuple(x1.shape) == (7, k, 1)
    assert torch.equal(x1, x2)
    t = grid[3]
    ref = np.linalg.solve(r0 + t * r1 + t * t * r2, t * np.exp(1j * t) * b_r)
    np.testing.assert_allclose(_np(x1[3, :, 0]), ref, rtol=1e-12)


def test_compress_complex_basis_matches_the_reference():
    """v and i·v span one complex line: compression keeps the complex
    rank, orthonormal, span preserved; a complex64 basis (whose
    redundancy sits at ~1e-7, above the reference's fixed 1e-13) is
    compressed too, with a tolerance from its dtype."""
    rng = np.random.default_rng(3)
    n = 40
    v1 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v2 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    q = np.stack([v1, 1j * v1, v2, (0.3 - 0.8j) * v2 + 2 * v1], axis=1)
    q_hat = _np(tcm.compress_complex_basis(torch.from_numpy(q)))
    assert q_hat.shape == (n, 2) == jcm.compress_complex_basis(q).shape
    assert np.linalg.norm(q_hat.conj().T @ q_hat - np.eye(2)) < 1e-13
    proj = q_hat @ (q_hat.conj().T @ q)
    assert np.linalg.norm(proj - q) < 1e-12 * np.linalg.norm(q)
    q32 = torch.from_numpy(q.astype(np.complex64))
    assert tcm.compress_complex_basis(q32).shape == (n, 2)


def test_krylov_greedy_on_the_interleaved_embedding():
    """greedy_basis_matfree(method="bicgstab") on the banded embedding of
    a complex pencil (half-bandwidth 5 → 11, bw 23: K5's plain version
    here) against the reference's, then finished into the complex model
    and held against SciPy's complex spsolve."""
    n = 400
    a0, a1, a2, b = _complex_banded_sparse(n=n, half=5)
    domain = np.linspace(0.8, 2.0, 16)
    emb = [tcs.embed_sparse_interleaved(m) for m in (a0, a1, a2)]
    be = tcs.embed_rhs_interleaved(b)
    kw = dict(symmetrize=False, error_threshold=1e-9)
    op = BandedAffineOperator(*emb, symmetrize=False, device=CPU)
    assert (op.half, op.bw) == (11, 23)
    reset_launch_counts()
    res, rm = pt.greedy_basis_matfree(op, torch.from_numpy(be), domain,
                                      config=pt.MorfemConfig(**kw),
                                      method="bicgstab")
    assert sum(launch_counts().values()) == 0  # CPU: plain versions
    res_j, rm_j = mt.greedy_basis_matfree(
        JaxBandedOperator(*emb, symmetrize=False), jnp.asarray(be),
        jnp.asarray(domain), config=mt.MorfemConfig(**kw),
        method="bicgstab")
    assert res.converged and bool(res_j.converged)
    assert res.ncols == int(res_j.ncols)
    assert res.iterations == int(res_j.iterations)
    fns = (lambda t: torch.ones_like(t), lambda t: t, lambda t: t ** 2,
           lambda t: t)
    x, q, *_ = tcm.finish_complex_model(tcs.deinterleave(rm.q), a0, a1, a2,
                                        b, domain, *fns)
    xj, qj, *_ = jcm.finish_complex_model(
        jcs.deinterleave(np.asarray(rm_j.q)), a0, a1, a2, b, domain,
        lambda t: jnp.ones_like(t), lambda t: t, lambda t: t ** 2,
        lambda t: t)
    rec, rec_j = _rec(q, x), _rec(qj, xj)
    for i in (0, 8, 15):
        t = domain[i]
        ref = sp.linalg.spsolve((a0 - t * t * sp.eye(n)).tocsc(), t * b)
        assert _rel(rec[i], ref) < 1e-6
    assert _rel(rec, rec_j) < 1e-9


@pytest.mark.parametrize("operator", [BandedAffineOperator,
                                      BlockSparseAffineOperator,
                                      ELLAffineOperator])
def test_operators_advise_the_embedding_for_complex_input(operator):
    a = (sp.eye(40) * (2.0 + 1j)).tocsr()
    with pytest.raises(ValueError, match="embed_sparse_interleaved"):
        operator(a, a, a, symmetrize=False, device=CPU)
    e = tcs.embed_sparse_interleaved(a)
    assert operator(e, e, e, symmetrize=False, device=CPU).n == 80
