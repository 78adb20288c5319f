"""The port's reference-name layer, synthetic generators, accurate
products, any-dtype BSR product, waveguide helpers and example scripts,
against the JAX package where it has a counterpart (CPU; tolerances stated
per test).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import morfem_tpu.compat as jcompat
from morfem_tpu.apps import waveguide as jwg
from morfem_tpu.ops import block_sparse as jbs

import morfem_tpu_torch.compat as tcompat
from morfem_tpu_torch.apps import waveguide as twg
from morfem_tpu_torch.ops import block_sparse as tbs
from morfem_tpu_torch.ops import precision
from morfem_tpu_torch.utils import synthetic

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pencil(n=60, m=2, pts=30, seed=3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = (q * np.linspace(1.0, 400.0, n)) @ q.T
    k = (k + k.T) / 2
    m_mat = -(np.eye(n) + 0.05 * np.diag(rng.uniform(size=n)))
    b = rng.standard_normal((n, m))
    return np.linspace(2.1, 9.7, pts), k, np.zeros((n, n)), m_mat, b


# -- the reference-name layer -------------------------------------------------

def test_compat_morfem_returns_numpy_like_the_jax_layer():
    arrays = _pencil()
    out_t = tcompat.morfem(*arrays, device=CPU)
    out_j = jcompat.morfem(*arrays)
    assert all(isinstance(o, np.ndarray) for o in out_t)
    assert [o.shape for o in out_t] == [o.shape for o in out_j]
    rec_t = np.einsum("nk,ikm->inm", out_t[1], out_t[0])
    rec_j = np.einsum("nk,ikm->inm", out_j[1], out_j[0])
    assert np.linalg.norm(rec_t - rec_j) <= 1e-10 * np.linalg.norm(rec_j)


def test_model_definition_and_full_order_solve():
    arrays = _pencil(n=40, pts=7)
    md_t = tcompat.ModelDefinition(*arrays, device=CPU)
    md_j = jcompat.ModelDefinition(*arrays)
    x_t = tcompat.solve_finite_element_method(md_t)
    x_j = np.asarray(jcompat.solve_finite_element_method(md_j))
    assert isinstance(x_t, np.ndarray) and x_t.shape == (7, 40, 2)
    assert np.abs(x_t - x_j).max() <= 1e-12 * np.abs(x_j).max()
    # a complex system keeps its dtype (the reference's cube is real f64)
    dom, k, c, m_mat, b = arrays
    md_c = tcompat.ModelDefinition(dom, k + 0.1j * np.eye(40), c, m_mat, b,
                                   device=CPU)
    assert np.iscomplexobj(tcompat.solve_finite_element_method(md_c))


def test_time_statistics_keeps_per_instance_state(capsys):
    a, b = tcompat.TimeStatistics(), tcompat.TimeStatistics()
    a.start_clock()
    a.add_time("solve")
    a.add_custom_time("solve", a.clock)
    assert "solve" in a.times and "solve" not in b.times
    assert a.times is not b.times
    a.times["Whole"] = 2.0
    a.times["solve"] = 1.0
    a.print_statistics()
    out = capsys.readouterr().out
    assert "Whole: 2.0 s | 100.0%" in out and "solve: 1.0 s | 50.0%" in out
    assert list(a.times) == list(jcompat.TimeStatistics().times) + ["solve"]


# -- accurate products --------------------------------------------------------

def test_precise_products_equal_the_f64_product():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 3000))
    bs = [rng.standard_normal((3000, w)) for w in (1, 5)]
    ta, tb = torch.from_numpy(a), [torch.from_numpy(b) for b in bs]
    ref = a @ bs[1]
    for fn in (precision.precise_matmul, precision.precise_matmul_chunked):
        got = fn(ta, tb[1]).numpy()
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(a).max() * 3000
        assert np.linalg.norm(got - ref) <= 1e-14 * np.linalg.norm(ref)
    for impl in ("auto", "chunked"):
        outs = precision.precise_matmul_many(ta, tb, impl=impl)
        for o, b in zip(outs, bs):
            assert np.linalg.norm(o.numpy() - a @ b) <= 1e-14 * np.linalg.norm(
                a @ b)
    g = precision.precise_gram(torch.from_numpy(bs[1]), tb[0]).numpy()
    assert np.linalg.norm(g - bs[1].T @ bs[0]) <= 1e-14 * np.linalg.norm(g)
    v = precision.precise_matmul(ta, tb[0][:, 0]).numpy()
    assert v.shape == (40,)


def test_matmul_f32_accurate_is_an_fp32_product():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 32)).astype(np.float32)
    got = precision.matmul_f32_accurate(torch.from_numpy(a),
                                        torch.from_numpy(b))
    assert got.dtype == torch.float32
    ref = a.astype(np.float64) @ b.astype(np.float64)
    bound = 256 * np.finfo(np.float32).eps * (np.abs(a) @ np.abs(b))
    assert (np.abs(got.numpy() - ref) <= bound).all()


# -- synthetic generators -----------------------------------------------------

def test_diagonal_heavy_matrix_properties():
    a = synthetic.diagonal_heavy_matrix(0, 80, device=CPU)
    assert a.shape == (80, 80) and a.dtype == torch.float64
    assert torch.equal(a, synthetic.diagonal_heavy_matrix(0, 80, device=CPU))
    assert not torch.equal(a, synthetic.diagonal_heavy_matrix(1, 80,
                                                              device=CPU))
    assert bool((a.diagonal() != 0).all()) and float(a.abs().max()) <= 10.0
    # populated diagonals and magnitudes decay away from the main one
    an = a.numpy()
    near = np.mean([np.abs(np.diag(an, d)).mean() for d in range(1, 10)])
    far = np.mean([np.abs(np.diag(an, d)).mean() for d in range(60, 79)])
    assert far < 0.1 * near
    # one keep/drop draw per diagonal offset
    for d in range(1, 80):
        diag = np.diag(an, d)
        assert (diag != 0).all() or (diag == 0).all()
    assert torch.count_nonzero(synthetic.diagonal_heavy_matrix(
        2, 30, density=0.0, device=CPU)) == 30
    g = torch.Generator().manual_seed(0)
    assert torch.equal(a, synthetic.diagonal_heavy_matrix(g, 80, device=CPU))


def test_random_affine_system_properties():
    domain, a0, a1, a2, b = synthetic.random_affine_system(
        3, n=48, m=3, num_points=9, device=CPU)
    assert tuple(domain.shape) == (9,) and tuple(b.shape) == (48, 3)
    assert float(domain[0]) == 3.0 and float(domain[-1]) == 5.0
    for a in (a0, a1, a2):
        assert torch.equal(a, a.T)
    for t in domain:
        a = a0 + t * a1 + t**2 * a2
        assert float(torch.linalg.eigvalsh(a).abs().min()) > 1.0
    _, u0, *_ = synthetic.random_affine_system(3, n=48, symmetric=False,
                                               device=CPU)
    assert not torch.equal(u0, u0.T)


def test_waveguide_like_system_properties():
    from scipy.constants import c as c_light

    n, n_inband = 150, 7
    domain, c_mat, gamma, b = synthetic.waveguide_like_system(
        5, n=n, num_points=40, n_inband=n_inband, device=CPU)
    assert tuple(c_mat.shape) == (n, n) and tuple(b.shape) == (n, 2)
    assert torch.equal(c_mat, c_mat.T) and torch.equal(gamma, gamma.T)
    t_mat = (gamma / -((2 * np.pi / c_light) ** 2)).numpy()
    assert np.linalg.eigvalsh(t_mat).min() > 0  # T (mass-like) SPD
    assert np.linalg.eigvalsh(c_mat.numpy()).min() > 0  # C SPD
    lam = np.sort(np.linalg.eigvals(np.linalg.solve(t_mat, c_mat.numpy()))
                  .real)
    k2 = (2 * np.pi * domain.numpy() / c_light) ** 2
    inside = (lam > k2[0]) & (lam < k2[-1])
    assert inside.sum() == n_inband
    # no resonance within a third of a grid spacing of a sample point
    gap = np.abs(lam[inside][:, None] - k2[None, :]).min()
    assert gap > np.min(np.diff(k2)) / 3 * 0.99
    assert ((b.numpy() != 0).sum(axis=0) == max(4, n // 64)).all()


# -- any-dtype BSR product, waveguide helpers --------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_bsr_matmul_matches_the_jax_package(dtype):
    """Real blocks times x of any dtype, computed in x's dtype."""
    import jax.numpy as jnp

    n = 300
    rng = np.random.default_rng(4)
    a = sp.random(n, n, density=0.02, random_state=5, format="csr")
    a = a + sp.eye(n)
    vals, brows, bcols, nbr, nbc = tbs.bsr_from_scipy([a], n)
    x = rng.standard_normal((n, 3))
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal((n, 3))
    x = x.astype(dtype)
    y = tbs.bsr_matmul(torch.from_numpy(vals[0]), brows, bcols, nbr, nbc, n,
                       torch.from_numpy(x)).numpy()
    assert y.dtype == dtype
    yj = np.asarray(jbs.bsr_matmul(jnp.asarray(vals[0]), brows, bcols,
                                   nbr, nbc, n, jnp.asarray(x)))
    tol = 1e-5 if dtype == np.float32 else 1e-13
    ref = a @ x
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()
    assert np.abs(y - yj).max() <= tol * np.abs(ref).max()
    v = tbs.bsr_matmul(torch.from_numpy(vals[0]), brows, bcols, nbr, nbc, n,
                       torch.from_numpy(x[:, 0]))
    assert tuple(v.shape) == (n,)


def test_synthesize_ct_tt_and_equally_distributed_points():
    for x, y in zip(twg.synthesize_ct_tt(50, seed=3),
                    jwg.synthesize_ct_tt(50, seed=3)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(twg.synthesize_waveguide(50), jwg.synthesize_waveguide(50)):
        np.testing.assert_array_equal(x, y)
    grid = np.linspace(3e9, 5e9, 11)
    np.testing.assert_array_equal(
        twg.equally_distributed_points(grid, 4, device=CPU).numpy(),
        np.asarray(jwg.equally_distributed_points(grid, 4)))
    with pytest.raises(ValueError, match="greater"):
        twg.equally_distributed_points(grid, 12, device=CPU)


# -- example scripts ---------------------------------------------------------

def test_serve_example_builds_saves_loads_and_answers(tmp_path, capsys):
    from morfem_tpu_torch.examples import serve

    ckpt = str(tmp_path / "wg.npz")
    serve.main(["--cpu", "--n", "150", "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert "built Nr=" in out and out.count("S21 peak at") == 4
    serve.main(["--cpu", "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert "offline phase" not in out and "Done" in out


def test_complex_serve_example(tmp_path, capsys):
    from morfem_tpu_torch.examples import complex_serve

    complex_serve.main(["--cpu", "--n", "300", "--checkpoint",
                        str(tmp_path / "c.npz")])
    assert "OK" in capsys.readouterr().out


def test_waveguide_and_study_examples(capsys):
    from morfem_tpu_torch.examples import basis_size_study, waveguide_sweep

    waveguide_sweep.main(["--cpu", "--n", "120", "--points", "20",
                          "--no-plots"])
    out = capsys.readouterr().out
    err_max = float(out.split("GSM error max:")[1].split()[0])
    assert err_max < 1e-5
    basis_size_study.main(["--cpu", "--n", "120", "--points", "21",
                           "--max-size", "6", "--no-plots"])
    assert capsys.readouterr().out.count("rel_error=") == 4


def test_new_modules_import_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    mods = ["apps.studies", "utils.data_convert", "utils.checkpoint",
            "ops.spectral_solve", "ops.blocked_inverse", "ops.precision",
            "examples.serve", "examples.waveguide_sweep",
            "examples.basis_size_study", "examples.complex_serve",
            "parallel", "parallel.mesh", "parallel.sharded",
            "parallel.tp_solve", "parallel.tp_banded", "parallel.tp_dense",
            "parallel.launch", "examples.multi_geometry",
            "examples.tp_dense_solve", "examples.large_n_sweep",
            "examples.banded_direct_greedy", "examples.general_sparse_mor",
            "examples.random_matrix_experiment"]
    code = (
        "import sys\n"
        + "".join(f"import morfem_tpu_torch.{m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'morfem_tpu' or "
        "m.startswith('morfem_tpu.')]\nprint(bad)\nsys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr
