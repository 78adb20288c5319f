"""The port's slice (morfem_tpu_torch) against the JAX package, on the CPU.

Same inputs, made with numpy from fixed seeds, go through the JAX function
and its counterpart in the port; results are compared by basis-invariant
quantities (Q·x, the GSM, reduced spectra), never raw Q (SVD signs are
free). The JAX package runs with x64 on the CPU (tests/conftest.py).
"""

import dataclasses
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morfem_tpu as mt
from morfem_tpu.apps import waveguide as jwg
from morfem_tpu.mor import spectral as jspec
from morfem_tpu.mor.estimator import residual_norm_exact as jax_residual_exact
from morfem_tpu.ops.assembly import assemble_at as jax_assemble_at
from morfem_tpu.ops.orthonormalize import (
    orthonormalize_svd_masked as jax_orth_masked,
)
from morfem_tpu.ops.solve import solve_point as jax_solve_point

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps import waveguide as twg
from morfem_tpu_torch.compat import reduced_model_from_numpy, system_from_numpy
from morfem_tpu_torch.mor import spectral as tspec
from morfem_tpu_torch.mor.equally import seed_indices
from morfem_tpu_torch.mor.estimator import (
    estimate_errors,
    estimate_errors_direct,
    estimator_blocks,
    operator_images,
    residual_norm_exact,
)
from morfem_tpu_torch.mor.greedy import _reduced_from_u
from morfem_tpu_torch.ops.assembly import assemble_at
from morfem_tpu_torch.ops.orthonormalize import (
    orthonormalize_append_cgs2,
    orthonormalize_svd_masked,
)
from morfem_tpu_torch.ops.solve import solve_point

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes on a shared CPU, and a full thread pool per process
    oversubscribes it (these are small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _pencil(n=60, m=2, pts=30, seed=3, three_term=False):
    """A small definite wave-like pencil: A(t) = K + t·C + t²·M."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = (q * np.linspace(1.0, 400.0, n)) @ q.T
    k = (k + k.T) / 2
    c = 0.1 * (rng.standard_normal((n, n)) if three_term else np.zeros((n, n)))
    c = (c + c.T) / 2
    m_mat = -(np.eye(n) + 0.05 * np.diag(rng.uniform(size=n)))
    b = rng.standard_normal((n, m))
    domain = np.linspace(2.1, 9.7, pts)  # off the pencil's eigenvalues
    return domain, k, c, m_mat, b


# -- config, system, assembly, solve ----------------------------------------

def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(mt.MorfemConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(pt.MorfemConfig)}
    assert jf == tf


@pytest.mark.parametrize(
    "bad",
    [dict(panel_trail="x"), dict(panel_width=100), dict(panel_pivot="x"),
     dict(estimator_impl="x"), dict(factorization="x"),
     dict(sweep_method="x"), dict(estimator="x"),
     dict(orthonormalization="x"), dict(factor_dtype_name="float16"),
     dict(equally_distributed_reduction_rate=1.0)],
)
def test_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        mt.MorfemConfig(**bad)
    with pytest.raises(ValueError):
        pt.MorfemConfig(**bad)


@pytest.mark.parametrize(
    "later", [dict(factorization="gj"),
              dict(factorization="gj", use_pallas_reduced_sweep=True)]
)
def test_config_names_later_slices(later):
    """The configurations an earlier slice refused are ported now: both
    packages accept them with the same fields."""
    assert (dataclasses.asdict(pt.MorfemConfig(**later))
            == dataclasses.asdict(mt.MorfemConfig(**later)))


def test_config_accepts_the_fused_reduced_sweep():
    assert pt.MorfemConfig(use_pallas_reduced_sweep=True) \
        .use_pallas_reduced_sweep


def test_entry_points_default_to_cuda():
    domain, k, c, m_mat, b = _pencil()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.AffineSystem.create(domain, k, c, m_mat, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.morfem(domain, k, c, m_mat, b)
    r = np.eye(3, dtype=complex)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.sweep_complex_reduced(r, r, r, np.ones(3), domain,
                                 *(lambda t: t,) * 4)
    from morfem_tpu_torch.apps.studies import upscale_interpolate
    from morfem_tpu_torch.apps.waveguide import equally_distributed_points

    with pytest.raises(RuntimeError, match="CUDA"):
        upscale_interpolate(np.eye(4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        equally_distributed_points(domain, 3)


def test_unported_inputs_name_their_slice():
    import scipy.sparse as sp

    from morfem_tpu_torch.ops.sparse import solve_point_iterative

    domain, k, c, m_mat, b = _pencil()
    # complex input, dense or sparse, is ported (tests/test_torch_complex.py
    # holds it against the reference): both routes return complex models
    cfg = pt.MorfemConfig(dense_cutoff=8, symmetrize=False)
    for a0 in (sp.csc_array(k) * (1 + 1j), k + 0j):
        x, q, *_ = pt.morfem(domain, a0, c, m_mat, b, config=cfg,
                             device=CPU)
        assert x.is_complex() and q.is_complex()
    # nothing is left unported: no entry point raises NotImplementedError
    # (method="spike", the last, is the distributed banded solve now)
    from pathlib import Path

    pkg = Path(pt.__file__).parent
    assert not [p for p in pkg.rglob("*.py")
                if "NotImplementedError" in p.read_text()]
    with pytest.raises(ValueError, match="unknown method"):
        solve_point_iterative(None, None, None, method="no-such-method")


def test_system_and_assembly_match():
    domain, k, c, m_mat, b = _pencil(three_term=True)
    c_ns = c + 0.01 * np.triu(np.ones_like(c))  # not symmetric
    ts = domain[[0, 7, 19]]
    jsys = mt.AffineSystem.create(jnp.asarray(domain), k, c_ns, m_mat, b)
    tsys = system_from_numpy(domain, k, c_ns, m_mat, b, device=CPU)
    assert tsys.symmetric_ops == jsys.symmetric_ops is False
    assert system_from_numpy(domain, k, c, m_mat, b, device=CPU).symmetric_ops
    for sym in (True, False):
        ja, jb = jax_assemble_at(jsys, jnp.asarray(ts), symmetrize=sym)
        ta, tb = assemble_at(tsys, torch.from_numpy(ts), symmetrize=sym)
        # the same f64 scaled adds: equal to the last few ulps
        np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-14,
                                   atol=1e-12)
        np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-14)


@pytest.mark.parametrize("factor", ["float32", "float64"])
def test_solve_point_matches(factor):
    domain, k, c, m_mat, b = _pencil(three_term=True)
    jcfg = mt.MorfemConfig(factor_dtype_name=factor)
    tcfg = pt.MorfemConfig(factor_dtype_name=factor)
    jsys = mt.AffineSystem.create(jnp.asarray(domain), k, c, m_mat, b)
    tsys = system_from_numpy(domain, k, c, m_mat, b, device=CPU)
    t = domain[11]
    xj = np.asarray(jax_solve_point(jsys, jnp.asarray(t), jcfg))
    xt = _np(solve_point(tsys, torch.tensor(t, dtype=torch.float64), tcfg))
    xn = np.linalg.solve(k + t * c + t * t * m_mat, t * b)
    # f32 factor + adaptive f64 refinement reaches working precision
    # (cond ~1e3 here): both agree with NumPy to ~1e-13
    assert np.linalg.norm(xt - xn) / np.linalg.norm(xn) < 1e-11
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xn) < 1e-11


# -- orthonormalization and estimator ----------------------------------------

def test_orthonormalize_masked_spans_the_same_space():
    rng = np.random.default_rng(8)
    q = np.zeros((50, 8))
    q[:, :5] = rng.standard_normal((50, 5))
    uj = np.asarray(jax_orth_masked(jnp.asarray(q), 5))
    ut = _np(orthonormalize_svd_masked(torch.from_numpy(q), 5))
    np.testing.assert_allclose(ut.T @ ut, np.diag([1.0] * 5 + [0.0] * 3),
                               atol=1e-13)
    assert np.all(ut[:, 5:] == 0)
    # basis-invariant: the orthogonal projectors agree
    np.testing.assert_allclose(ut @ ut.T, uj @ uj.T, atol=1e-12)


def test_cgs2_appends_and_skips_dependent_columns():
    rng = np.random.default_rng(9)
    q0 = np.linalg.qr(rng.standard_normal((40, 3)))[0]
    q = torch.zeros((40, 6), dtype=torch.float64)
    q[:, :3] = torch.from_numpy(q0)
    new = np.stack([rng.standard_normal(40), q0[:, 0] * 2.0], axis=1)
    q2, nc = orthonormalize_append_cgs2(q, 3, torch.from_numpy(new))
    assert nc == 4  # the dependent column is skipped
    qa = _np(q2)[:, :4]
    np.testing.assert_allclose(qa.T @ qa, np.eye(4), atol=1e-13)


def test_estimators_agree_with_exact_residual_and_reference():
    domain, k, c, m_mat, b = _pencil(m=1)
    tsys = system_from_numpy(domain, k, c, m_mat, b, device=CPU)
    jsys = mt.AffineSystem.create(jnp.asarray(domain), k, c, m_mat, b)
    rng = np.random.default_rng(4)
    q = np.zeros((k.shape[0], 6))
    q[:, :4] = np.linalg.qr(rng.standard_normal((k.shape[0], 4)))[0]
    tq = torch.from_numpy(q)
    cfg = pt.MorfemConfig(factor_dtype_name="float64")
    u = operator_images(tsys, tq, 4)
    rm = _reduced_from_u(tsys, tq, 4, u)
    err_d, _ = estimate_errors_direct(rm, u, tsys.b, cfg)
    blocks, _ = estimator_blocks(tsys, tq, 4)
    err_g, _ = estimate_errors(rm, blocks, cfg)
    exact = residual_norm_exact(tsys, rm, cfg)
    jrm = mt.project(jsys, jnp.asarray(q), jnp.asarray(4))
    jexact = np.asarray(
        jax_residual_exact(jsys, jrm, mt.MorfemConfig(factor_dtype_name="float64"))
    )
    # M = 1: ‖RᴴR‖_F = ‖R‖²; the direct form cancels at the residual level
    # (~1e-14 relative), the Gram form at the squared-operator level
    np.testing.assert_allclose(_np(err_d), _np(exact) ** 2, rtol=1e-9)
    np.testing.assert_allclose(_np(err_g), _np(exact) ** 2, rtol=1e-6)
    np.testing.assert_allclose(_np(exact), jexact, rtol=1e-10)


def test_seed_indices_truncate_like_the_reference():
    cfg = pt.MorfemConfig(equally_distributed_reduction_rate=0.9)
    from morfem_tpu.mor.equally import seed_indices as jax_seed_indices

    for num in (7, 10, 33, 100):
        np.testing.assert_array_equal(
            seed_indices(num, cfg), jax_seed_indices(num, mt.MorfemConfig(
                equally_distributed_reduction_rate=0.9))
        )


# -- spectral sweeps on a reduced model carried across -----------------------

@pytest.mark.parametrize("three_term", [False, True])
def test_spectral_sweep_on_carried_model(three_term):
    domain, k, c, m_mat, b = _pencil(three_term=three_term)
    jsys = mt.AffineSystem.create(jnp.asarray(domain), k, c, m_mat, b)
    rng = np.random.default_rng(12)
    q = np.zeros((k.shape[0], 10))
    q[:, :8] = np.linalg.qr(rng.standard_normal((k.shape[0], 8)))[0]
    jrm = mt.project(jsys, jnp.asarray(q), jnp.asarray(8))
    d = {f: np.asarray(getattr(jrm, f))
         for f in ("domain", "q", "r0", "r1", "r2", "b_r", "ncols")}
    trm = reduced_model_from_numpy(d, device=CPU)
    cfg_t, cfg_j = pt.MorfemConfig(), mt.MorfemConfig()
    if three_term:
        xj = jspec.spectral_sweep_quadratic(
            jspec.prepare_spectral_quadratic(jrm, cfg_j))
        xt = tspec.spectral_sweep_quadratic(
            tspec.prepare_spectral_quadratic(trm, cfg_t))
    else:
        with pytest.raises(ValueError):
            tspec.prepare_spectral(
                reduced_model_from_numpy(dict(d, r1=d["r2"]), device=CPU),
                cfg_t)
        xj = jspec.spectral_sweep(jspec.prepare_spectral(jrm, cfg_j))
        xt = tspec.spectral_sweep(tspec.prepare_spectral(trm, cfg_t))
    # same reduced model, same host eigensolver: equal to eigensolver
    # accuracy; and equal to the batched-LU sweep of the port
    xl = pt.sweep(trm, cfg_t)
    scale = np.abs(np.asarray(xj)).max()
    assert np.abs(_np(xt) - np.asarray(xj)).max() < 1e-10 * scale
    assert np.abs(_np(xt) - _np(xl)).max() < 1e-9 * scale


# -- greedy, morfem() and the waveguide slice --------------------------------

@pytest.fixture(scope="module")
def waveguide_pair(tmp_path_factory):
    """The port's synthetic waveguide (N=192, into a temporary cache) and
    the JAX package's MOR and full-order GSM on the same data."""
    cache = tmp_path_factory.mktemp("wg")
    data = twg.load_waveguide_data(n_fallback=192, cache_dir=str(cache))
    assert (cache / "synthetic_wg_192.npz").exists()
    freq = np.linspace(3e9, 5e9, 40)
    jdata = jwg.WaveguideData(data.c_mat, data.t_mat, data.wp, data.kte, True)
    jsys = jwg.waveguide_system(freq, jdata)
    jcfg = mt.MorfemConfig(error_threshold=1e-10)
    gsm_j, rm_j, greedy_j = jwg.mor_gsm(jsys, jcfg)
    return data, freq, np.asarray(gsm_j), rm_j, greedy_j


def test_synthesis_matches_the_reference(waveguide_pair):
    data = waveguide_pair[0]
    c_j, t_j, wp_j = jwg.synthesize_waveguide(192, m=2)
    wp_j = jwg.calibrate_port_amplitude(c_j, t_j, wp_j)
    np.testing.assert_array_equal(data.c_mat, c_j)
    np.testing.assert_array_equal(data.t_mat, t_j)
    np.testing.assert_array_equal(data.wp, wp_j)


def test_greedy_matches_the_reference(waveguide_pair):
    data, freq, _, rm_j, greedy_j = waveguide_pair
    tsys = twg.waveguide_system(freq, data, device=CPU)
    res = pt.greedy_basis(tsys, pt.MorfemConfig(error_threshold=1e-10))
    iters = int(greedy_j.iterations)
    assert res.iterations == iters
    assert res.ncols == int(greedy_j.ncols) == rm_j.q.shape[1]
    assert res.converged == bool(greedy_j.converged)
    hist_t = _np(res.err_hist)[:iters]
    hist_j = np.asarray(greedy_j.err_hist)[:iters]
    # the same picks (argmax per estimator evaluation) ...
    np.testing.assert_array_equal(hist_t.argmax(axis=1), hist_j.argmax(axis=1))
    # ... and the same estimates. The snapshots come from different f32
    # factors refined in f64 and agree to ~cond·ε ≈ 1e-9 near the grid's
    # resonances; that moves an estimate (quadratic in the residual) by up
    # to ~1e-8 of the problem's scale, the first estimate's peak, whatever
    # the estimate's own size: measured ≤ 1e-8 of the peak
    peak = hist_j[0].max()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-6, atol=1e-7 * peak)


def test_waveguide_slice_matches_reference_and_full_order(waveguide_pair):
    data, freq, gsm_j, rm_j, _ = waveguide_pair
    tsys = twg.waveguide_system(freq, data, device=CPU)
    cfg = pt.MorfemConfig(error_threshold=1e-10)
    gsm_t, rm_t, greedy_t = twg.mor_gsm(tsys, cfg)
    # the full-order oracle through the panel LU (the card's default path)
    gsm_full = twg.full_order_gsm(
        tsys, cfg.replace(factorization="panel", panel_width=128)
    )
    assert rm_t.ncols < tsys.n // 2
    # the reference's own bar (tests/test_apps.py): 1e-8 against the
    # full-order GSM; against the JAX package's MOR GSM likewise
    assert np.abs(_np(gsm_t) - _np(gsm_full)).max() < 1e-8
    assert np.abs(_np(gsm_t) - gsm_j).max() < 1e-8
    # basis-invariant: the reduced pencil's spectra agree inside the swept
    # band (eigenvalues −f² with f in 3–5 GHz); outside it the basis holds
    # the modes only loosely and their Ritz values are free
    def in_band(rm):
        lam = np.linalg.eigvals(np.linalg.solve(_np(rm.r2), _np(rm.r0)))
        f2 = -lam.real
        return np.sort(f2[(f2 > 3e9**2) & (f2 < 5e9**2)])

    band_t, band_j = in_band(rm_t), in_band(rm_j)
    assert len(band_t) == len(band_j) > 0
    np.testing.assert_allclose(band_t, band_j, rtol=1e-10)


def test_morfem_reconstruction_matches_reference():
    domain, k, c, m_mat, b = _pencil(n=80, seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, qj, *_ = mt.morfem(jnp.asarray(domain), k, c, m_mat, b,
                               config=mt.MorfemConfig(error_threshold=1e-12))
        xt, qt, a0r, a1r, a2r, br = pt.morfem(
            domain, k, c, m_mat, b,
            config=pt.MorfemConfig(error_threshold=1e-12), device=CPU)
    assert xt.shape[1] == qt.shape[1] == a0r.shape[0] == br.shape[0]
    rec_t = np.einsum("nk,ikm->inm", _np(qt), _np(xt))
    rec_j = np.einsum("nk,ikm->inm", np.asarray(qj), np.asarray(xj))
    full = np.stack([np.linalg.solve(k + t * c + t * t * m_mat, t * b)
                     for t in domain])
    scale = np.abs(full).max()
    assert np.abs(rec_t - full).max() < 1e-8 * scale
    assert np.abs(rec_t - rec_j).max() < 1e-8 * scale


def test_equally_distributed_route_matches_reference():
    domain, k, c, m_mat, b = _pencil(n=60, pts=40, seed=6)
    kw = dict(use_equally_distributed=True,
              equally_distributed_reduction_rate=0.6)
    x, q, *_ = pt.morfem(domain, k, c, m_mat, b,
                         config=pt.MorfemConfig(**kw), device=CPU)
    xj, qj, *_ = mt.morfem(jnp.asarray(domain), k, c, m_mat, b,
                           config=mt.MorfemConfig(**kw))
    assert q.shape[1] == 16 * 2  # floor(40·0.4) snapshots of 2 columns
    rec = np.einsum("nk,ikm->inm", _np(q), _np(x))
    rec_j = np.einsum("nk,ikm->inm", np.asarray(qj), np.asarray(xj))
    # the same snapshots span the same space: the reduced solutions agree
    # to the snapshots' accuracy times the reduced solve's conditioning
    # (~1e-9 relative at the grid's near-resonance points), four orders
    # below the MOR error of this coarse basis (~1e-6 relative)
    assert np.abs(rec - rec_j).max() < 1e-8 * np.abs(rec_j).max()


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, morfem_tpu_torch, morfem_tpu_torch.apps.waveguide, "
        "morfem_tpu_torch.compat, morfem_tpu_torch.ops.panel_lu\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'morfem_tpu' or m.startswith('morfem_tpu.')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_root_exports_match_the_reference_less_later_slices():
    """Every name the JAX package exports is exported by the port, in the
    same order (no later slice is left out any more)."""
    assert pt.__all__ == mt.__all__
    for name in pt.__all__ + ["embed_affine_system", "solve_complex",
                              "solve_complex_split", "split_solution"]:
        assert callable(getattr(pt, name)) or name == "DEFAULT_CONFIG"


@pytest.mark.parametrize(
    "variant", [dict(orthonormalization="mgs"), dict(estimator="gram")]
)
def test_greedy_variants_match_reference(variant):
    domain, k, c, m_mat, b = _pencil(n=60, pts=30, seed=7)
    # a threshold well above the Gram form's cancellation floor (~‖A‖²ε),
    # where both packages' stopping decisions are not decided by roundoff
    kw = dict(error_threshold=1e-6, **variant)
    tsys = system_from_numpy(domain, k, c, m_mat, b, device=CPU)
    jsys = mt.AffineSystem.create(jnp.asarray(domain), k, c, m_mat, b)
    res_t = pt.greedy_basis(tsys, pt.MorfemConfig(**kw))
    res_j = mt.greedy_basis(jsys, mt.MorfemConfig(**kw))
    assert res_t.iterations == int(res_j.iterations)
    assert res_t.ncols == int(res_j.ncols)
    assert res_t.converged == bool(res_j.converged)
    iters = res_t.iterations
    hist_t = _np(res_t.err_hist)[:iters]
    hist_j = np.asarray(res_j.err_hist)[:iters]
    # a converged run's last row picks no point: its argmax is roundoff
    # below the threshold, so only the rows that chose a point are compared
    picked = iters - 1 if res_t.converged else iters
    np.testing.assert_array_equal(hist_t[:picked].argmax(axis=1),
                                  hist_j[:picked].argmax(axis=1))
    if res_t.converged:
        assert hist_t[-1].max() < kw["error_threshold"]
        assert hist_j[-1].max() < kw["error_threshold"]
    # basis-invariant: the active bases span the same space
    qt = _np(res_t.q)[:, :res_t.ncols]
    qj = np.asarray(res_j.q)[:, :res_t.ncols]
    np.testing.assert_allclose(qt @ qt.T, qj @ qj.T, atol=1e-8)


def test_gram_helpers_match_reference():
    from morfem_tpu.ops.gram import expand_gram_matrix as jax_expand
    from morfem_tpu_torch.ops.gram import expand_gram_matrix, hermitian

    rng = np.random.default_rng(13)
    mid = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    old_q = rng.standard_normal((30, 4))
    new_q = rng.standard_normal((30, 2))
    orig = old_q.T @ mid @ old_q
    got = _np(expand_gram_matrix(*(torch.from_numpy(x) for x in
                                   (orig, old_q, mid, new_q))))
    full = np.concatenate([old_q, new_q], axis=1)
    np.testing.assert_allclose(got, full.T @ mid @ full, atol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(jax_expand(orig, old_q, mid, new_q)), atol=1e-12)
    np.testing.assert_array_equal(_np(hermitian(torch.from_numpy(mid))),
                                  mid.conj().T)
    with pytest.raises(ValueError):
        hermitian(torch.zeros(3))
