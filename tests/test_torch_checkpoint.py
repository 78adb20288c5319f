"""The port's reduced-model checkpoint against the JAX package's, on the CPU.

A file written by either package loads in the other (the same ``.npz``
keys, ``meta`` and coefficient fingerprint), and the loaded model sweeps
as the saved one did (1e-12 relative). Inputs are made with numpy from
fixed seeds; the JAX package runs with x64 on the CPU.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morfem_tpu as mt
from morfem_tpu.apps import waveguide as jwg

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps import waveguide as twg
from morfem_tpu_torch.compat import system_from_numpy

CPU = "cpu"
CFG_J = mt.MorfemConfig(error_threshold=1e-10)
CFG_T = pt.MorfemConfig(error_threshold=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _waveguide(n=120, pts=24):
    """A small synthetic waveguide: (domain, C, 0, Γ, B) as numpy."""
    data = twg.load_waveguide_data(n_fallback=n)
    domain = np.linspace(3e9, 5e9, pts)
    n = data.c_mat.shape[0]
    return (domain, data.c_mat, np.zeros((n, n)),
            data.t_mat * twg.GAMMA_SCALE, data.wp * twg.B_SCALE), data.kte


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _models():
    """The same waveguide's trimmed reduced model, built by each package."""
    arrays, kte = _waveguide()
    sys_j = mt.AffineSystem.create(
        *arrays, t_b=lambda t: jwg.b_coefficient(t, kte))
    sys_t = system_from_numpy(
        *arrays, t_b=lambda t: twg.b_coefficient(t, kte), device=CPU)
    rm_j = mt.build_reduced_model(sys_j, CFG_J)[0].trim()
    rm_t = pt.build_reduced_model(sys_t, CFG_T)[0].trim()
    return rm_j, rm_t


def test_jax_written_checkpoint_loads_in_the_port(tmp_path):
    rm_j, _ = _models()
    path = tmp_path / "jax_model.npz"
    mt.save_reduced_model(str(path), rm_j, metadata={"n_dof": 120})
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the fingerprint must match
        rm = pt.load_reduced_model(str(path), t_b=twg.b_coefficient,
                                   device=CPU)
    assert rm.ncols == int(rm_j.ncols) and rm.q.dtype == torch.float64
    x_j = mt.sweep(rm_j, CFG_J)
    assert _rel(pt.sweep(rm, CFG_T), x_j) < 1e-12


def test_port_written_checkpoint_loads_in_the_jax_package(tmp_path):
    _, rm_t = _models()
    path = tmp_path / "port_model.npz"
    pt.save_reduced_model(str(path), rm_t)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rm = mt.load_reduced_model(str(path), t_b=jwg.b_coefficient)
    assert int(rm.ncols) == rm_t.ncols
    assert _rel(mt.sweep(rm, CFG_J), pt.sweep(rm_t, CFG_T)) < 1e-12
    # the same keys and format in both packages' files
    mt.save_reduced_model(str(tmp_path / "jax_model"), rm)
    with np.load(path) as zt, np.load(tmp_path / "jax_model.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert str(zt["meta"]) == str(zj["meta"])
        np.testing.assert_allclose(zt["coeff_fingerprint"],
                                   zj["coeff_fingerprint"], rtol=1e-15)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wrong_t_b_warns_in_both_packages(tmp_path, writer):
    """The default t_b (= t) in place of the waveguide's port coefficient
    is the silent-wrong-sweep case the fingerprint exists for."""
    rm_j, rm_t = _models()
    path = str(tmp_path / "model.npz")
    if writer == "jax":
        mt.save_reduced_model(path, rm_j)
    else:
        pt.save_reduced_model(path, rm_t)
    with pytest.warns(UserWarning, match="t_b"):
        mt.load_reduced_model(path)
    with pytest.warns(UserWarning, match="t_b"):
        pt.load_reduced_model(path, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt.load_reduced_model(path, device=CPU, check_coefficients=False)


def test_path_without_suffix_round_trips(tmp_path):
    _, rm_t = _models()
    base = str(tmp_path / "sub" / "model")
    pt.save_reduced_model(base, rm_t)
    rm = pt.load_reduced_model(base, t_b=rm_t.t_b, device=CPU)
    for name in ("domain", "q", "r0", "r1", "r2", "b_r"):
        assert torch.equal(getattr(rm, name), getattr(rm_t, name))
    assert rm.ncols == rm_t.ncols


def test_complex_model_round_trips(tmp_path):
    rng = np.random.default_rng(5)
    k = 6
    r = [torch.from_numpy(rng.standard_normal((k, k))
                          + 1j * rng.standard_normal((k, k)))
         for _ in range(3)]
    rm = pt.ReducedModel(
        domain=torch.linspace(1.0, 2.0, 9, dtype=torch.float64),
        q=torch.from_numpy(rng.standard_normal((20, k)) + 0j), r0=r[0],
        r1=r[1], r2=r[2], b_r=torch.from_numpy(rng.standard_normal((k, 2))
                                               + 0j),
        ncols=k, t_a0=lambda t: torch.ones_like(t), t_a1=lambda t: t,
        t_a2=lambda t: t**2, t_b=lambda t: t * torch.exp(1j * t),
    )
    path = str(tmp_path / "complex.npz")
    pt.save_reduced_model(path, rm)
    rj = mt.load_reduced_model(path, t_b=lambda t: t * jnp.exp(1j * t))
    np.testing.assert_array_equal(np.asarray(rj.r1), _np(r[1]))
    with pytest.warns(UserWarning, match="t_b"):
        pt.load_reduced_model(path, device=CPU)


def _extra_addend_model():
    """A two-addend model whose third slot lives in r_extra (as the
    matrix-free complex route builds them), and the same model with the
    addend folded into r1."""
    rng = np.random.default_rng(9)
    k = 5
    sym = [(a + a.T) / 2 for a in rng.standard_normal((3, k, k))]
    sym[0] = sym[0] + 6 * np.eye(k)
    b_r = rng.standard_normal((k, 2))
    domain = np.linspace(1.0, 2.0, 11)
    return sym, b_r, domain


def test_port_refuses_to_save_extra_addends(tmp_path):
    sym, b_r, domain = _extra_addend_model()
    t = [torch.from_numpy(a) for a in sym]
    rm = pt.ReducedModel(
        domain=torch.from_numpy(domain), q=torch.eye(5, dtype=torch.float64),
        r0=t[0], r1=torch.zeros_like(t[0]), r2=t[2], b_r=torch.from_numpy(b_r),
        ncols=5, t_a0=lambda t: torch.ones_like(t), t_a1=lambda t: t,
        t_a2=lambda t: t**2, t_b=lambda t: t, r_extra=(t[1],),
        t_extra=(lambda t: 0.5 * t,),
    )
    path = tmp_path / "extra.npz"
    with pytest.raises(ValueError, match="extra addends"):
        pt.save_reduced_model(str(path), rm)
    assert not path.exists()
    # the three-term model saves as before
    pt.save_reduced_model(str(path), dataclasses.replace(
        rm, r_extra=(), t_extra=()))


@pytest.mark.xfail(strict=True, reason=(
    "reference defect: save_reduced_model (morfem_tpu/utils/checkpoint.py:"
    "59-84) writes neither r_extra nor t_extra, so a model with extra "
    "addends reloads as a three-term model and sweeps wrong, silently"))
def test_reference_checkpoint_keeps_extra_addends(tmp_path):
    sym, b_r, domain = _extra_addend_model()
    rm = mt.ReducedModel(
        domain=jnp.asarray(domain), q=jnp.eye(5), r0=jnp.asarray(sym[0]),
        r1=jnp.zeros((5, 5)), r2=jnp.asarray(sym[2]), b_r=jnp.asarray(b_r),
        ncols=jnp.asarray(5), t_a0=lambda t: jnp.ones_like(t),
        t_a1=lambda t: t, t_a2=lambda t: t**2, t_b=lambda t: t,
        r_extra=(jnp.asarray(sym[1]),), t_extra=(lambda t: 0.5 * t,),
    )
    path = str(tmp_path / "extra.npz")
    mt.save_reduced_model(path, rm)
    loaded = mt.load_reduced_model(path)
    cfg = mt.MorfemConfig()
    assert _rel(mt.sweep(loaded, cfg), mt.sweep(rm, cfg)) < 1e-12
