"""The port's full-order spectral sweep against the JAX package's, on the
CPU: the same numpy pencil through `prepare_spectral_full` /
`spectral_full_sweep` in both packages, and against the port's own
`solve_sweep` (1e-10 relative). Both packages refuse the same pencils.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import morfem_tpu as mt
from morfem_tpu.utils.synthetic import waveguide_like_system as jax_wls

import morfem_tpu_torch as pt
from morfem_tpu_torch.compat import system_from_numpy
from morfem_tpu_torch.utils.synthetic import waveguide_like_system

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pencil(n=192, pts=30, key=0):
    """The JAX package's synthetic waveguide pencil, as numpy."""
    domain, c, g, b = (np.array(x) for x in jax_wls(
        jax.random.PRNGKey(key), n=n, num_points=pts))
    return domain, c, np.zeros_like(c), g, b


def test_matches_the_jax_package_and_the_lu_sweep():
    arrays = _pencil()
    sys_j = mt.AffineSystem.create(*arrays)
    sys_t = system_from_numpy(*arrays, device=CPU)
    fs_j = mt.prepare_spectral_full(sys_j)
    fs_t = pt.prepare_spectral_full(sys_t)
    assert fs_t.swapped == bool(fs_j.swapped)
    assert fs_t.sigma == pytest.approx(float(fs_j.sigma), rel=1e-15)
    x_t = fs_t.sweep()
    assert tuple(x_t.shape) == (30, 192, 2)
    assert _rel(x_t, fs_j.sweep()) < 1e-10
    assert _rel(x_t, pt.solve_sweep(sys_t)) < 1e-10
    # a custom grid, in chunks that do not divide it
    ts = np.linspace(3.2e9, 4.8e9, 17)
    x2 = pt.spectral_full_sweep(fs_t, torch.from_numpy(ts), chunk=5)
    o2 = pt.solve_sweep(sys_t.with_domain(ts))
    assert _rel(x2, o2) < 1e-10
    assert _rel(x2, mt.spectral_full_sweep(fs_j, jnp.asarray(ts))) < 1e-10


def test_swapped_role_when_only_a0_is_definite():
    """a2 indefinite, a0 definite: the prepare takes a0 as the SPD term."""
    rng = np.random.default_rng(4)
    n = 40
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a0 = (q * np.linspace(1.0, 3.0, n)) @ q.T
    a2 = (q * np.linspace(-2.0, 2.0, n)) @ q.T * 0.01
    a0, a2 = (a0 + a0.T) / 2, (a2 + a2.T) / 2
    b = rng.standard_normal((n, 2))
    arrays = (np.linspace(0.5, 1.5, 12), a0, np.zeros((n, n)), a2, b)
    fs_t = pt.prepare_spectral_full(system_from_numpy(*arrays, device=CPU))
    fs_j = mt.prepare_spectral_full(mt.AffineSystem.create(*arrays))
    assert fs_t.swapped and bool(fs_j.swapped)
    sys_t = system_from_numpy(*arrays, device=CPU)
    assert _rel(fs_t.sweep(), pt.solve_sweep(sys_t)) < 1e-10
    assert _rel(fs_t.sweep(), fs_j.sweep()) < 1e-10


def _rejections():
    domain, c, z, g, b = _pencil(n=64, pts=8, key=1)
    n = c.shape[0]
    # one flipped diagonal entry in each term: neither is ± definite
    g_indef = g.copy()
    g_indef[0, 0] = -g_indef[0, 0]
    c_indef = c.copy()
    c_indef[0, 0] = -c_indef[0, 0]
    return {
        "complex": (domain, c, z, g, b.astype(np.complex128)),
        "three_term": (domain, c, np.eye(n), g, b),
        "indefinite": (domain, c_indef, z, g_indef, b),
    }


@pytest.mark.parametrize("case", ["complex", "three_term", "indefinite"])
def test_both_packages_refuse_the_same_pencils(case):
    arrays = _rejections()[case]
    with pytest.raises(ValueError):
        mt.prepare_spectral_full(mt.AffineSystem.create(*arrays))
    with pytest.raises(ValueError):
        pt.prepare_spectral_full(system_from_numpy(*arrays, device=CPU))


def test_refuses_complex_coefficients_and_unsymmetric_operators():
    domain, c, z, g, b = _pencil(n=64, pts=8, key=1)
    sys_t = system_from_numpy(domain, c, z, g, b, device=CPU)
    cplx = dataclasses.replace(sys_t, t_b=lambda t: t * (1 + 1j))
    with pytest.raises(ValueError, match="complex coefficients"):
        pt.prepare_spectral_full(cplx)
    skew = dataclasses.replace(sys_t, a0=sys_t.a0 + torch.triu(
        torch.ones_like(sys_t.a0)) * 1e-3 * float(sys_t.a0.abs().max()))
    with pytest.raises(ValueError, match="symmetric"):
        pt.prepare_spectral_full(skew, pt.MorfemConfig(symmetrize=False))
    pt.prepare_spectral_full(skew)  # symmetrized by default


def test_port_generator_gives_a_sweepable_pencil():
    """The port's own waveguide-like generator: two-term, -Γ definite."""
    domain, c, g, b = waveguide_like_system(3, n=96, num_points=12,
                                            device=CPU)
    sys_t = pt.AffineSystem.create(domain, c, torch.zeros_like(c), g, b,
                                   device=CPU)
    fs = pt.prepare_spectral_full(sys_t)
    assert not fs.swapped and fs.sigma < 0
    assert _rel(fs.sweep(), pt.solve_sweep(sys_t)) < 1e-10
