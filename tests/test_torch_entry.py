"""The flagship step (morfem_tpu_torch/entry.py) against the JAX package.

`__graft_entry__.entry()`'s example arguments, as numpy, go through
``jax.jit`` of the reference step and through the port's step, eagerly on
the CPU (the JAX package's Pallas kernels in interpret mode there, the
port's kernels through their plain versions). The masked fixed-trip
refinements that make the step capturable are held against the host loops
they stand beside, bit for bit. The capture itself needs the card
(`tests/test_torch_gpu.py`).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from morfem_tpu_torch import AffineSystem, MorfemConfig, project, sweep
from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix
from morfem_tpu_torch.entry import (
    capture,
    entry,
    flagship_step,
    t_a0,
    t_a1,
    t_a2,
    t_b,
)
from morfem_tpu_torch.mor.equally import equally_distributed_basis
from morfem_tpu_torch.mor.reduced import solve_reduced_batch
from morfem_tpu_torch.ops.orthonormalize import cholesky_qr_refine
from morfem_tpu_torch.ops.panel_lu import solve_batch_panel
from morfem_tpu_torch.ops.solve import (
    gj_solve_refined,
    lu_solve_refined,
    solve_dense,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def example():
    """The reference's example arguments, as numpy and as CPU tensors."""
    _, args = graft.entry()
    arrays = [np.array(a) for a in args]
    return arrays, [torch.from_numpy(a) for a in arrays]


def _basis_signs(x_ref, x):
    """+1/−1 per basis vector aligning x with x_ref ([I, K, M] each)."""
    return np.sign(np.sum(x_ref * x, axis=(0, 2)))[None, :, None]


@pytest.mark.parametrize("cfg_kw", [None, {"factorization": "panel"}])
def test_step_matches_the_reference_step(example, cfg_kw):
    arrays, tensors = example
    out_j = [np.asarray(o) for o in
             jax.jit(graft._flagship_step(cfg_kw))(*arrays)]
    out_t = [o.numpy() for o in flagship_step(cfg_kw)(*tensors)]
    assert [o.shape for o in out_t] == [o.shape for o in out_j]
    assert all(np.isfinite(o).all() for o in out_t)
    # the GSM is basis-invariant: 3.5e-12 apart on this example
    for k in (1, 2):
        assert np.abs(out_t[k] - out_j[k]).max() < 1e-9
    # the reduced solutions agree up to each basis vector's sign (a thin
    # SVD's freedom): 1.6e-11 apart at max|x| = 2.3
    x_j, x_t = out_j[0], out_t[0]
    assert np.abs(x_j - _basis_signs(x_j, x_t) * x_t).max() < (
        1e-9 * np.abs(x_j).max())


def test_step_matches_the_library_route(example):
    """equally_distributed_basis → project → sweep → GSM at the step's
    seeds gives the step's GSM."""
    _, (a0, a1, a2, b, domain, seed_idx) = example
    _, gsm_re, gsm_im = flagship_step()(a0, a1, a2, b, domain, seed_idx)
    sys_ = AffineSystem.create(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b,
                               device="cpu")
    cfg = MorfemConfig()
    q = equally_distributed_basis(sys_, cfg, count=seed_idx.shape[0])
    rm = project(sys_, q)
    x = sweep(rm, cfg)
    _, cb = rm.coefficients(rm.domain)
    gsm = generalized_scattering_matrix(rm.domain, x,
                                        cb[:, None, None] * rm.b_r)
    assert float((gsm.real - gsm_re).abs().max()) < 1e-9
    assert float((gsm.imag - gsm_im).abs().max()) < 1e-9


def _lanes(n=40, seed=0):
    """Three [n, n] systems whose refinements leave by the three exits of
    the reference's loop at a cap of 3: converged (cond 1e1), stopped by
    the 5 % rule (cond 1e9: the f32 factor does not contract), and at the
    cap (cond 1e6: ~0.003 per step)."""
    rng = np.random.default_rng(seed)
    a, b = [], []
    for cond in (1e1, 1e9, 1e6):
        u, _ = np.linalg.qr(rng.standard_normal((n, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a.append((u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T)
        b.append(rng.standard_normal((n, 2)))
    return torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(b))


def _exit(a, b, cap):
    """Which condition ends the reference's loop on one system, the
    loop written out with its count (`ops/solve.py::_refine_adaptive`)."""
    lu, piv = torch.linalg.lu_factor(a.float())

    def apply(r):
        return torch.linalg.lu_solve(lu, piv, r.float()).double()

    x = apply(b)
    tol = 10 * torch.finfo(torch.float64).eps * float(torch.linalg.norm(b))
    r = b - a @ x
    r_norm, r_prev, it = float(torch.linalg.norm(r)), float("inf"), 0
    while r_norm > tol and r_norm < 0.95 * r_prev and it < cap:
        x = x + apply(r)
        r = b - a @ x
        r_prev, r_norm = r_norm, float(torch.linalg.norm(r))
        it += 1
    if not r_norm > tol:
        return "converged"
    return "5%" if not r_norm < 0.95 * r_prev else "cap"


CAP = 3


def test_refinement_lanes_take_each_exit():
    a, b = _lanes()
    assert [_exit(a[i], b[i], CAP) for i in range(3)] == [
        "converged", "5%", "cap"]


@pytest.mark.parametrize("route", ["lu", "gj", "panel", "reduced"])
def test_masked_refinement_equals_the_host_loop(route):
    """The masked fixed trip gives the host loop's result bit for bit:
    each lane on its own (the seed solves: vmap in the reference), or the
    whole batch on one norm (the reduced sweep)."""
    a, b = _lanes()
    if route == "lu":
        host = torch.stack([lu_solve_refined(a[i], b[i],
                                             refine_iterations=CAP)
                            for i in range(3)])
        got = lu_solve_refined(a, b, refine_iterations=CAP, masked=True)
    elif route == "gj":
        host = torch.stack([gj_solve_refined(a[i], b[i],
                                             refine_iterations=CAP)
                            for i in range(3)])
        got = gj_solve_refined(a, b, refine_iterations=CAP, masked=True)
    elif route == "panel":
        cfg = MorfemConfig(refine_iterations=CAP, panel_width=128)
        host = torch.cat([solve_batch_panel(a[i:i + 1], b[i:i + 1], cfg)
                          for i in range(3)])
        got = solve_batch_panel(a, b, cfg, masked=True)
    else:
        cfg = MorfemConfig(refine_iterations=CAP)
        for sl in (slice(0, 1), slice(1, 2), slice(2, 3), slice(0, 3)):
            assert torch.equal(
                solve_reduced_batch(a[sl], b[sl], cfg, masked=True),
                solve_reduced_batch(a[sl], b[sl], cfg))
        return
    assert torch.equal(got, host)


@pytest.mark.parametrize("factorization", ["auto", "gj", "panel"])
def test_masked_solve_dense_is_vmap_of_solve_dense(factorization):
    a, b = _lanes()
    cfg = MorfemConfig(factorization=factorization, refine_iterations=CAP,
                       panel_width=128)
    host = torch.stack([solve_dense(a[i], b[i], cfg) for i in range(3)])
    assert torch.equal(solve_dense(a, b, cfg, masked=True), host)


def test_cholesky_qr_keeps_q_on_a_singular_gram():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(np.linalg.qr(rng.standard_normal((30, 4)))[0])
    g = q.T @ q
    ref = q @ torch.linalg.inv(torch.linalg.cholesky(g)).T
    assert torch.allclose(cholesky_qr_refine(q), ref, rtol=0, atol=1e-14)
    q_bad = torch.cat([q[:, :3], torch.zeros((30, 1), dtype=q.dtype)], 1)
    assert torch.equal(cholesky_qr_refine(q_bad), q_bad)


def test_stages_compose_to_the_step(example):
    _, tensors = example
    step = flagship_step()
    assert [label for label, _, _ in step.stages] == [
        "seed solves", "thin SVD", "projection, reduced sweep and GSM"]
    assert [cap for _, _, cap in step.stages] == [True, False, True]
    out, prev = step(*tensors), ()
    for _, fn, _ in step.stages:
        prev = fn(*tensors, *prev)
    assert all(torch.equal(o, p) for o, p in zip(out, prev))


def test_entry_and_capture_need_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    _, tensors = example
    with pytest.raises(ValueError, match="CUDA"):
        capture(flagship_step(), tensors)


def test_entry_example_is_the_reference_example(example):
    arrays, _ = example
    _, args = entry("cpu")
    # jnp.linspace and np.linspace may round a grid point differently
    for mine, ref in zip(args, arrays):
        assert mine.shape == ref.shape
        assert np.allclose(mine.numpy(), ref, rtol=1e-15, atol=0)


def test_main_prints_the_reference_shapes():
    out = subprocess.run(
        [sys.executable, "-m", "morfem_tpu_torch.entry", "--cpu"],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "entry OK: [(64, 12, 2), (64, 2, 2), (64, 2, 2)]")


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, morfem_tpu_torch.entry\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'morfem_tpu' or m.startswith('morfem_tpu.')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
