"""The port's parallel layer (gloo CPU ranks) against the JAX package's
(the conftest's virtual CPU devices), at meshes of the same shape.

Each module fixture spawns one world of ranks (`run_spmd`) and evaluates
several entry points in it (`call_on_mesh`), so the spawn cost is paid a
few times per file. Inputs are made with numpy from fixed seeds and fed to
both packages; the bars are those of `tests/test_parallel.py`.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import morfem_tpu as mt
import morfem_tpu.parallel as jpar
from morfem_tpu.mor.equally import seed_indices as j_seed_indices
from morfem_tpu.mor.spectral import prepare_spectral_quadratic as j_psq

import morfem_tpu_torch as pt
import morfem_tpu_torch.parallel as tpar
from morfem_tpu_torch.mor.spectral import prepare_spectral_quadratic
from morfem_tpu_torch.parallel.launch import MESH, Call, call_on_mesh, run_spmd

CPU = "cpu"
CFG_T = pt.MorfemConfig(factor_dtype_name="float64", refine_iterations=0)
CFG_J = mt.MorfemConfig(factor_dtype_name="float64", refine_iterations=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _affine(seed, n, m=2, pts=16, t_lo=3.0, t_hi=5.0):
    """(domain, a0, a1, a2, b) in numpy: symmetric random addends of scale
    1/n, a0 shifted by 2 + t_hi² (safely invertible on the grid)."""
    rng = np.random.default_rng(seed)

    def mat():
        a = rng.standard_normal((n, n)) / n
        return (a + a.T) / 2

    a0 = mat() + np.eye(n) * (2.0 + t_hi**2)
    a1, a2 = mat(), mat()
    b = rng.standard_normal((n, m))
    return np.linspace(t_lo, t_hi, pts), a0, a1, a2, b


def _systems(arrays):
    return (pt.AffineSystem.create(*arrays, device=CPU),
            mt.AffineSystem.create(*(jnp.asarray(x) for x in arrays)))


def _jmesh(dp, sp, tp):
    if len(jax.devices()) < dp * sp * tp:
        pytest.skip("needs the conftest's virtual devices")
    return jpar.make_mesh(dp=dp, sp=sp, tp=tp)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _close(actual, desired, rtol):
    """max |actual − desired| ≤ rtol · max |desired|: a relative bar on
    the array's scale (entries near zero of a Galerkin projection carry
    the roundoff of its large ones; the JAX package's own projection
    misses an entrywise 1e-11 on these inputs by 1.4e-10)."""
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert np.abs(actual - desired).max() <= rtol * np.abs(desired).max()


# -- names, mesh shapes, one rank in process --------------------------------

def test_public_names_equal_the_jax_package():
    assert set(tpar.__all__) == set(jpar.__all__)
    for n in range(1, 33):
        assert tpar.factorize_mesh(n) == jpar.factorize_mesh(n)


def test_one_rank_in_process_and_too_small_a_world():
    """World 1 (gloo, this process): make_mesh refuses a mesh larger than
    the world, as the reference does; at (1,1,1) the sharded sweep and the
    projection equal the single-device functions."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
            rank=0, world_size=1)
        try:
            with pytest.raises(ValueError, match="need 2 devices, have 1"):
                tpar.make_mesh(dp=2)
            mesh = tpar.make_mesh()
            assert mesh.mesh_dim_names == ("dp", "sp", "tp")
            sys_t, _ = _systems(_affine(0, 40, pts=11))
            q = pt.equally_distributed_basis(sys_t, CFG_T, count=3)
            rm = pt.project(sys_t, q)
            assert torch.equal(tpar.sharded_sweep(rm, mesh, CFG_T),
                               pt.sweep(rm, CFG_T))
            u, r, b_r = tpar.tp_operator_images_and_project(
                sys_t.operators(), sys_t.b, q, mesh)
            for p, a in enumerate(sys_t.operators()):
                _close(u[p], a @ q, 1e-12)
                _close(r[p], q.T @ a @ q, 1e-11)
            _close(b_r, q.T @ sys_t.b, 1e-12)
        finally:
            dist.destroy_process_group()


# -- tp: projection, row-parallel Krylov, column-sharded Gauss–Jordan --------

def _dense_problem(seed, n, rows_scaled=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    if rows_scaled is not None:
        a[rows_scaled[0]] *= rows_scaled[1]
    return a, rng.standard_normal((n, 3))


def _krylov_problem(seed, n=64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) / n
    return (a + a.T) / 2 + np.eye(n) * 3, rng.normal(size=(n, 2))


@pytest.fixture(scope="module")
def tp4():
    """One world of 4 ranks on a (1, 1, 4) mesh and the JAX package's tp=4
    results on the same inputs."""
    arrays = _affine(0, 64, pts=16)
    sys_t, sys_j = _systems(arrays)
    q = np.linalg.qr(np.random.default_rng(1).standard_normal((64, 12)))[0]
    qt = torch.from_numpy(q)
    ak, bk = _krylov_problem(5)
    ag, bg = _krylov_problem(6)
    ad, bd = _dense_problem(21, 200, rows_scaled=(3, 1e6))
    ac, bc = _dense_problem(23, 200, rows_scaled=(5, 1e5))
    t = torch.from_numpy
    seeds = sys_t.domain[[0, 7, 15]]
    calls = [
        Call(tpar.tp_operator_images_and_project,
             (sys_t.operators(), sys_t.b, qt, MESH)),
        Call(tpar.tp_solve, (t(ak), t(bk), MESH), {"tol": 1e-12}),
        Call(tpar.tp_solve, (t(ag), t(bg), MESH),
             {"tol": 1e-12, "method": "gmres"}),
        Call(tpar.tp_snapshot_basis, (sys_t, seeds, MESH, CFG_T),
             {"tol": 1e-12}),
        Call(tpar.tp_gj_apply, (Call(tpar.tp_gj_factor, (t(ad), MESH),
                                     {"panel": 16, "sub": 8}),
                                t(bd), MESH)),
        Call(tpar.tp_solve_dense, (t(ad), t(bd), MESH),
             {"panel": 16, "sub": 8}),
        Call(tpar.tp_solve_dense_compiled, (t(ac), t(bc), MESH),
             {"panel": 16, "sub": 8}),
        Call(tpar.tp_gj_factor, (t(ad), MESH), {"panel": 16, "sub": 8}),
    ]
    names = ["project", "bicgstab", "gmres", "snapshot", "gj_apply",
             "solve_dense", "compiled", "factor"]
    out = dict(zip(names, run_spmd(call_on_mesh, 4, "gloo", CPU,
                                   (1, 1, 4), calls)))
    jm = _jmesh(1, 1, 4)
    return dict(out=out, jm=jm, sys_t=sys_t, sys_j=sys_j, q=q,
                krylov=((ak, bk), (ag, bg)), dense=((ad, bd), (ac, bc)))


def test_tp_projection_matches_dense_and_the_jax_package(tp4):
    u, r, b_r = tp4["out"]["project"]
    sys_j, q = tp4["sys_j"], tp4["q"]
    uj, rj, brj = jpar.tp_operator_images_and_project(
        sys_j.operators(), sys_j.b, jnp.asarray(q), tp4["jm"])
    ops = [np.asarray(a) for a in sys_j.operators()]
    for p in range(3):
        _close(u[p], ops[p] @ q, 1e-12)
        _close(r[p], q.T @ ops[p] @ q, 1e-11)
        _close(u[p], uj[p], 1e-12)
        _close(r[p], rj[p], 1e-11)
    _close(b_r, q.T @ np.asarray(sys_j.b), 1e-12)
    _close(b_r, brj, 1e-12)


@pytest.mark.parametrize("method,which", [("bicgstab", 0), ("gmres", 1)])
def test_tp_solve_matches_dense_and_the_jax_package(tp4, method, which):
    x, relres = tp4["out"][method]
    a, b = tp4["krylov"][which]
    assert float(relres.max()) < 1e-10
    ref = np.linalg.solve(a, b)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-7, atol=1e-10)
    xj, rj = jpar.tp_solve(jnp.asarray(a), jnp.asarray(b), tp4["jm"],
                           tol=1e-12, method=method)
    assert float(jnp.max(rj)) < 1e-10
    # both converged to 1e-12 relative residuals on a well-conditioned
    # matrix: they agree far inside the bar against the dense solve
    assert _rel(x.numpy(), np.asarray(xj)) < 1e-10


def test_tp_snapshot_basis_matches_the_jax_package(tp4):
    q, rs, b_r, worst = tp4["out"]["snapshot"]
    assert worst < 1e-10
    sys_j = tp4["sys_j"]
    qj, rsj, brj, worst_j = jpar.tp_snapshot_basis(
        sys_j, sys_j.domain[jnp.asarray([0, 7, 15])], tp4["jm"], CFG_J,
        tol=1e-12)
    assert worst_j < 1e-10

    def rec(q, rs, b_r, sys):
        def t(x):
            return torch.tensor(np.asarray(x))

        rm = pt.mor.reduced.ReducedModel(
            domain=t(sys.domain), q=t(q), r0=t(rs[0]), r1=t(rs[1]),
            r2=t(rs[2]), b_r=t(b_r), ncols=q.shape[1],
            t_a0=tp4["sys_t"].t_a0, t_a1=tp4["sys_t"].t_a1,
            t_a2=tp4["sys_t"].t_a2, t_b=tp4["sys_t"].t_b)
        return torch.einsum("nk,ikm->inm", rm.q, pt.sweep(rm, CFG_T))

    rec_t = rec(q, rs, b_r, sys_j)
    rec_j = rec(qj, rsj, brj, sys_j)
    # the dense single-device pipeline at the same seeds (the reference
    # test's oracle, atol 1e-7)
    qd = pt.equally_distributed_basis(tp4["sys_t"], CFG_T, count=3)
    rm_d = pt.project(tp4["sys_t"], qd)
    rec_d = torch.einsum("nk,ikm->inm", qd, pt.sweep(rm_d, CFG_T))
    np.testing.assert_allclose(rec_t.numpy(), rec_d.numpy(), atol=1e-7)
    np.testing.assert_allclose(rec_t.numpy(), rec_j.numpy(), atol=1e-7)


def test_tp_gj_factor_and_refined_solve(tp4):
    """Column-sharded Gauss–Jordan over tp=4 (N=200 pads to 256 with
    panel=16): the f32 apply to factor quality, the refined solve to
    working precision, both as the JAX package's."""
    (a, b), _ = tp4["dense"]
    ref = np.linalg.solve(a, b)
    x32 = tp4["out"]["gj_apply"].numpy()
    assert _rel(x32, ref) < 1e-3
    jm = tp4["jm"]
    fac_j = jpar.tp_gj_factor(jnp.asarray(a), jm, panel=16, sub=8)
    assert _rel(x32, np.asarray(jpar.tp_gj_apply(fac_j, jnp.asarray(b), jm))
                ) < 1e-5
    fac = tp4["out"]["factor"]
    assert tuple(fac.c.shape) == (256, 256) and fac.n == 200
    # the same pivots as the reference's masked partial pivoting
    np.testing.assert_array_equal(fac.pivrows.numpy(),
                                  np.asarray(fac_j.pivrows))
    assert _rel(tp4["out"]["solve_dense"].numpy(), ref) < 1e-12
    xj = jpar.tp_solve_dense(jnp.asarray(a), jnp.asarray(b), jm, panel=16,
                             sub=8, fac=fac_j)
    assert _rel(np.asarray(xj), ref) < 1e-12


def test_tp_dense_compiled_and_single_card_gj(tp4):
    _, (a, b) = tp4["dense"]
    ref = np.linalg.solve(a, b)
    assert _rel(tp4["out"]["compiled"].numpy(), ref) < 1e-12
    xj = jpar.tp_solve_dense_compiled(jnp.asarray(a), jnp.asarray(b),
                                      tp4["jm"], panel=16, sub=8)
    assert _rel(np.asarray(xj), ref) < 1e-12
    # the distributed apply agrees with the single-card inverse's
    (ad, bd), _ = tp4["dense"]
    ainv = pt.gj_inverse_f32(torch.from_numpy(ad), panel=16, sub=8)
    x_sc = (ainv.double() @ torch.from_numpy(bd)).numpy()
    assert _rel(tp4["out"]["gj_apply"].numpy(), x_sc) < 1e-5


# -- sp: sharded sweeps ------------------------------------------------------

@pytest.fixture(scope="module")
def sp4():
    """One world of 4 ranks on a (1, 4, 1) mesh: the reduced sweep on a
    divisible (64) and a non-divisible (100) grid, the quadratic spectral
    sweep (51 points) and the full-order sweep (42 points, refinement on)."""
    cases = {}
    for key, seed, pts in (("sweep64", 2, 64), ("sweep100", 7, 100),
                           ("spectral", 8, 51)):
        arrays = _affine(seed, 48, pts=pts)
        sys_t, sys_j = _systems(arrays)
        rm = pt.project(sys_t, pt.equally_distributed_basis(sys_t, CFG_T,
                                                            count=4))
        cases[key] = (sys_t, sys_j, rm)
    full = _affine(13, 40, pts=42)
    cfg_full = pt.MorfemConfig(factor_dtype_name="float32",
                               refine_iterations=3)
    sq = prepare_spectral_quadratic(cases["spectral"][2], CFG_T)
    calls = [
        Call(tpar.sharded_sweep, (cases["sweep64"][2], MESH, CFG_T)),
        Call(tpar.sharded_sweep, (cases["sweep100"][2], MESH, CFG_T)),
        Call(tpar.sharded_spectral_sweep, (sq, MESH)),
        Call(tpar.sharded_full_order_sweep,
             (_systems(full)[0], MESH, cfg_full)),
    ]
    out = run_spmd(call_on_mesh, 4, "gloo", CPU, (1, 4, 1), calls)
    return dict(out=out, cases=cases, sq=sq, full=full, cfg_full=cfg_full,
                jm=_jmesh(1, 4, 1))


def _jax_rm(sys_j, count=4):
    q = mt.equally_distributed_basis(sys_j, CFG_J, count=count)
    return mt.project(sys_j, q)


@pytest.mark.parametrize("key,which", [("sweep64", 0), ("sweep100", 1)])
def test_sharded_sweep_matches_local_and_the_jax_package(sp4, key, which):
    sys_t, sys_j, rm = sp4["cases"][key]
    x = sp4["out"][which]
    x_local = pt.sweep(rm, CFG_T)
    assert x.shape == x_local.shape
    np.testing.assert_allclose(x.numpy(), x_local.numpy(), rtol=1e-10,
                               atol=1e-14)
    rm_j = _jax_rm(sys_j)
    xj = np.asarray(jpar.sharded_sweep(rm_j, sp4["jm"], CFG_J))
    # bases may differ by column signs: compare reconstructions
    rec = np.einsum("nk,ikm->inm", rm.q.numpy(), x.numpy())
    rec_j = np.einsum("nk,ikm->inm", np.asarray(rm_j.q), xj)
    np.testing.assert_allclose(rec, rec_j, rtol=1e-10, atol=1e-12)


def test_sharded_spectral_sweep_matches_local_and_the_jax_package(sp4):
    x = sp4["out"][2]
    x_local = sp4["sq"].sweep()
    assert x.shape == x_local.shape == (51, 8, 2)
    np.testing.assert_allclose(x.numpy(), x_local.numpy(), rtol=1e-9,
                               atol=1e-12)
    sys_t, sys_j, rm = sp4["cases"]["spectral"]
    rm_j = _jax_rm(sys_j)
    xj = np.asarray(jpar.sharded_spectral_sweep(j_psq(rm_j, CFG_J),
                                                sp4["jm"]))
    rec = np.einsum("nk,ikm->inm", rm.q.numpy(), x.numpy())
    rec_j = np.einsum("nk,ikm->inm", np.asarray(rm_j.q), xj)
    np.testing.assert_allclose(rec, rec_j, rtol=1e-9, atol=1e-12)


def test_sharded_full_order_sweep_matches_local_and_the_jax_package(sp4):
    x = sp4["out"][3]
    sys_t, sys_j = _systems(sp4["full"])
    x_local = pt.solve_sweep(sys_t, sp4["cfg_full"])
    assert x.shape == x_local.shape == (42, 40, 2)
    np.testing.assert_allclose(x.numpy(), x_local.numpy(), rtol=1e-10,
                               atol=1e-13)
    cfg_j = mt.MorfemConfig(factor_dtype_name="float32", refine_iterations=3)
    xj = np.asarray(jpar.sharded_full_order_sweep(sys_j, sp4["jm"], cfg_j))
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10, atol=1e-13)


# -- dp: multi-geometry batches ---------------------------------------------

@pytest.fixture(scope="module")
def dp2():
    """One world of 4 ranks on a (2, 1, 2) mesh: four geometries through
    the equally-distributed pipeline and through the greedy."""
    mor_arrays = [_affine(30 + g, 32, pts=16) for g in range(4)]
    greedy_arrays = [_affine(40 + g, 48, pts=16) for g in range(4)]
    batch_t = {}
    for key, arrays in (("mor", mor_arrays), ("greedy", greedy_arrays)):
        batch_t[key] = tpar.batch_systems(
            [_systems(a)[0] for a in arrays])
    s0 = _systems(mor_arrays[0])[0]
    coeffs = (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b)
    sidx = j_seed_indices(16, CFG_J, count=4)
    gcfg = CFG_T.replace(max_greedy_iterations=10)
    calls = [
        Call(tpar.multi_geometry_mor, batch_t["mor"] + (sidx, coeffs, CFG_T),
             {"mesh": MESH}),
        Call(tpar.multi_geometry_greedy, batch_t["greedy"] + (coeffs, gcfg),
             {"mesh": MESH}),
    ]
    out = run_spmd(call_on_mesh, 4, "gloo", CPU, (2, 1, 2), calls)
    return dict(out=out, mor=mor_arrays, greedy=greedy_arrays, sidx=sidx,
                jm=_jmesh(2, 1, 2))


def test_multi_geometry_mor_matches_loop_and_the_jax_package(dp2):
    x, q = dp2["out"][0]
    assert tuple(x.shape) == (4, 16, 8, 2) and tuple(q.shape) == (4, 32, 8)
    systems_j = [_systems(a)[1] for a in dp2["mor"]]
    s0 = systems_j[0]
    xj, qj = jpar.multi_geometry_mor(
        *jpar.batch_systems(systems_j), jnp.asarray(dp2["sidx"]),
        (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b), CFG_J, mesh=dp2["jm"])
    for g, arrays in enumerate(dp2["mor"]):
        sys_t = _systems(arrays)[0]
        qg = pt.equally_distributed_basis(sys_t, CFG_T, count=4)
        rec_serial = torch.einsum("nk,ikm->inm", qg,
                                  pt.sweep(pt.project(sys_t, qg), CFG_T))
        rec = torch.einsum("nk,ikm->inm", q[g], x[g])
        np.testing.assert_allclose(rec.numpy(), rec_serial.numpy(),
                                   atol=1e-9)
        rec_j = np.einsum("nk,ikm->inm", np.asarray(qj[g]), np.asarray(xj[g]))
        np.testing.assert_allclose(rec.numpy(), rec_j, atol=1e-9)


def test_multi_geometry_greedy_matches_serial_and_the_jax_package(dp2):
    res = dp2["out"][1]
    assert bool(res.converged.all())
    systems_j = [_systems(a)[1] for a in dp2["greedy"]]
    s0 = systems_j[0]
    gcfg_j = CFG_J.replace(max_greedy_iterations=10)
    res_j = jpar.multi_geometry_greedy(
        *jpar.batch_systems(systems_j), (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b),
        gcfg_j, mesh=dp2["jm"])
    assert tuple(res.q.shape) == tuple(res_j.q.shape)
    for g, arrays in enumerate(dp2["greedy"]):
        rs = pt.greedy_basis(_systems(arrays)[0],
                             CFG_T.replace(max_greedy_iterations=10))
        nc = int(res.ncols[g])
        assert nc == rs.ncols == int(res_j.ncols[g])
        assert int(res.iterations[g]) == rs.iterations \
            == int(res_j.iterations[g])
        qb = res.q[g][:, :nc].numpy()
        qs = rs.q[:, :nc].numpy()
        qj = np.asarray(res_j.q[g])[:, :nc]
        np.testing.assert_allclose(qb @ qb.T, qs @ qs.T, atol=1e-9)
        np.testing.assert_allclose(qb @ qb.T, qj @ qj.T, atol=1e-9)
