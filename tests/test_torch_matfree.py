"""The port's matrix-free route against the JAX package: the greedy over
banded and block-sparse operators (direct and Krylov snapshot solves,
kernels K5 and K6 through their plain versions on the CPU), `morfem()` on
SciPy-sparse input above ``dense_cutoff`` (banded and general routes),
and the copies of the synthetic generators. Inputs are made with numpy
from fixed seeds and fed to both packages.
"""

import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

import morfem_tpu as mt
from morfem_tpu.mor.reduced import sweep as jax_sweep
from morfem_tpu.ops.block_sparse import (
    BlockSparseAffineOperator as JaxBlockSparseOperator,
)
from morfem_tpu.ops.pallas.banded_matvec import (
    BandedAffineOperator as JaxBandedOperator,
)
from morfem_tpu.utils import synthetic as jsyn

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.ops.block_sparse import BlockSparseAffineOperator
from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from morfem_tpu_torch.ops.sparse import solve_point_iterative
from morfem_tpu_torch.system import (
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)
from morfem_tpu_torch.utils import synthetic as tsyn

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded_system(n=240, m=2, half=6, seed=0):
    """Diagonally dominant banded affine system (Krylov-friendly), built as
    the JAX package's matrix-free greedy tests build it."""
    rng = np.random.default_rng(seed)

    def band(scale, shift):
        diags = [rng.normal(size=n - abs(d)) * scale / (1 + abs(d))
                 for d in range(-half, half + 1)]
        a = sp.diags(diags, offsets=range(-half, half + 1)).toarray()
        return (a + a.T) / 2 + np.eye(n) * shift

    a0 = band(1.0, 12.0)
    a1 = np.zeros((n, n))
    a2 = band(0.3, 0.0)
    b = rng.normal(size=(n, m))
    domain = np.linspace(1.0, 2.0, 24)
    return domain, a0, a1, a2, b


def _with_far_couplings(mats, seed=1, nfar=60):
    """Add a weak scattered off-band remainder to a0 (block-sparse case)."""
    rng = np.random.default_rng(seed)
    n = mats[0].shape[0]
    far = sp.coo_matrix((0.05 * rng.standard_normal(nfar),
                         (rng.integers(0, n, nfar), rng.integers(0, n, nfar))),
                        shape=(n, n))
    return [(mats[0] + far + far.T).tocsr(), mats[1], mats[2]]


@pytest.mark.parametrize("kind,method", [
    ("banded", "auto"), ("banded", "bicgstab"), ("block_sparse", "bicgstab"),
])
def test_greedy_matfree_matches_reference(kind, method):
    domain, a0, a1, a2, b = _banded_system()
    mats = [sp.csr_matrix(a) for a in (a0, a1, a2)]
    if kind == "banded":
        op_t = BandedAffineOperator(*mats, device=CPU)
        op_j = JaxBandedOperator(*mats)
    else:
        mats = _with_far_couplings(mats)
        op_t = BlockSparseAffineOperator(*mats, device=CPU)
        op_j = JaxBlockSparseOperator(*mats)
    kw = dict(error_threshold=1e-9)
    reset_launch_counts()
    res_t, rm_t = greedy_basis_matfree(op_t, b, domain,
                                       config=pt.MorfemConfig(**kw),
                                       method=method)
    assert sum(launch_counts().values()) == 0  # CPU: plain versions
    res_j, rm_j = mt.greedy_basis_matfree(op_j, jnp.asarray(b),
                                          jnp.asarray(domain),
                                          config=mt.MorfemConfig(**kw),
                                          method=method)
    assert res_t.converged and bool(res_j.converged)
    assert not res_t.failed_snapshot
    assert res_t.ncols == int(res_j.ncols)
    assert res_t.iterations == int(res_j.iterations)
    x_t = pt.sweep(rm_t, pt.MorfemConfig(**kw))
    x_j = jax_sweep(rm_j, mt.MorfemConfig(**kw))
    rec_t = np.einsum("nk,ikm->inm", rm_t.q.numpy(), x_t.numpy())
    rec_j = np.einsum("nk,ikm->inm", np.asarray(rm_j.q), np.asarray(x_j))
    dense = [((m + m.T) * 0.5).toarray() for m in mats]
    ref = np.stack([np.linalg.solve(dense[0] + t * dense[1] + t * t * dense[2],
                                    t * b) for t in domain])
    scale = np.linalg.norm(ref)
    # both bases reach the 1e-9 estimator threshold: the reconstructions
    # agree with the dense solves and with each other to ~1e-9
    assert np.linalg.norm(rec_t - ref) <= 1e-7 * scale
    assert np.linalg.norm(rec_t - rec_j) <= 1e-7 * scale


@pytest.mark.parametrize("kind", ["banded", "block_sparse"])
def test_krylov_snapshot_solve_matches_dense(kind):
    domain, a0, a1, a2, b = _banded_system(seed=2)
    mats = [sp.csr_matrix(a) for a in (a0, a1, a2)]
    if kind == "banded":
        op = BandedAffineOperator(*mats, device=CPU)
    else:
        mats = _with_far_couplings(mats, seed=3)
        op = BlockSparseAffineOperator(*mats, device=CPU)
    c = torch.tensor([1.0, 0.0, 1.69], dtype=torch.float64)
    rhs = torch.from_numpy(b * 1.3)
    x, relres = solve_point_iterative(op, c, rhs, tol=1e-10,
                                      method="bicgstab", return_residual=True)
    dense = sum(float(c[p]) * ((m + m.T) * 0.5).toarray()
                for p, m in enumerate(mats))
    ref = np.linalg.solve(dense, b * 1.3)
    assert float(relres.max()) < 1e-10
    # f32 kernel matvec inside BiCGStab + three f64 refinement passes
    assert np.linalg.norm(x.numpy() - ref) <= 1e-9 * np.linalg.norm(ref)
    xg, rel_g = solve_point_iterative(op, c, rhs, tol=1e-10, method="gmres",
                                      return_residual=True)
    assert np.linalg.norm(xg.numpy() - ref) <= 1e-6 * np.linalg.norm(ref)


def test_sparse_snapshot_basis_and_projection_match():
    from morfem_tpu.ops.sparse import (
        sparse_project as jax_project,
        sparse_snapshot_basis as jax_snapshots,
    )
    from morfem_tpu_torch.ops.sparse import (
        sparse_project,
        sparse_snapshot_basis,
    )

    domain, a0, a1, a2, b = _banded_system(seed=4)
    mats = [sp.csr_matrix(a) for a in (a0, a1, a2)]
    idx = np.array([0, 9, 23])
    q = sparse_snapshot_basis(
        mats, torch.from_numpy(b), torch.from_numpy(domain), idx,
        (_default_t_a0, _default_t_a1, _default_t_a2, _default_t_b),
        op=BandedAffineOperator(*mats, device=CPU))
    qj = np.asarray(jax_snapshots(
        mats, jnp.asarray(b), jnp.asarray(domain), jnp.asarray(idx),
        (lambda t: 1.0, lambda t: t, lambda t: t ** 2, lambda t: t),
        op=JaxBandedOperator(*mats)))
    assert q.shape == qj.shape == (240, 6)
    # the same snapshots span the same space (SVD signs are free)
    np.testing.assert_allclose(q.numpy() @ q.numpy().T, qj @ qj.T,
                               atol=1e-10)
    rs, b_r = sparse_project(mats, torch.from_numpy(b), q)
    rsj, b_rj = jax_project(mats, jnp.asarray(b), jnp.asarray(q.numpy()))
    for r, rj in zip((*rs, b_r), (*rsj, b_rj)):
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-12,
                                   atol=1e-12)


def test_failed_snapshot_stops_cleanly():
    """Port twin of the JAX package's test of the same name: a hopeless
    Krylov budget must warn and return converged=False without poisoning
    the basis, in both packages alike."""
    from morfem_tpu.ops.sparse import SparseAffineOperator as JaxSparseOp
    from morfem_tpu_torch.ops.sparse import SparseAffineOperator

    domain, a0, a1, a2, b = _banded_system(seed=9)
    mats = [sp.csr_matrix(a) for a in (a0, a1, a2)]
    kw = dict(factor_dtype_name="float64", refine_iterations=0,
              error_threshold=1e-9, orthonormalization="mgs")
    cfg = pt.MorfemConfig(**kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res, rm = greedy_basis_matfree(
            SparseAffineOperator(*mats, symmetrize=cfg.symmetrize,
                                 device=CPU),
            b, domain, config=cfg, snapshot_tol=1e-12, snapshot_maxiter=1)
    assert not res.converged and res.failed_snapshot
    assert any("relative residual" in str(x.message) for x in w)
    assert np.isfinite(res.q.numpy()).all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res_j, _ = mt.greedy_basis_matfree(
            JaxSparseOp(*mats, symmetrize=cfg.symmetrize), jnp.asarray(b),
            jnp.asarray(domain), config=mt.MorfemConfig(**kw),
            snapshot_tol=1e-12, snapshot_maxiter=1)
    assert not bool(res_j.converged) and bool(res_j.failed_snapshot)
    assert res.iterations == int(res_j.iterations)


@pytest.mark.parametrize("failed", [True, False])
def test_morfem_unconverged_warning_matches_the_reference(failed):
    """morfem()'s warning after a failed snapshot says the build ABORTED
    and that more iterations will NOT help; after an exhausted budget it
    says to raise them. Same text as the JAX package's."""
    from morfem_tpu.mor.api import _warn_if_unconverged as jax_warn
    from morfem_tpu.mor.greedy import GreedyResult as JaxGreedyResult
    from morfem_tpu_torch.mor.api import _warn_if_unconverged
    from morfem_tpu_torch.mor.greedy import GreedyResult

    fields = dict(q=np.zeros((4, 2)), ncols=2, iterations=3,
                  converged=False, err_hist=np.zeros((4, 5)),
                  failed_snapshot=failed)
    messages = []
    for warn, cls in ((_warn_if_unconverged, GreedyResult),
                      (jax_warn, JaxGreedyResult)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            warn(cls(**fields))
        assert len(w) == 1
        messages.append(str(w[0].message))
    assert messages[0] == messages[1]
    if failed:
        assert "ABORTED" in messages[0]
        assert "will NOT help" in messages[0]
    else:
        assert "raise config.max_greedy_iterations" in messages[0]


def test_general_route_converges_with_dropped_mass_like_the_reference():
    """The truncated-band GMRES route with mass outside the band: the port
    and the JAX package drop the same mass and both converge. (With ~12 %
    or more dropped, as on the bare 2-D pencil with a band below its
    natural half-bandwidth p+1, both stall alike: tools/general_route_stall.py,
    PERF.md.)"""
    from chip_smoke import scattered_waveguide_2d
    from morfem_tpu.ops import block_tridiag as jbt
    from morfem_tpu_torch.ops import block_tridiag as tbt

    mats, wp = scattered_waveguide_2d(32)
    band, f = 40, 3e9
    coef = [1.0, f, f * f]
    ex_t, bd_t, perm_t, dropped_t = tbt.truncated_band_via_rcm(
        *mats, band_half=band, device=CPU)
    ex_j, bd_j, perm_j, dropped_j = jbt.truncated_band_via_rcm(
        *mats, band_half=band)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert 0.0 < dropped_t == dropped_j < 0.01
    rhs = f * wp[perm_t.numpy()]
    x_t, rel_t = tbt.general_sparse_solve(
        ex_t, bd_t, torch.tensor(coef, dtype=torch.float64),
        torch.from_numpy(rhs), maxiter=3)
    x_j, rel_j = jbt.general_sparse_solve(
        ex_j, bd_j, jnp.asarray(coef), jnp.asarray(rhs), maxiter=3)
    assert float(rel_t.max()) < 1e-10 and float(np.max(rel_j)) < 1e-10
    perm = perm_t.numpy()
    a = sum(cp * ((m + m.T) * 0.5) for cp, m in zip(coef, mats)).tocsc()
    ref = sp.linalg.spsolve(a[perm][:, perm], rhs)
    for x in (x_t.numpy(), np.asarray(x_j)):
        assert np.linalg.norm(x - ref) <= 1e-8 * np.linalg.norm(ref)


def _scrambled_waveguide(n=1024, seed=3):
    c, t, wp = tsyn.banded_waveguide_system(n, half=5, seed=0)
    scram = np.random.default_rng(seed).permutation(n)
    cs = c.tocsr()[scram][:, scram]
    gs = (t * GAMMA_SCALE).tocsr()[scram][:, scram]
    return (np.linspace(3e9, 5e9, 24), cs, sp.csr_matrix((n, n)), gs,
            np.asarray(wp)[scram])


@pytest.mark.parametrize("route", ["banded", "general", "fused_lu",
                                   "equally"])
def test_morfem_matfree_routes_match_dense_solves(route):
    domain, cs, zero, gs, wps = _scrambled_waveguide()
    kw = dict(error_threshold=1e3, max_greedy_iterations=40, dense_cutoff=512)
    if route == "general":
        kw["band_max_half"] = 4  # RCM half-bandwidth is larger: general
    if route == "fused_lu":
        kw.update(sweep_method="lu", use_pallas_reduced_sweep=True)
    if route == "equally":
        # a snapshot at every grid point: the basis spans every solution
        # checked below
        kw.update(use_equally_distributed=True,
                  equally_distributed_reduction_rate=0.0)
    timer = pt.PhaseTimer()
    x, q, r0, r1, r2, b_r = pt.morfem(domain, cs, zero, gs, wps,
                                      config=pt.MorfemConfig(**kw),
                                      timer=timer, device=CPU)
    assert "operator setup" in timer.times and "reduced sweep" in timer.times
    assert q.shape[0] == 1024 and x.shape == (24, q.shape[1], 2)
    assert r0.shape == (q.shape[1], q.shape[1]) and b_r.shape[0] == q.shape[1]
    cd, gd = cs.toarray(), gs.toarray()
    worst = 0.0
    for i in (0, 7, 15, 23):
        f = domain[i]
        a_f = cd + gd * f * f
        a_f = (a_f + a_f.T) / 2
        ref = np.linalg.solve(a_f, wps * f)
        # q is in the caller's (scrambled) row order
        rec = q.numpy() @ x[i].numpy()
        worst = max(worst, np.linalg.norm(rec - ref) / np.linalg.norm(ref))
    assert worst < 1e-6, worst


def test_small_sparse_input_is_densified():
    domain, cs, zero, gs, wps = _scrambled_waveguide(n=200)
    cfg = pt.MorfemConfig(error_threshold=1e3)
    timer = pt.PhaseTimer()
    x, q, *_ = pt.morfem(domain, cs, zero, gs, wps, config=cfg, timer=timer,
                         device=CPU)
    assert "operator setup" not in timer.times  # the dense route
    xd, qd, *_ = pt.morfem(domain, cs.toarray(), zero.toarray(), gs.toarray(),
                           wps, config=cfg, device=CPU)
    rec = np.einsum("nk,ikm->inm", q.numpy(), x.numpy())
    rec_d = np.einsum("nk,ikm->inm", qd.numpy(), xd.numpy())
    np.testing.assert_allclose(rec, rec_d, rtol=0,
                               atol=1e-12 * np.abs(rec_d).max())


@pytest.mark.parametrize("gen,args", [
    ("banded_waveguide_system", dict(n=500, m=2, half=7, seed=4)),
    ("banded_waveguide_system_2d", dict(p=23, m=3, seed=5)),
])
def test_generator_copies_match(gen, args):
    got = getattr(tsyn, gen)(**args)
    ref = getattr(jsyn, gen)(**args)
    for a, b in zip(got, ref):
        if sp.issparse(a):
            assert (a != b).nnz == 0 and a.shape == b.shape
        else:
            np.testing.assert_array_equal(a, b)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|morfem_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "morfem_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    hits = [str(p.relative_to(REPO)) for p in files
            if bad.search(p.read_text())]
    assert len(files) > 30 and not hits, hits
    code = (
        "import sys, morfem_tpu_torch.mor.api, morfem_tpu_torch.mor."
        "greedy_matfree, morfem_tpu_torch.ops.block_tridiag, "
        "morfem_tpu_torch.ops.sparse, morfem_tpu_torch.ops.block_sparse, "
        "morfem_tpu_torch.ops.ell, morfem_tpu_torch.ops.krylov, "
        "morfem_tpu_torch.utils.synthetic\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'morfem_tpu' or m.startswith('morfem_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
