"""The full-order sweep of a prepared sparse pencil
(`ops/block_tridiag.py::solve_sweep_banded`, reached through
`solve_sweep` and the waveguide's `full_order_gsm`), at a small size on
the CPU: the synthesized waveguide block of N=256 tiled 10× (N=2,560) as
SciPy-sparse matrices, prepared as a `MatfreeSystem` with
``band_max_half`` at the block's half-bandwidth (255) rounded up to 128.

The sweep agrees with the benchmark's plain float64 reference in the GSM
and in x within 1e-10: the f64 refinement reaches 10·ε·‖b‖ on this pencil,
while one apply of the f32 factor misses x by orders of magnitude. It
agrees with the snapshot solve point by point and with itself under other
chunkings; the snapshot solve keeps its bits; a chunk that cannot refine
escalates; a GMRES-route pencil sweeps point by point; and the sweep's
spans and counters are recorded.
"""

import numpy as np
import pytest
import scipy.linalg as sl
import scipy.sparse as sp
import torch

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps import waveguide as wg
from morfem_tpu_torch.ops import block_tridiag as bt
from morfem_tpu_torch.ops import sparse as sparse_ops
from morfem_tpu_torch.ops.banded_matvec import combine_addends
from morfem_tpu_torch.ops.refine import refine
from morfem_tpu_torch.ops.sparse import GeneralSparseOperator
from morfem_tpu_torch.utils import timing
from morfem_tpu_torch.utils.timing import PhaseTimer

from benchmark.harness import registry

CPU = "cpu"
N_BLOCK, RATE = 256, 10
CFG = pt.MorfemConfig(band_max_half=256)
# 13 points: a chunk of 8 and a last chunk of 5, padded to 8
FREQS = np.linspace(3e9, 5e9, 13)
CHECKED = [0, 5, 8, 12]  # points of both chunks held against the reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counters():
    bt.reset_banded_sweep_counters()


@pytest.fixture(scope="module")
def data():
    c, t, wp = wg.synthesize_waveguide(N_BLOCK)
    wp = wg.calibrate_port_amplitude(c, t, wp)
    return wg.WaveguideData(c, t, wp, wg.KTE_DEFAULT, True)


@pytest.fixture(scope="module")
def prepared(data):
    return wg.tiled_waveguide_system(FREQS, data, RATE, CFG, device=CPU)


@pytest.fixture(scope="module")
def swept(prepared):
    """x [I, N, M] of the sweep, in the caller's row order."""
    return pt.solve_sweep(prepared, CFG)


def _config_module():
    return registry.load_module(
        registry.BENCH_DIR / "configs" / "waveguide_34110.py",
        "bench_config_waveguide_34110")


def _rel(a, b):
    """The largest relative error of a point, ‖a − b‖ / ‖b‖."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    d = torch.linalg.norm((a - b).reshape(b.shape[0], -1), dim=1)
    return float((d / torch.linalg.norm(b.reshape(b.shape[0], -1),
                                         dim=1)).max())


def _dense_x(data, freqs):
    """x of the tiled pencil, symmetrised, by dense f64 solves (caller's
    row order)."""
    c_t, _, g_t, b = wg.tiled_waveguide_pencil(data, RATE)
    cm, gm = c_t.toarray(), g_t.toarray()
    cm, gm = (cm + cm.T) * 0.5, (gm + gm.T) * 0.5
    tb = wg.b_coefficient(torch.as_tensor(freqs), data.kte).numpy()
    return np.stack([np.linalg.solve(cm + f * f * gm, t * b)
                     for f, t in zip(freqs, tb)])


def test_the_sweep_matches_the_plain_reference(data, prepared, swept):
    gsm = wg.full_order_gsm(prepared, CFG)
    assert gsm.shape == (len(FREQS), 2, 2)
    ref = _config_module().tiled_gsm(data.c_mat, data.t_mat, data.wp,
                                     data.kte, RATE, FREQS[CHECKED],
                                     torch.float64, CPU)
    assert np.abs(gsm.numpy()[CHECKED] - ref).max() <= 1e-10
    x_ref = _dense_x(data, FREQS[CHECKED])
    assert _rel(swept[CHECKED], x_ref) <= 1e-10
    # one apply of the f32 factor, unrefined, misses x by far more
    c, cb = prepared.coefficients(prepared.domain[:1])
    factors = bt.block_tridiag_factor(*prepared.op.blocks(c, 256),
                                      prepared.op.n)
    x32 = bt.block_tridiag_apply(factors, cb[:, None, None] * prepared.b)
    assert _rel(x32.double(), swept[:1, prepared.perm]) > 1e-8


def test_the_sweep_equals_the_snapshot_solve_point_by_point(prepared,
                                                            swept):
    """Both refine to the residual floor, where x is accurate to ~cond·ε
    (1.7e-12 on this pencil, against dense solves as well): the limit
    leaves that floor a factor of ~6."""
    c, cb = prepared.coefficients(prepared.domain)
    x_op = swept[:, prepared.perm]
    snaps = torch.stack([
        bt.banded_direct_solve(prepared.op, c_i, cb_i * prepared.b,
                               refine_iterations=CFG.refine_iterations)[0]
        for c_i, cb_i in zip(c, cb)])
    assert _rel(x_op, snaps) <= 1e-11


@pytest.mark.parametrize("chunk", [1, 13])
def test_other_chunkings_give_the_same_answer(prepared, swept, chunk):
    """A padded last chunk (8 + 5 at the default 8), single points and
    one chunk of all 13 agree."""
    x = pt.solve_sweep(prepared, CFG.replace(solve_chunk=chunk))
    assert _rel(x, swept) <= 1e-12
    assert len(bt.solve_sweep_banded.chunk_iterations) == 13 // chunk


def test_the_snapshot_solve_keeps_its_bits(prepared):
    """`banded_direct_solve` equals, bit for bit, the one-point factor of
    the f64 blocks and the refinement loop written out."""
    op = prepared.op
    c, cb = prepared.coefficients(prepared.domain[7])
    rhs = cb * prepared.b
    x, relres, steps = bt.banded_direct_solve(op, c, rhs,
                                              refine_iterations=25)
    factors = bt.block_tridiag_factor(
        *bt.band_to_blocks(combine_addends(c, op.bands_w), op.half, 256),
        op.n)
    mv = op.bind_precise(c)

    def apply(r):
        return bt.block_tridiag_apply(factors, r).to(rhs.dtype)

    tol = 10 * torch.finfo(rhs.dtype).eps * float(torch.linalg.norm(rhs))
    want, r, _, want_steps = refine(
        apply(rhs), lambda v: rhs - mv(v), apply, tol, 25,
        norm=lambda v: float(torch.linalg.norm(v)), stop=0.97)
    assert steps == want_steps >= 1
    assert torch.equal(x, want)
    assert torch.equal(relres, torch.linalg.norm(r, dim=0)
                       / torch.linalg.norm(rhs, dim=0))
    # the f32 blocks are the f64 blocks rounded
    for got, f64 in zip(op.blocks(c, 256), bt.band_to_blocks(
            combine_addends(c, op.bands_w), op.half, 256)):
        assert torch.equal(got, f64.to(torch.float32))


def test_a_chunk_that_cannot_refine_escalates(monkeypatch):
    """At an eigenvalue of the pencil (a 48-DOF waveguide tiled 4×) the f32
    factor cannot be refined: the chunk escalates each of its points to
    the shifted GMRES solve, inside a ``banded.escalate`` span, and the
    counter counts them. GMRES cannot converge at an exact eigenvalue
    either, so its restarts are capped to keep the test short."""
    c, t, wp = wg.synthesize_waveguide(48)
    lam = sl.eigh((c + c.T) * 0.5, -(t + t.T) * (0.5 * wg.GAMMA_SCALE),
                  eigvals_only=True)
    f_res = float(np.sqrt(lam[(lam > 3e9**2) & (lam < 5e9**2)][3]))
    cfg = pt.MorfemConfig(band_max_half=128, solve_chunk=1)
    small = wg.tiled_waveguide_system(
        np.array([3.3e9, f_res]), wg.WaveguideData(c, t, wp, wg.KTE_DEFAULT,
                                                   True), 4, cfg, device=CPU)
    calls, real = [], bt.shifted_gmres_solve

    def shifted(op, c_i, rhs, **k):
        calls.append(float(c_i[2]))
        return real(op, c_i, rhs, **{**k, "maxiter": 2})

    monkeypatch.setattr(bt, "shifted_gmres_solve", shifted)
    timer = PhaseTimer(trace=True)
    gsm = wg.full_order_gsm(small, cfg, timer)
    assert calls == [pytest.approx(f_res**2)]
    assert bt.solve_sweep_banded.escalations == 1
    assert timer.counts["banded.escalate"] == 1
    esc = next(i for i, s in enumerate(timer.spans)
               if s.name == "banded.escalate")
    assert timer.spans[timer.spans[esc].parent].name == "banded.chunk"
    assert torch.isfinite(gsm[0]).all()


def test_a_gmres_route_pencil_sweeps_point_by_point(monkeypatch, data,
                                                    swept):
    """Below the reordered half-bandwidth the pencil takes the GMRES route
    (a `GeneralSparseOperator`); its sweep solves each point by
    `solve_point_iterative(method="general")`."""
    cfg = pt.MorfemConfig(band_max_half=254)
    sys_ = wg.tiled_waveguide_system(FREQS[:3], data, RATE, cfg, device=CPU)
    assert isinstance(sys_.op, GeneralSparseOperator)
    methods, real = [], sparse_ops.solve_point_iterative

    def solve(*a, **k):
        methods.append(k.get("method"))
        return real(*a, **k)

    monkeypatch.setattr(sparse_ops, "solve_point_iterative", solve)
    x = pt.solve_sweep(sys_, cfg)
    assert methods == ["general"] * 3
    assert _rel(x, swept[:3]) <= 1e-9
    assert bt.solve_sweep_banded.chunk_iterations == []


def test_the_sweep_s_spans_and_counters(prepared, swept):
    timer = PhaseTimer(trace=True)
    gsm = wg.full_order_gsm(prepared, CFG, timer)
    steps = bt.solve_sweep_banded.chunk_iterations
    assert len(steps) == 2 and all(s >= 1 for s in steps)
    assert bt.solve_sweep_banded.escalations == 0
    cnt = timer.counts
    assert cnt["banded.chunk"] == cnt["banded.factor"] == 2
    assert cnt["banded.refine"] == sum(steps)
    assert "banded.escalate" not in cnt
    # per chunk: the coupling counts, ‖b‖, the first residual, each pass
    assert cnt[timing.HOST_SYNC] == 2 * 3 + sum(steps)

    def children(name):
        return {s.name for s in timer.spans if s.parent is not None
                and timer.spans[s.parent].name == name}

    assert children("full-order sweep") == {"banded.chunk"}
    assert children("banded.chunk") == {"banded.factor", "banded.refine",
                                        timing.HOST_SYNC}
    # one inversion a block step of each chunk's factor
    assert cnt["banded.invert"] == 2 * 10
    assert children("banded.factor") == {timing.HOST_SYNC, "banded.invert"}
    assert timing.HOST_SYNC in children("banded.refine")
    for name in ("banded.chunk", "banded.factor", "banded.refine"):
        assert timer.times[name] == pytest.approx(
            sum(s.device_s for s in timer.spans if s.name == name))
    # trace mode changes no number
    assert torch.equal(gsm, wg.full_order_gsm(prepared, CFG))


def test_the_sweep_inverts_each_step_s_points_together(prepared):
    """A chunk of 8 points (the 9th point's chunk padded to 8) inverts its
    Schur complements 8 at a time at each of its 10 block steps; chunks of
    one point invert each alone (`inv_ex`)."""
    bt.reset_factor_counters()
    pt.solve_sweep(prepared.with_domain(prepared.domain[:9]), CFG)
    assert bt.block_tridiag_factor.batched_inverses == [8] * 20
    bt.reset_factor_counters()
    pt.solve_sweep(prepared.with_domain(prepared.domain[:2]),
                   CFG.replace(solve_chunk=1))
    assert bt.block_tridiag_factor.batched_inverses == []
    assert len(bt.solve_sweep_banded.chunk_iterations) == 2 + 2


def test_the_sweep_keeps_the_prepared_knobs_and_coefficients(prepared):
    with pytest.raises(ValueError, match="band_max_half"):
        pt.solve_sweep(prepared, CFG.replace(band_max_half=512))
    t = prepared.domain[:3]
    c, cb = prepared.coefficients(t)
    assert torch.equal(c, torch.stack([torch.ones_like(t), t, t * t], -1))
    assert torch.equal(cb, wg.b_coefficient(t, wg.KTE_DEFAULT))
    assert prepared.op.nonzero_addends == (0, 2)  # a1 is all zero


@pytest.mark.parametrize("sparse", [False, True])
def test_morfem_names_the_missing_arguments(sparse):
    a0 = sp.identity(4, format="csr") if sparse else np.eye(4)
    with pytest.raises(TypeError, match="'a1', 'a2', 'b'"):
        pt.morfem(np.linspace(1.0, 2.0, 3), a0, device=CPU)
    with pytest.raises(TypeError, match="missing 1 .*'b'"):
        pt.morfem(np.linspace(1.0, 2.0, 3), a0, a0, a0, device=CPU)
