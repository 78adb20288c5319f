"""The tiled waveguide (upstream ``fake_interpolate_bigger_sample.py``) on
the port's matrix-free route, at a small size on the CPU: a synthesized,
calibrated waveguide of 200 DOF tiled 4× as SciPy-sparse matrices, with
``dense_cutoff`` and ``band_max_half`` set so that it takes the banded
direct route.

A `MatfreeSystem` prepared once gives what one-shot `morfem()` gives on
the same matrices, bit for bit, through every entry that takes it; its
GSM agrees with the benchmark's plain float64 reference and with the
dense route; the spans of the matrix-free greedy and the banded solve
form their tree; and the benchmark configuration's input maker refuses a
file that is not the one it names.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps import waveguide as wg
from morfem_tpu_torch.ops import block_tridiag as bt
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.ops.sparse import GeneralSparseOperator
from morfem_tpu_torch.utils import timing
from morfem_tpu_torch.utils.timing import PhaseTimer

from benchmark.harness import registry

CPU = "cpu"
N_BLOCK, RATE = 200, 4
CFG = pt.MorfemConfig(error_threshold=1e-6, dense_cutoff=256,
                      band_max_half=256)
FREQS = np.linspace(3e9, 5e9, 100)
CONFIG_34110 = registry.find_cell("waveguide_34110.mor_sparse").config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    c, t, wp = wg.synthesize_waveguide(N_BLOCK)
    wp = wg.calibrate_port_amplitude(c, t, wp)
    return wg.WaveguideData(c, t, wp, wg.KTE_DEFAULT, True)


def _t_b(t):
    return wg.b_coefficient(t, wg.KTE_DEFAULT)


@pytest.fixture(scope="module")
def one_shot(data):
    """`morfem()` on the tiled pencil's SciPy matrices."""
    return pt.morfem(FREQS, *wg.tiled_waveguide_pencil(data, RATE), t_b=_t_b,
                     config=CFG, device=CPU)


@pytest.fixture(scope="module")
def prepared(data):
    """The tiled waveguide prepared on another grid than `FREQS`."""
    return wg.tiled_waveguide_system(FREQS + 3e6, data, RATE, CFG, device=CPU)


def _config_module():
    return registry.load_module(
        registry.BENCH_DIR / "configs" / "waveguide_34110.py",
        "bench_config_waveguide_34110")


def test_the_pencil_is_the_waveguide_tiled_along_the_diagonal(data):
    c, z, gamma, b = wg.tiled_waveguide_pencil(data, RATE)
    n = N_BLOCK * RATE
    assert all(sp.issparse(x) for x in (c, z, gamma))
    assert c.shape == z.shape == gamma.shape == (n, n) and z.nnz == 0
    assert b.shape == (n, 2)
    for k in range(RATE):
        rows = slice(k * N_BLOCK, (k + 1) * N_BLOCK)
        assert np.array_equal(c[rows, rows].toarray(), data.c_mat)
        # Γ in its own slot, not C again (the upstream script's slip)
        assert np.array_equal(gamma[rows, rows].toarray(),
                              data.t_mat * wg.GAMMA_SCALE)
        assert np.array_equal(b[rows], data.wp * wg.B_SCALE)
    assert c.nnz == RATE * np.count_nonzero(data.c_mat)


@pytest.mark.parametrize("band_max_half, route", [
    (256, BandedAffineOperator), (128, GeneralSparseOperator)])
def test_routing_by_the_reordered_bandwidth(data, band_max_half, route):
    """RCM keeps each dense block contiguous: half-bandwidth N_BLOCK − 1.
    At or above it the banded direct route, below it (`BandwidthError`)
    the truncated-band GMRES route, as `morfem()` routes."""
    cfg = CFG.replace(band_max_half=band_max_half)
    sys_ = wg.tiled_waveguide_system(FREQS, data, RATE, cfg, device=CPU)
    assert isinstance(sys_.op, route)
    if route is BandedAffineOperator:
        assert sys_.op.half == N_BLOCK - 1
    assert (sys_.n, sys_.m) == (N_BLOCK * RATE, 2)
    assert torch.equal(torch.sort(sys_.perm).values,
                       torch.arange(sys_.n))


@pytest.mark.parametrize("entry", ["morfem", "build_reduced_model",
                                   "mor_gsm"])
def test_the_prepared_system_equals_one_shot_morfem(one_shot, prepared,
                                                    entry):
    x1, q1, r0, r1, r2, b_r = one_shot
    sys_ = prepared.with_domain(FREQS)
    if entry == "morfem":
        got = pt.morfem(FREQS, prepared, config=CFG)
        assert all(torch.equal(a, b) for a, b in zip(got, one_shot))
    elif entry == "build_reduced_model":
        rm, res = pt.build_reduced_model(sys_, CFG)
        assert res.converged and not res.failed_snapshot
        for a, b in ((rm.q, q1), (rm.r0, r0), (rm.r1, r1), (rm.r2, r2),
                     (rm.b_r, b_r)):
            assert torch.equal(a, b)
    else:
        gsm, rm, res = wg.mor_gsm(sys_, CFG)
        assert res.converged and torch.equal(rm.q, q1)
        _, cb = rm.coefficients(rm.domain)
        want = wg.generalized_scattering_matrix(
            rm.domain, x1, cb[:, None, None] * b_r)
        assert torch.equal(gsm, want)


def test_the_greedy_converges_and_matches_the_plain_reference(data,
                                                             prepared):
    """The GSM of the matrix-free route against the benchmark's plain
    float64 reference (one dense solve of the whole tiled pencil a point)
    and against the dense route on the same pencil. Past the greedy's
    1e-6 the GSM sits ~1e-13 from the full-order one (≤ 5.5e-12 at
    N = 34,110 on the card, where the float32 reference reads 3.2e-5 and
    more); 1e-9 leaves room for another thread count's summation order."""
    gsm, rm, res = wg.mor_gsm(prepared.with_domain(FREQS), CFG)
    assert res.converged and not res.failed_snapshot
    assert res.ncols < 2 * (2 + CFG.max_greedy_iterations)
    mod = _config_module()
    ref = mod.tiled_gsm(data.c_mat, data.t_mat, data.wp, data.kte, RATE,
                        FREQS, torch.float64, CPU)
    assert np.max(np.abs(gsm.numpy() - ref)) < 1e-9
    c, z, gamma, b = (x.toarray() if sp.issparse(x) else x
                      for x in wg.tiled_waveguide_pencil(data, RATE))
    dense = pt.AffineSystem.create(FREQS, c, z, gamma, b, t_b=_t_b,
                                   device=CPU)
    gsm_d, _, res_d = wg.mor_gsm(dense, CFG)
    assert res_d.converged
    assert np.max(np.abs(gsm.numpy() - gsm_d.numpy())) < 1e-9


def test_the_prepared_system_keeps_its_operator_knobs(prepared):
    with pytest.raises(ValueError, match="band_max_half"):
        pt.build_reduced_model(prepared, CFG.replace(band_max_half=512))
    with pytest.raises(ValueError, match="symmetrize"):
        pt.build_reduced_model(prepared, CFG.replace(symmetrize=False))
    with pytest.raises(ValueError, match="carries its operators"):
        pt.morfem(FREQS, prepared, b=np.ones((prepared.n, 2)), config=CFG)
    with pytest.raises(ValueError, match="coefficients"):
        pt.morfem(FREQS, prepared, t_b=_t_b, config=CFG)


def _spy_solves(monkeypatch, spoil_first=False):
    """Record each banded direct solve's refinement passes; with
    `spoil_first`, report the first one as unconverged so that the greedy
    escalates it."""
    log = {"passes": [], "escalations": 0}
    real_solve, real_shifted = bt.banded_direct_solve, bt.shifted_gmres_solve

    def solve(*a, **k):
        x, relres, it = real_solve(*a, **k)
        log["passes"].append(it)
        if spoil_first and len(log["passes"]) == 1:
            relres = relres + 1.0
        return x, relres, it

    def shifted(*a, **k):
        log["escalations"] += 1
        return real_shifted(*a, **k)

    monkeypatch.setattr(bt, "banded_direct_solve", solve)
    monkeypatch.setattr(bt, "shifted_gmres_solve", shifted)
    return log


def _children(timer, parent_name):
    return {s.name for s in timer.spans if s.parent is not None
            and timer.spans[s.parent].name == parent_name}


def test_the_matfree_spans_form_their_tree(monkeypatch, prepared):
    log = _spy_solves(monkeypatch)
    timer = PhaseTimer(trace=True)
    gsm, _, res = wg.mor_gsm(prepared.with_domain(FREQS), CFG, timer)
    c = timer.counts
    solves = len(log["passes"])
    assert log["escalations"] == 0 and "greedy.escalate" not in c
    assert c["greedy.solve"] == c["banded.factor"] == solves >= 3
    assert c["banded.refine"] == sum(log["passes"])
    # two seed passes, then one pass per estimator evaluation
    assert c["greedy.iteration"] == res.iterations + 2
    assert c["greedy.estimate"] in (res.iterations, res.iterations + 1)
    assert c["greedy.dependency"] == solves - 2
    assert _children(timer, "projection base") == {"greedy.iteration"}
    assert _children(timer, "greedy.iteration") >= {
        "greedy.solve", "greedy.estimate", "greedy.dependency",
        "greedy.orthonormalize", timing.HOST_SYNC}
    assert _children(timer, "greedy.solve") == {
        "banded.factor", "banded.refine", timing.HOST_SYNC}
    assert timing.HOST_SYNC in _children(timer, "banded.refine")
    assert {"greedy.dependency", "greedy.estimate"} <= {
        timer.spans[s.parent].name for s in timer.spans
        if s.name == timing.HOST_SYNC}
    roots = [s for s in timer.spans if s.parent is None]
    assert [s.name for s in roots] == ["mor_gsm"]
    for name in ("banded.factor", "banded.refine", "greedy.solve"):
        assert timer.times[name] == pytest.approx(
            sum(s.device_s for s in timer.spans if s.name == name))
    # trace mode changes no number
    assert torch.equal(gsm, wg.mor_gsm(prepared.with_domain(FREQS), CFG)[0])


def test_an_escalated_snapshot_has_its_span(monkeypatch, prepared):
    log = _spy_solves(monkeypatch, spoil_first=True)
    timer = PhaseTimer(trace=True)
    _, _, res = wg.mor_gsm(prepared.with_domain(FREQS), CFG, timer)
    assert res.converged and log["escalations"] == 1
    assert timer.counts["greedy.escalate"] == 1
    esc = next(i for i, s in enumerate(timer.spans)
               if s.name == "greedy.escalate")
    assert timer.spans[timer.spans[esc].parent].name == "greedy.solve"
    assert any(s.parent == esc and s.name == timing.HOST_SYNC
               for s in timer.spans)


def _small_config(**change):
    cfg = dict(CONFIG_34110, n=256, fingerprint=None,
               data="data/synthetic_cache/synthetic_wg_256.npz")
    cfg.update(change)
    return cfg


def test_the_config_s_input_maker_takes_its_file():
    mod = _config_module()
    inp = mod.make_inputs(_small_config(), registry.ROOT)
    assert inp["c"].shape == (256, 256) and inp["wp"].shape == (256, 2)
    assert inp["rate"] == 10 and inp["kte"] == CONFIG_34110["kte"]
    fp = mod.waveguide_3411.fingerprint(inp["c"], inp["t"], inp["wp"])
    again = mod.make_inputs(_small_config(fingerprint=fp), registry.ROOT)
    assert np.array_equal(again["c"], inp["c"])


@pytest.mark.parametrize("change, match", [
    (dict(fingerprint=CONFIG_34110["fingerprint"]), "fingerprint"),
    (dict(n=300), "shapes"),
    (dict(m=3), "shapes"),
    (dict(rate=0), "rate"),
])
def test_the_config_s_input_maker_refuses_another_file(change, match):
    with pytest.raises(ValueError, match=match):
        _config_module().make_inputs(_small_config(**change), registry.ROOT)


def test_the_config_is_the_published_size():
    cfg = CONFIG_34110
    assert cfg["n"] * cfg["rate"] == cfg["n_total"] == 34110
    assert (cfg["m"], cfg["points"], cfg["reduced"]) == (2, 100, [])
    assert cfg["morfem"] == {"error_threshold": 1e-6, "band_max_half": 3456}
    # the smallest multiple of 128 at or above the reordered half-bandwidth
    assert cfg["morfem"]["band_max_half"] == -(-(cfg["n"] - 1) // 128) * 128


def test_with_domain_keeps_the_prepared_operator(prepared):
    moved = prepared.with_domain(FREQS[:10])
    assert moved.op is prepared.op and moved.perm is prepared.perm
    assert torch.equal(moved.domain, torch.as_tensor(FREQS[:10]))
    assert torch.equal(moved.b, prepared.b) and moved.mats is prepared.mats
