"""The equally-distributed basis on a prepared sparse pencil
(`mor/api.py::build_matfree` → `mor/equally.py::matfree_seed_basis` and
`MatfreeSystem.project`), at a small size on the CPU: the synthesized
waveguide block of N=256 tiled 3× (N=768) as SciPy-sparse matrices,
prepared with ``band_max_half`` at the block's half-bandwidth (255)
rounded up to 128, swept over upstream's 100 points with upstream's rate
0.97, so 3 seeds.

The GSM agrees with the benchmark's plain reference of the same
construction (`benchmark/configs/waveguide_34110_equally.py`), which the
reference run in float32 does not; the reduced matrices are
`sparse_project`'s on the addends as passed, a non-symmetric one too; the
seeds go through one chunk of the banded sweep; a second call does no
SciPy indexing and no CSR conversion; the GMRES route still builds the
model; and the spans and the seed counter are recorded.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse._index as sp_index
import torch

import morfem_tpu_torch as pt
from morfem_tpu_torch.apps import waveguide as wg
from morfem_tpu_torch.mor import equally
from morfem_tpu_torch.ops import block_tridiag as bt
from morfem_tpu_torch.ops import sparse as sparse_ops
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.ops.sparse import GeneralSparseOperator, sparse_project
from morfem_tpu_torch.utils import timing
from morfem_tpu_torch.utils.timing import PhaseTimer

from benchmark.harness import registry

CPU = "cpu"
N_BLOCK, RATE = 256, 3
CFG = pt.MorfemConfig(band_max_half=256, use_equally_distributed=True,
                      equally_distributed_reduction_rate=0.97)
FREQS = np.linspace(3e9, 5e9, 100)
# the benchmark configuration's grid and rate, at this size
CONFIG = {"lo_hz": 3e9, "hi_hz": 5e9, "points": 100,
          "morfem": {"equally_distributed_reduction_rate": 0.97}}
# |ΔS| of the GSM, whose entries are O(1). The seeds refine to 10·ε·‖b‖,
# where x is accurate to ~cond·ε (~1e-12 on this pencil), and the 6×6
# reduced model carries that over: the program reads ≤ 1e-11 here. One
# step of the construction in float32 (the reference's float32 control)
# reads ~1e-4, and an unrefined f32 seed solve ~1e-5.
GSM_TOL = 1e-9
# the reduced matrices against `sparse_project`'s, relative to their
# largest entry: both are f64 products of the same numbers, summed in
# another order (the band's blocks against CSR rows)
PROJECT_TOL = 1e-12


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
    bt.reset_factor_counters()
    equally.reset_matfree_seed_counters()


@pytest.fixture(scope="module")
def data():
    c, t, wp = wg.synthesize_waveguide(N_BLOCK)
    wp = wg.calibrate_port_amplitude(c, t, wp)
    return wg.WaveguideData(c, t, wp, wg.KTE_DEFAULT, True)


@pytest.fixture(scope="module")
def prepared(data):
    return wg.tiled_waveguide_system(FREQS, data, RATE, CFG, device=CPU)


def _t_b(t):
    return wg.b_coefficient(t, wg.KTE_DEFAULT)


def _config_module():
    return registry.load_module(
        registry.BENCH_DIR / "configs" / "waveguide_34110_equally.py",
        "bench_config_waveguide_34110_equally")


def _reference(data, freqs, dtype):
    inputs = {"c": data.c_mat, "t": data.t_mat, "wp": data.wp,
              "kte": data.kte, "rate": RATE}
    kind, gsm = _config_module().reference(CONFIG, freqs, dtype, CPU, inputs)
    assert kind == "gsm_err"
    return gsm


def _nonsymmetric_pencil(data):
    """The tiled pencil with a0 made non-symmetric inside the band: C plus
    a strictly upper part of 1e-3 of its scale."""
    c, z, g, b = wg.tiled_waveguide_pencil(data, RATE)
    rng = np.random.default_rng(5)
    n = c.shape[0]
    upper = sp.random(n, n, density=0.002, random_state=rng, format="csr")
    upper = sp.triu(upper, k=1).tocsr()
    keep = sp.csr_matrix(np.ones((N_BLOCK, N_BLOCK)))
    upper = upper.multiply(sp.block_diag([keep] * RATE)).tocsr()
    scale = 1e-3 * abs(c).max()
    return (c + scale * upper).tocsr(), z, g, b


@pytest.mark.parametrize("shift_steps", [0.0, 0.375, -0.4583])
def test_the_route_matches_the_plain_reference(data, prepared, shift_steps):
    """On the grid shifted as the benchmark's mix shifts it."""
    step = (FREQS[-1] - FREQS[0]) / (len(FREQS) - 1)
    freqs = FREQS + shift_steps * step
    gsm, rm, res = wg.mor_gsm(prepared.with_domain(freqs), CFG)
    assert res is None and rm.q.shape == (N_BLOCK * RATE, 6)
    checked = [0, 13, 49, 50, 77, 99]
    ref = _reference(data, freqs[checked], "float64")
    err = np.abs(gsm.numpy()[checked] - ref).max()
    assert err <= GSM_TOL
    # the float32 control misses the tolerance by orders of magnitude
    control = _reference(data, freqs[checked], "float32")
    assert np.abs(control - ref).max() > 1e3 * GSM_TOL
    # between the seeds the reduced model is not the full-order one: the
    # check compares like with like
    full = registry.load_module(
        registry.BENCH_DIR / "configs" / "waveguide_34110.py",
        "bench_config_waveguide_34110").tiled_gsm(
        data.c_mat, data.t_mat, data.wp, data.kte, RATE, freqs[checked],
        torch.float64, CPU)
    assert np.abs(full - ref).max() > 1e3 * GSM_TOL


def test_the_seeds_are_upstream_s_and_go_through_one_chunk(monkeypatch,
                                                           prepared):
    chunks = []
    real = bt._solve_chunk

    def spy(sys_, ts, n_real, config):
        chunks.append((ts.clone(), n_real))
        return real(sys_, ts, n_real, config)

    monkeypatch.setattr(bt, "_solve_chunk", spy)
    wg.mor_gsm(prepared.with_domain(FREQS), CFG)
    ((domain, n_real),) = chunks  # one chunk of 3, no padding
    assert n_real == 3
    want = _config_module().seed_points(FREQS, 0.97)
    assert np.array_equal(domain.numpy(), want)
    assert np.array_equal(want, FREQS[[0, 49, 99]])
    assert len(bt.solve_sweep_banded.chunk_iterations) == 1
    # each of the 3 block steps inverts the 3 seeds' complements together
    assert bt.block_tridiag_factor.batched_inverses == [3] * RATE
    assert equally.matfree_seed_basis.seeds == [3]


def _projected(sys_, q_op, raw=True):
    """`sparse_project` on the system's addends as passed (``raw``) or
    symmetrised, permuted into the operator's row order."""
    p = sys_.perm.numpy()
    mats = [m.tocsr() for m in sys_.mats]
    if not raw:
        mats = [(m + m.T) * 0.5 for m in mats]
    return sparse_project([m[p][:, p] for m in mats], sys_.b, q_op)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("pencil", ["symmetric", "nonsymmetric"])
def test_the_reduced_matrices_are_sparse_project_s(data, prepared, pencil):
    """r_p = Qᵀ·A_p·Q of each addend as the caller passed it, also where
    the operator symmetrised a non-symmetric addend (NUMERICS.md)."""
    sys_ = prepared
    if pencil == "nonsymmetric":
        sys_ = pt.MatfreeSystem.create(FREQS, *_nonsymmetric_pencil(data),
                                       t_b=_t_b, config=CFG, device=CPU)
    rm, _ = pt.build_reduced_model(sys_, CFG)
    q_op = rm.q[sys_.perm]
    (r0, r1, r2), b_r = _projected(sys_, q_op)
    for got, want in ((rm.r0, r0), (rm.r2, r2), (rm.b_r, b_r)):
        assert _rel(got, want) <= PROJECT_TOL
    assert torch.equal(rm.r1, torch.zeros_like(r1))
    _, skews = sys_._projection_storage()
    if pencil == "symmetric":
        assert skews == {}
        return
    assert set(skews) == {0}  # a0 alone is not symmetric
    (s0, _, s2), _ = _projected(sys_, q_op, raw=False)
    assert _rel(rm.r0, s0) > 1e3 * PROJECT_TOL  # not the symmetrised one
    assert _rel(rm.r2, s2) <= PROJECT_TOL


@pytest.mark.parametrize("pencil", ["symmetric", "nonsymmetric"])
def test_a_second_call_does_no_host_work_on_the_addends(monkeypatch, data,
                                                        pencil):
    """The first call prepares what the projection needs (a CSR upload
    of the antisymmetric part of a non-symmetric addend alone); later
    calls, re-gridded, index no SciPy matrix and convert none."""
    if pencil == "symmetric":
        sys_ = wg.tiled_waveguide_system(FREQS, data, RATE, CFG, device=CPU)
    else:
        sys_ = pt.MatfreeSystem.create(FREQS, *_nonsymmetric_pencil(data),
                                       t_b=_t_b, config=CFG, device=CPU)
    counts = {"index": 0, "to_csr": 0}
    getitem, to_csr = sp_index.IndexMixin.__getitem__, sparse_ops.to_csr

    def counting_getitem(self, key):
        counts["index"] += 1
        return getitem(self, key)

    def counting_to_csr(*a, **k):
        counts["to_csr"] += 1
        return to_csr(*a, **k)

    monkeypatch.setattr(sp_index.IndexMixin, "__getitem__", counting_getitem)
    monkeypatch.setattr(sparse_ops, "to_csr", counting_to_csr)
    first = wg.mor_gsm(sys_.with_domain(FREQS), CFG)[0]
    assert counts["to_csr"] == (0 if pencil == "symmetric" else 1)
    counts.update(index=0, to_csr=0)
    second = wg.mor_gsm(sys_.with_domain(FREQS + 5e6), CFG)[0]
    assert counts == {"index": 0, "to_csr": 0}
    assert not torch.equal(first, second)
    assert len(bt.solve_sweep_banded.chunk_iterations) == 2  # one a call


def test_the_gmres_route_builds_the_model():
    """A pencil whose reordered band exceeds ``band_max_half`` (the
    truncated-band GMRES route: a scrambled banded waveguide, N=1,024)
    solves its seeds one at a time and projects on the same path; at each
    seed point the reduced solution is the full-order one."""
    from morfem_tpu_torch.mor.api import _run_sweep
    from morfem_tpu_torch.utils import synthetic

    n = 1024
    c, t, wp = synthetic.banded_waveguide_system(n, half=5, seed=0)
    scram = np.random.default_rng(3).permutation(n)
    cs = c.tocsr()[scram][:, scram]
    gs = (t * wg.GAMMA_SCALE).tocsr()[scram][:, scram]
    wps = np.asarray(wp)[scram]
    freqs = np.linspace(3e9, 5e9, 24)
    cfg = CFG.replace(band_max_half=4, equally_distributed_reduction_rate=0.75)
    sys_ = pt.MatfreeSystem.create(freqs, cs, sp.csr_matrix((n, n)), gs, wps,
                                   config=cfg, device=CPU)
    assert isinstance(sys_.op, GeneralSparseOperator)
    timer = PhaseTimer(trace=True)
    rm, res = pt.build_reduced_model(sys_, cfg, timer)
    assert res is None and rm.q.shape == (n, 12)  # 6 seeds, M=2
    assert bt.solve_sweep_banded.chunk_iterations == []
    assert equally.matfree_seed_basis.seeds == [6]
    assert timer.counts["equally.solve"] == timer.counts[
        "equally.project"] == 1
    (r0, _, r2), b_r = _projected(sys_, rm.q[sys_.perm])
    for got, want in ((rm.r0, r0), (rm.r2, r2), (rm.b_r, b_r)):
        assert _rel(got, want) <= PROJECT_TOL
    x = _run_sweep(rm, cfg)
    cd, gd = cs.toarray(), gs.toarray()
    for i in (0, 9, 23):  # seed points
        a_f = cd + gd * freqs[i] ** 2
        want = np.linalg.solve((a_f + a_f.T) / 2, wps * freqs[i])
        got = rm.q.numpy() @ x[i].numpy()
        # GMRES stops each seed at 1e-10 of ‖b‖
        assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)


def _children(timer, parent_name):
    return {s.name for s in timer.spans if s.parent is not None
            and timer.spans[s.parent].name == parent_name}


def test_the_spans_and_the_seed_counter(prepared):
    assert isinstance(prepared.op, BandedAffineOperator)
    timer = PhaseTimer(trace=True)
    gsm, _, _ = wg.mor_gsm(prepared.with_domain(FREQS), CFG, timer)
    c = timer.counts
    assert c["equally.solve"] == c["equally.project"] == 1
    assert c["banded.chunk"] == c["banded.factor"] == 1
    assert c["banded.refine"] == sum(bt.solve_sweep_banded.chunk_iterations)
    assert _children(timer, "projection base") == {"equally.solve",
                                                   "equally.project"}
    assert _children(timer, "equally.solve") == {"banded.chunk"}
    assert _children(timer, "banded.chunk") >= {"banded.factor",
                                                "banded.refine",
                                                timing.HOST_SYNC}
    assert _children(timer, "equally.project") == set()
    for name in ("equally.solve", "equally.project"):
        assert timer.times[name] == pytest.approx(
            sum(s.device_s for s in timer.spans if s.name == name))
    assert equally.matfree_seed_basis.seeds == [3]
    equally.reset_matfree_seed_counters()
    assert equally.matfree_seed_basis.seeds == []
    # trace mode changes no number
    assert torch.equal(gsm, wg.mor_gsm(prepared.with_domain(FREQS), CFG)[0])
