"""The port's PhaseTimer against the JAX package's, on the CPU.

The same phase sequences go through `morfem_tpu.PhaseTimer` and
`morfem_tpu_torch.PhaseTimer`: the same buckets, the same dict and the
same report lines, the reference's positional order
``PhaseTimer(disabled, trace)``, and ``trace=True`` phases as named
ranges in a `torch.profiler` trace. Then `morfem()` of both packages,
with an enabled timer, on the same small seeded systems (made with
numpy): the same phase keys on the real routes, and on the complex
routes exactly the differences that `morfem_tpu_torch/NUMERICS.md`
records (row 31 and the phase rows).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import morfem_tpu as mt
from morfem_tpu.mor import api as jax_api

import morfem_tpu_torch as pt

CPU = "cpu"
REPORT_LINE = re.compile(r"^(.+): (\d+\.\d{3}) s \| (\d+\.\d{2})%$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(timer):
    """One phase sequence: a repeated phase, a nested one, an added one."""
    for _ in range(2):
        with timer.phase("offline"):
            with timer.phase("inner"):
                sum(range(1000))
    with timer.phase("online"):
        pass
    timer.add("added", 0.25)
    return timer


def _report_lines(timer):
    lines = timer.report().splitlines()
    parsed = [REPORT_LINE.match(line) for line in lines]
    assert all(parsed), lines
    return [m.group(1) for m in parsed]


def test_phase_timer_records_what_the_reference_records():
    port, ref = _drive(pt.PhaseTimer()), _drive(mt.PhaseTimer())
    assert list(port.times) == list(ref.times) == [
        "inner", "offline", "online", "added"]
    assert list(port.as_dict()) == list(ref.as_dict())
    assert port.as_dict()["added"] == ref.as_dict()["added"] == 0.25
    assert port.times["offline"] >= port.times["inner"] > 0
    assert _report_lines(port) == _report_lines(ref) == [
        "whole", "inner", "offline", "online", "added"]


@pytest.mark.parametrize("args,kwargs", [
    ((), {}),
    ((True,), {}),
    ((False, True), {}),
    ((), {"trace": True}),
    ((True, True), {}),
])
def test_positional_order_is_the_reference_s(args, kwargs):
    port, ref = pt.PhaseTimer(*args, **kwargs), mt.PhaseTimer(*args, **kwargs)
    assert (port.disabled, port.trace) == (ref.disabled, ref.trace)
    assert port.device is None


def test_device_is_a_keyword():
    assert pt.PhaseTimer(device="cpu").device == torch.device("cpu")
    with pytest.raises(TypeError):
        pt.PhaseTimer(False, False, "cpu")


def _profiled_names(timer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(timer)
    return [e.name for e in prof.events()]


@pytest.mark.parametrize("mode", ["trace", "plain", "disabled"])
def test_trace_mode_names_each_phase_in_a_profiler_trace(mode):
    timer = pt.PhaseTimer(disabled=mode == "disabled", trace=mode == "trace")
    names = _profiled_names(timer)
    phases = ("offline", "inner", "online")
    if mode == "trace":
        assert [names.count(p) for p in phases] == [2, 2, 1]
        assert list(timer.times) == ["inner", "offline", "online", "added"]
    else:
        assert not set(phases) & set(names)
    if mode == "disabled":
        assert timer.times == {"added": 0.25}  # add() still adds


class _Recorder:
    def __init__(self):
        self.calls = []

    def sync(self, device=None):
        self.calls.append(("sync", device))

    def nvtx(self, name):
        self.calls.append(("nvtx", name))
        return torch.profiler.record_function(f"nvtx:{name}")


@pytest.mark.parametrize("disabled,trace,device,expected", [
    # an enabled phase synchronises before it starts and before it ends:
    # the given device, or the current one once CUDA is initialised
    (False, False, None, [("sync", None)] * 2),
    (False, False, "cuda:0", [("sync", torch.device("cuda:0"))] * 2),
    (False, False, "cpu", []),
    # a disabled timer synchronises nothing and opens no range
    (True, False, None, []),
    (True, True, "cuda:0", []),
    # trace mode adds an NVTX range where CUDA is available, and the
    # closing synchronisation falls inside it
    (False, True, None, [("sync", None), ("nvtx", "p"), ("sync", None)]),
])
def test_phases_wait_for_the_card(monkeypatch, disabled, trace, device,
                                  expected):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", rec.sync)
    monkeypatch.setattr(torch.cuda.nvtx, "range", rec.nvtx)
    timer = pt.PhaseTimer(disabled, trace, device=device)
    with timer.phase("p"):
        pass
    assert rec.calls == expected
    assert ("p" in timer.times) is not disabled


def test_no_synchronisation_before_cuda_is_initialised(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", rec.sync)
    with pt.PhaseTimer().phase("p"):
        pass
    assert rec.calls == []


# -- morfem()'s phases in both packages -------------------------------------

def _dense_real(n=96, seed=9):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    a0 = (g + g.T) * 0.5 + 6.0 * np.eye(n)
    return a0, np.zeros((n, n)), -np.eye(n), rng.standard_normal((n, 2))


def _dense_complex(n=96, seed=9):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a0 = (g + g.T) * 0.5 + (6.0 + 1.5j) * np.eye(n)
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return a0, np.zeros((n, n)) + 0j, -np.eye(n) + 0j, b


def _banded(n=400, seed=7, complex_=False):
    """Helmholtz-like banded pencil, SciPy sparse (the matrix-free routes
    above dense_cutoff=128)."""
    rng = np.random.default_rng(seed)
    shift = 0.4j if complex_ else 0.0
    off = (-0.3 + (0.05j if complex_ else 0.0)) * np.ones(n - 1)
    a0 = sp.diags([off, 8.0 + rng.random(n) + shift, off], [-1, 0, 1]).tocsr()
    a1 = sp.csr_matrix((n, n))
    a2 = (sp.eye(n) * -1.0).tocsr()
    b = rng.standard_normal((n, 2))
    if complex_:
        b = b + 1j * rng.standard_normal((n, 2))
    return a0, a1, a2, b


def _keys(run, **kw):
    timer = run.PhaseTimer()
    run.morfem(*kw.pop("args"), config=run.MorfemConfig(**kw.pop("cfg")),
               timer=timer, **kw)
    return set(timer.times)


@pytest.mark.parametrize("route", ["dense", "matfree"])
def test_real_routes_record_the_reference_s_phases(route):
    domain = np.linspace(0.8, 1.6, 12)
    if route == "dense":
        ops = _dense_real()
        cfg = dict(error_threshold=1e-10, max_greedy_iterations=20)
        expected = {"projection base", "projection", "reduced sweep"}
    else:
        ops = _banded()
        cfg = dict(error_threshold=1e-10, dense_cutoff=128)
        expected = {"operator setup", "projection base", "reduced sweep"}
    port = _keys(pt, args=(domain, *ops), cfg=cfg, device=CPU)
    ref = _keys(mt, args=(domain, *ops), cfg=cfg)
    assert port == ref == expected


def test_matfree_complex_route_does_not_sweep_the_embedded_model():
    # the reference sweeps the embedded real model inside its matrix-free
    # route and discards the result (morfem_tpu/mor/api.py:428-436); the
    # port builds it and does not sweep it (NUMERICS.md row 31)
    domain = np.linspace(0.8, 2.0, 12)
    cfg = dict(symmetrize=False, dense_cutoff=128, error_threshold=1e-10)
    ops = _banded(complex_=True)
    port = _keys(pt, args=(domain, *ops), cfg=cfg, device=CPU)
    ref = _keys(mt, args=(domain, *ops), cfg=cfg)
    assert port == {"operator setup", "projection base",
                    "complex reduced model"}
    assert ref - port == {"reduced sweep"} and port <= ref


@pytest.mark.parametrize("case", ["complex_operators", "complex_t_a0"])
def test_dense_complex_route_records_the_reference_s_cpu_phases(case):
    # the port runs complex dense systems natively in complex128, as the
    # reference does on the CPU; on the TPU the reference takes the real
    # 2N embedding (complex operators) or pins the pipeline to the CPU
    # (complex coefficients) instead (morfem_tpu/mor/api.py:245-280)
    domain = np.linspace(0.8, 1.6, 12)
    cfg = dict(symmetrize=False, error_threshold=1e-10,
               max_greedy_iterations=20)
    if case == "complex_operators":
        ops, ft, fj = _dense_complex(), {}, {}
        tpu_route = jax_api._morfem_embedded_dense
    else:
        ops = _dense_real()
        ft = dict(t_a0=lambda t: torch.exp(1j * 0.2 * t))
        fj = dict(t_a0=lambda t: jnp.exp(1j * 0.2 * t))
        tpu_route = jax_api._morfem_dense_on_cpu
    port = _keys(pt, args=(domain, *ops), cfg=cfg, device=CPU, **ft)
    ref_cpu = _keys(mt, args=(domain, *ops), cfg=cfg, **fj)
    assert port == ref_cpu == {"projection base", "projection",
                               "reduced sweep"}
    fns = [fj.get(k, getattr(jax_api, f"_default_{k}"))
           for k in ("t_a0", "t_a1", "t_a2", "t_b")]
    timer = mt.PhaseTimer()
    tpu_route(domain, *ops, *fns, mt.MorfemConfig(**cfg), timer)
    if case == "complex_operators":
        assert set(timer.times) ^ port == {"reduced sweep",
                                           "complex reduced model"}
    else:
        assert set(timer.times) == port
