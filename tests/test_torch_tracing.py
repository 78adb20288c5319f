"""The port's spans (`morfem_tpu_torch/utils/timing.py`) on the CPU.

With no trace-mode timer open, `span` and `host_read` do nothing but run
the code: no range, event or synchronise, and the same numbers. A
trace-mode timer records one span per greedy iteration, snapshot solve,
refinement step, panel chunk and host read, in a tree under the entry
point's root span, on the clock of a `torch.profiler` trace; it
synchronises the card exactly where the phases did before, and exports
the spans as chrome-trace JSON.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import morfem_tpu_torch as pt
from morfem_tpu_torch.compat import system_from_numpy
from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.mor import greedy as greedy_mod
from morfem_tpu_torch.mor.greedy import greedy_basis
from morfem_tpu_torch.ops.panel_lu import (
    reset_sweep_counters,
    solve_sweep_panel,
)
from morfem_tpu_torch.system import AffineSystem
from morfem_tpu_torch.utils import timing
from morfem_tpu_torch.utils.synthetic import random_affine_system
from morfem_tpu_torch.utils.timing import PhaseTimer, host_read, span

CPU = "cpu"
GREEDY = MorfemConfig(error_threshold=1e-10, max_greedy_iterations=8)
PANEL = dict(factorization="panel", panel_width=128, solve_chunk=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _greedy_system(seed=3):
    return AffineSystem.create(*random_affine_system(
        seed, n=48, m=2, num_points=16, device=CPU), device=CPU)


def _panel_system(singular=False, n=256, seed=5):
    rng = np.random.default_rng(seed)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    if singular:
        a0[:128, :128] = 0.0  # block pivoting must escalate
    z = np.zeros((n, n))
    b = rng.standard_normal((n, 1))
    return system_from_numpy(np.array([1.0, 2.0, 3.0]), a0, z, z, b,
                             device=CPU)


def _run_greedy(timer=None):
    sys_ = _greedy_system()
    if timer is None:
        return greedy_basis(sys_, GREEDY)
    with timer.span("greedy_call"), timer.phase("projection base"):
        return greedy_basis(sys_, GREEDY)


def _run_panel(timer=None, singular=False):
    sys_ = _panel_system(singular)
    reset_sweep_counters()
    if timer is None:
        return solve_sweep_panel(sys_, MorfemConfig(**PANEL))
    with timer.span("sweep_call"), timer.phase("full-order sweep"):
        return solve_sweep_panel(sys_, MorfemConfig(**PANEL))


def _names(timer, name):
    return [s for s in timer.spans if s.name == name]


def _raise(*a, **k):
    raise AssertionError("the off path touched the profiler or the card")


@pytest.mark.parametrize("timer", [None, "plain", "disabled_trace"])
def test_off_path_is_one_shared_no_op(monkeypatch, timer):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    t = {None: None, "plain": PhaseTimer(trace=False),
         "disabled_trace": PhaseTimer(True, True)}[timer]
    noop = timing._NO_SPAN
    if t is not None:
        assert t.span("root") is noop
    ctx = t.phase("p") if t is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        assert span("a") is span("b") is noop
        with span("a") as inner:
            assert inner is None
        assert host_read(float, torch.tensor(2.5)) == 2.5
        res = greedy_basis(_greedy_system(), GREEDY)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    assert res.ncols > 0
    assert timing._active is None
    if t is not None:
        assert t.spans == [] and t.counts == {}
        assert set(t.times) <= {"p"}


@pytest.mark.parametrize("path", ["greedy", "panel"])
def test_trace_mode_gives_the_same_numbers_bit_for_bit(path):
    if path == "greedy":
        off, on = _run_greedy(), _run_greedy(PhaseTimer(trace=True))
        assert (off.ncols, off.iterations, off.converged) == (
            on.ncols, on.iterations, on.converged)
        assert torch.equal(off.q, on.q)
        assert torch.equal(off.err_hist, on.err_hist)
    else:
        off, on = _run_panel(), _run_panel(PhaseTimer(trace=True))
        assert torch.equal(off, on)


def test_greedy_spans_count_its_snapshots_and_iterations(monkeypatch):
    solves = []
    real = greedy_mod.solve_point

    def counted(*a, **k):
        solves.append(1)
        return real(*a, **k)

    monkeypatch.setattr(greedy_mod, "solve_point", counted)
    timer = PhaseTimer(trace=True)
    res = _run_greedy(timer)
    assert timer.counts["greedy.solve"] == len(solves) >= 3
    # two seed passes, then one pass per estimator evaluation
    assert timer.counts["greedy.iteration"] == res.iterations + 2
    assert timer.counts["greedy.estimate"] == res.iterations
    assert len(_names(timer, "greedy.solve")) == len(solves)
    # each snapshot refines; every estimate and pick reads back
    assert timer.counts["refine.step"] >= len(solves)
    assert timer.counts[timing.HOST_SYNC] >= 2 * res.iterations
    for name in ("greedy.solve", "greedy.estimate", "refine.step",
                 timing.HOST_SYNC):
        assert timer.times[name] == pytest.approx(
            sum(s.device_s for s in _names(timer, name)))


@pytest.mark.parametrize("singular", [False, True])
def test_panel_spans_count_chunks_steps_and_escalations(singular):
    timer = PhaseTimer(trace=True)
    _run_panel(timer, singular)
    its = solve_sweep_panel.chunk_iterations
    assert timer.counts["panel.chunk"] == len(its) == 2
    assert timer.counts["refine.step"] == sum(its)
    assert timer.counts.get("panel.escalate", 0) == (
        solve_sweep_panel.escalations) == (2 if singular else 0)
    # one factor and one first apply per factor tried
    assert timer.counts["panel.factor"] == timer.counts["panel.apply"] == (
        len(its) + solve_sweep_panel.escalations)
    # each chunk reads ‖b‖, then one residual norm before and one per step
    assert timer.counts[timing.HOST_SYNC] == (
        len(its) + timer.counts["panel.factor"] + sum(its))
    for esc in _names(timer, "panel.escalate"):
        kids = [s for s in timer.spans
                if s.parent is not None
                and timer.spans[s.parent] is esc]
        assert {"panel.factor", "panel.apply"} <= {s.name for s in kids}


def test_spans_form_one_tree_per_call():
    a0, a1, a2, b = _dense_real()
    timer = PhaseTimer(trace=True)
    for _ in range(2):
        pt.morfem(np.linspace(0.8, 1.6, 12), a0, a1, a2, b,
                  config=MorfemConfig(error_threshold=1e-10,
                                      max_greedy_iterations=20),
                  timer=timer, device=CPU)
    roots = [i for i, s in enumerate(timer.spans) if s.parent is None]
    assert [timer.spans[i].name for i in roots] == ["morfem", "morfem"]
    calls = {s.call for s in timer.spans}
    assert calls == set(roots)
    for i, s in enumerate(timer.spans):
        if s.parent is None:
            assert s.call == i
            continue
        parent = timer.spans[s.parent]
        assert s.parent < i and s.call == parent.call
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    phases = {s.name for s in timer.spans if s.phase}
    assert phases == {"projection base", "projection", "reduced sweep"}
    assert timer.counts["morfem"] == 2 and timer.counts["greedy.solve"] > 0
    assert all(s.device_s is not None for s in timer.spans)
    assert timing._active is None and timer._stack == []


def _dense_real(n=96, seed=9):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    a0 = (g + g.T) * 0.5 + 6.0 * np.eye(n)
    return a0, np.zeros((n, n)), -np.eye(n), rng.standard_normal((n, 2))


class _Card:
    """Stands in for the card: counts synchronises, NVTX ranges and timing
    events, each event pair reading 1 ms."""

    def __init__(self):
        self.syncs, self.records, self.nvtx = 0, 0, 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing

            def record(self, stream=None):
                assert stream is card.stream
                card.records += 1

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return 1.0

        self.Event = Event
        self.stream = object()
        self.stream_lookups = 0

    def current_stream(self, device=None):
        self.stream_lookups += 1
        return self.stream

    def sync(self, device=None):
        self.syncs += 1

    def push(self, name):
        self.nvtx += 1

    def pop(self):
        self.nvtx -= 1


def _on_a_card(monkeypatch, capturing=False):
    card = _Card()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", card.sync)
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", card.push)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", card.pop)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", card.current_stream)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    return card


@pytest.mark.parametrize("path", ["greedy", "panel"])
def test_trace_mode_adds_no_synchronise(monkeypatch, path):
    run = _run_greedy if path == "greedy" else _run_panel
    plain_card = _on_a_card(monkeypatch)
    run(PhaseTimer())
    card = _on_a_card(monkeypatch)
    timer = PhaseTimer(trace=True)
    run(timer)
    assert card.syncs == plain_card.syncs == 2  # the phase's own two
    inner = [s for s in timer.spans if s.parent is not None and not s.phase]
    timed = [s for s in inner if s.name != timing.HOST_SYNC]
    assert card.records == 2 * len(timed) > 0
    assert card.stream_lookups == 1  # one stream all along
    assert card.nvtx == 0  # every range pushed was popped
    # device times come from the events (1 ms a pair); the root's and the
    # host reads' are their host times
    assert all(s.device_s == pytest.approx(1e-3) for s in timed)
    untimed = [s for s in timer.spans if s.phase or s.parent is None
               or s.name == timing.HOST_SYNC]
    assert len(untimed) == len(timer.spans) - len(timed)
    assert all(s.device_s == s.host_s() for s in untimed)
    assert timer.times[timed[0].name] == pytest.approx(
        1e-3 * timer.counts[timed[0].name])


def test_no_events_while_a_graph_is_captured(monkeypatch):
    card = _on_a_card(monkeypatch, capturing=True)
    timer = PhaseTimer(trace=True)
    _run_greedy(timer)
    assert card.records == 0 and timer.counts["greedy.solve"] > 0
    assert all(s.device_s == s.host_s() for s in timer.spans)


def test_spans_share_the_profiler_s_clock(tmp_path):
    timer = PhaseTimer(trace=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_greedy(timer)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    for name, rs in ranges.items():
        rs.sort(key=lambda e: float(e["ts"]))
    seen = {}
    for s in timer.spans:
        r = ranges[s.name][seen.setdefault(s.name, 0)]
        seen[s.name] += 1
        start = base + round(float(r["ts"]) * 1e3)
        end = start + round(float(r["dur"]) * 1e3)
        # the span holds its range, within 1 ms at either end
        assert 0 <= start - s.start_ns < 1e6, s.name
        assert 0 <= s.end_ns - end < 1e6, s.name
    assert seen == {k: len(v) for k, v in ranges.items()}
    assert {"greedy.iteration", "greedy.solve", "refine.step",
            timing.HOST_SYNC} <= set(seen)
    # laid over the profiler's export, on its time base
    merged = tmp_path / "merged.json"
    timer.export(merged, profiler_trace=path)
    events = json.loads(merged.read_text())["traceEvents"]
    mine = [e for e in events if e.get("tid") == timing.SPAN_TID
            and e.get("ph") == "X"]
    assert len(mine) == len(timer.spans)
    assert len(events) == len(doc["traceEvents"]) + len(mine) + 1
    first = ranges[timer.spans[0].name][0]
    assert abs(mine[0]["ts"] - float(first["ts"])) < 1e3


def test_export_writes_one_complete_event_per_span(tmp_path):
    timer = PhaseTimer(trace=True)
    _run_panel(timer)
    path = tmp_path / "spans.json"
    timer.export(path)
    events = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == len(timer.spans)
    for e, s in zip(xs, timer.spans):
        assert e["name"] == s.name and e["dur"] >= 0
        assert e["ts"] == s.start_ns / 1e3
        assert e["args"]["call"] == s.call
        assert e["args"]["parent"] == s.parent
        assert e["args"]["device_s"] == s.device_s
        assert e["cat"] == ("phase" if s.phase else "span")
