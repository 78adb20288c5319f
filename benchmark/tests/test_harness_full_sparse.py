"""The full-order cell on the large-N route, `waveguide_34110.full_sparse`:
the registry takes up its configuration, mix, entry point, cell file and
readers; its per-layer metrics are its own, read their channels and
nothing from a program without their spans or counters; and a walk at a
small size (blocks of N=256, tiled 10×) turns `correct` false when the
prepared system is not re-gridded."""

import json
import types

import pytest

from benchmark.harness import cli, guard, registry, roofline
from benchmark.harness import trace as tracing
from benchmark.tests.walk import run, small_cell

CELL = "waveguide_34110.full_sparse"
BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
# metric → (what it reads: "phases" name, trace "ranges", "counters", or
# the trace's busy time, the key)
METRICS = {
    "banded_factor_s.full_sparse": ("phases", "banded.factor"),
    "banded_refine_s.full_sparse": ("phases", "banded.refine"),
    "refine_steps.full_sparse": ("counters", "refine_steps"),
    "host_syncs.full_sparse": ("ranges", "host sync"),
    "idle_share.full_sparse": ("trace", None),
    "banded_roofline.full_sparse": ("busy", "full-order sweep"),
}


def _records(phases=None, ranges=None, counters=None, busy=None,
             attempted=4, calls=2):
    cell = registry.find_cell(CELL)
    win = cli.Window(seed=1, seconds=1.0, attempted=attempted,
                     calls=attempted, phases=dict(phases or {}),
                     counters=dict(counters or {}))
    if ranges is not None:
        win.trace = tracing.TraceSummary(
            window_s=1.0, busy_s=0.5, calls=calls,
            range_busy_s=dict(busy or {}), range_count=dict(ranges),
            device_ops=[], idle_gaps=[])
    return cli.Records(setup_s=1.0, window=win, cell=cell,
                       device_kind="NVIDIA H100 80GB HBM3")


def test_the_registry_takes_up_the_cell_and_its_files():
    cell = registry.find_cell(CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        "waveguide_34110_fullorder", "full_sparse", 1)
    assert cell.config["system"] == "tiled_waveguide"
    assert cell.traffic["op"] == "full_sparse"
    for fn in ("setup", "call", "reset_counters", "counters"):
        assert callable(getattr(cell.op, fn))
    assert cell.spec["sample"] == {"calls": 2, "points": 8}
    assert cell.spec["trace_calls"] == 1
    assert [m["name"] for m in cell.end_to_end] == ["full_sweep_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(METRICS)
    # the grids are the `mor_sparse` mix's, on another entry point
    mix = json.loads((registry.BENCH_DIR / "traffic" / "mor_sparse.json")
                     .read_text())
    for k in ("lo_hz", "hi_hz", "points", "shift_steps", "offsets"):
        assert cell.traffic[k] == mix[k]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_is_this_cell_s_alone(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "full_sweep_s"
    for other in (w["name"] for w in BENCH["workloads"]):
        if other != CELL:
            assert name not in [m["name"] for m in
                                registry.find_cell(other).per_layer]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_reads_its_channel(name):
    channel, key = METRICS[name]
    read = registry.metric_reader(name)
    assert isinstance(read, types.FunctionType)
    if channel == "phases":
        assert read(_records(phases={key: 2.0})) == pytest.approx(0.5)
    elif channel == "counters":
        assert read(_records(counters={key: 10.0})) == pytest.approx(2.5)
    elif channel == "ranges":
        assert read(_records(ranges={key: 37})) == pytest.approx(18.5)
    elif channel == "trace":
        assert read(_records(ranges={})) == pytest.approx(0.5)
    else:
        # one profiled sweep, busy 16 s in its range
        rec = _records(ranges={key: 1}, busy={key: 16.0}, calls=1)
        least, bound = roofline.least_seconds(
            100 * 2.0 * 34110 * 3410**2 + 100 * 4.0 * 34110 * 3410 * 2,
            8.0 * (3 * 34110 * 6821 + 100 * 34110 * 2))
        assert bound == "operations"
        assert read(rec) == pytest.approx(100.0 * least / 16.0)
        assert 0.4 < read(rec) < 0.6


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_reads_nothing_without_its_span(name):
    read = registry.metric_reader(name)
    # the parent's program: phases, ranges and a counter of another route
    parent = _records(phases={"operator setup": 9.0},
                      ranges={"full_order_gsm": 2, "gsm": 2},
                      counters={"escalations": 0.0})
    if name == "idle_share.full_sparse":
        parent.window.trace.busy_s = 0.0  # no kernel ran
    assert read(parent) is None
    assert read(_records()) is None  # no trace at all


def test_the_driver_s_counters_read_the_banded_sweep():
    from morfem_tpu_torch.ops import block_tridiag as bt

    op = registry.find_cell(CELL).op
    op.reset_counters(None)
    assert op.counters(None) == {}  # no sweep ran
    bt.solve_sweep_banded.chunk_iterations.extend([3, 2])
    bt.solve_sweep_banded.escalations = 1
    assert op.counters(None) == {"refine_steps": 5.0, "escalations": 1.0}
    op.reset_counters(None)
    assert op.counters(None) == {}


def test_a_prepared_system_left_on_its_first_grid_is_not_correct(
        monkeypatch):
    """The calls answer for the grid the system was prepared on, not for
    the request's shifted grid: every sampled point is off."""
    if guard.forbidden_modules():
        pytest.skip("this process already holds JAX: run benchmark/tests "
                    "on their own")
    from morfem_tpu_torch.mor.api import MatfreeSystem

    monkeypatch.setattr(MatfreeSystem, "with_domain", lambda self, d: self)
    rc, res = run(small_cell(CELL))
    assert rc == 0 and res["correct"] is False
    assert res["compared"]["gsm_err"]["value"] > 1e-6
