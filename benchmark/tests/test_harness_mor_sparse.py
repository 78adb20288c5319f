"""The cell on the matrix-free route, `waveguide_34110.mor_sparse`: the
registry takes up its configuration, mix, entry point, cell file and readers;
its per-layer metrics read their channels and nothing from a program
without their spans; and a walk at a small size (blocks of N=256, tiled
10×) turns `correct` false when the prepared system is not re-gridded."""

import json
import types

import pytest

from benchmark.harness import cli, guard, registry
from benchmark.harness import trace as tracing
from benchmark.tests.walk import run, small_cell

CELL = "waveguide_34110.mor_sparse"
BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
# metric → (what it reads: "phases" name or trace "ranges", the key)
METRICS = {
    "greedy_s.mor_sparse": ("phases", "projection base"),
    "snapshot_solve_s.mor_sparse": ("phases", "greedy.solve"),
    "estimate_s.mor_sparse": ("phases", "greedy.estimate"),
    "banded_factor_s.mor_sparse": ("phases", "banded.factor"),
    "snapshots.mor_sparse": ("ranges", "greedy.solve"),
    "host_syncs.mor_sparse": ("ranges", "host sync"),
    "banded_refine_steps.mor_sparse": ("ranges", "banded.refine"),
    "idle_share.mor_sparse": ("trace", None),
}


def _records(phases=None, ranges=None, attempted=4, calls=2, busy=0.5):
    cell = registry.find_cell(CELL)
    win = cli.Window(seed=1, seconds=1.0, attempted=attempted,
                     calls=attempted, phases=dict(phases or {}))
    if ranges is not None:
        win.trace = tracing.TraceSummary(
            window_s=1.0, busy_s=busy, calls=calls, range_busy_s={},
            range_count=dict(ranges), device_ops=[], idle_gaps=[])
    return cli.Records(setup_s=1.0, window=win, cell=cell,
                       device_kind="cpu")


def test_the_registry_takes_up_the_cell_and_its_files():
    cell = registry.find_cell(CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        "waveguide_34110", "mor_sparse", 1)
    assert cell.config["system"] == "tiled_waveguide"
    assert cell.traffic["op"] == "mor_sparse"
    assert callable(cell.op.setup) and callable(cell.op.call)
    assert cell.spec["sample"] == {"calls": 2, "points": 8}
    assert [m["name"] for m in cell.end_to_end] == ["mor_solve_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(METRICS)
    # the mix is the `mor` mix on another entry point (`ops/mor_sparse.py`)
    mor = json.loads((registry.BENCH_DIR / "traffic" / "mor.json")
                     .read_text())
    for k in ("lo_hz", "hi_hz", "points", "shift_steps", "offsets"):
        assert cell.traffic[k] == mor[k]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_is_this_cell_s_alone(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "mor_solve_s"
    for other in ("waveguide_3411.mor", "waveguide_3411.full"):
        assert name not in [m["name"]
                            for m in registry.find_cell(other).per_layer]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_reads_its_channel(name):
    channel, key = METRICS[name]
    read = registry.metric_reader(name)
    assert isinstance(read, types.FunctionType)
    if channel == "phases":
        assert read(_records(phases={key: 2.0})) == pytest.approx(0.5)
    elif name == "banded_refine_steps.mor_sparse":
        rec = _records(ranges={key: 45, "greedy.solve": 15})
        assert read(rec) == pytest.approx(3.0)  # passes a snapshot
    elif channel == "ranges":
        assert read(_records(ranges={key: 37})) == pytest.approx(18.5)
    else:
        assert read(_records(ranges={}, busy=0.25)) == pytest.approx(0.75)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_reads_nothing_without_its_span(name):
    read = registry.metric_reader(name)
    # the parent's program: phases and ranges, but none of this route's
    parent = _records(phases={"operator setup": 9.0},
                      ranges={"mor_gsm": 2, "gsm": 2}, busy=0.0)
    assert read(parent) is None
    assert read(_records()) is None  # no trace at all
    if name == "banded_refine_steps.mor_sparse":
        # passes but no snapshot to count them over
        assert read(_records(ranges={"banded.refine": 4})) is None


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
