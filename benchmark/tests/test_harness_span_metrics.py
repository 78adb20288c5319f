"""The per-layer metrics that read the program's spans: the registry takes
them up in their cells, each reads its channel, and each reads nothing
(None) from records of a program without the span."""

import json
import types

import pytest

from benchmark.harness import cli, registry
from benchmark.harness import trace as tracing

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
# metric → (cell, what it reads: "phases" name or a trace range, per call)
SPAN_METRICS = {
    "snapshot_solve_s.mor": ("waveguide_3411.mor", "phases", "greedy.solve"),
    "estimate_s.mor": ("waveguide_3411.mor", "phases", "greedy.estimate"),
    "snapshots.mor": ("waveguide_3411.mor", "ranges", "greedy.solve"),
    "host_syncs.mor": ("waveguide_3411.mor", "ranges", "host sync"),
    "panel_factor_s.full": ("waveguide_3411.full", "phases", "panel.factor"),
    "refine_s.full": ("waveguide_3411.full", "phases", "refine.step"),
    "host_syncs.full": ("waveguide_3411.full", "ranges", "host sync"),
}


def _records(cell, phases=None, ranges=None, attempted=4, calls=2):
    win = cli.Window(seed=1, seconds=1.0, attempted=attempted,
                     calls=attempted, phases=dict(phases or {}))
    if ranges is not None:
        win.trace = tracing.TraceSummary(
            window_s=1.0, busy_s=0.5, calls=calls, range_busy_s={},
            range_count=dict(ranges), device_ops=[], idle_gaps=[])
    return cli.Records(setup_s=1.0, window=win, cell=cell,
                       device_kind="cpu")


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_the_registry_takes_up_each_span_metric_in_its_cell(name):
    cell_name, _, _ = SPAN_METRICS[name]
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [cell_name]
    cell = registry.find_cell(cell_name)
    assert name in [m["name"] for m in cell.per_layer]
    assert entry["moves"] in [m["name"] for m in cell.end_to_end]
    for other in set(c for c, _, _ in SPAN_METRICS.values()) - {cell_name}:
        assert name not in [m["name"]
                            for m in registry.find_cell(other).per_layer]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_span_metric_reads_its_channel_per_call(name):
    cell_name, channel, key = SPAN_METRICS[name]
    read = registry.metric_reader(name)
    cell = registry.find_cell(cell_name)
    if channel == "phases":
        rec = _records(cell, phases={key: 2.0, "projection base": 9.0})
        assert read(rec) == pytest.approx(0.5)  # over 4 calls attempted
    else:
        rec = _records(cell, ranges={key: 37, "projection base": 2})
        assert read(rec) == pytest.approx(18.5)  # over 2 profiled calls


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_span_metric_reads_nothing_without_its_span(name):
    cell_name, _, _ = SPAN_METRICS[name]
    read = registry.metric_reader(name)
    cell = registry.find_cell(cell_name)
    # the parent's program: phases and ranges, but no span of this PR
    parent = _records(cell, phases={"projection base": 9.0},
                      ranges={"projection base": 2, "gsm": 2})
    assert read(parent) is None
    assert read(_records(cell)) is None  # no trace at all
    assert read(_records(cell, phases={"greedy.solve": 1.0},
                         ranges={"greedy.solve": 3}, attempted=0,
                         calls=0)) is None
    assert isinstance(read, types.FunctionType)
