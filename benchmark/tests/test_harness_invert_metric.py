"""`invert_s.full`, the per-layer metric of the panel LU's diagonal-block
inverses: the registry takes it up in the full cell alone, it reads the
program's "panel.invert" span seconds over the sweeps attempted, and it
reads nothing (None) from a program without the span (a parent)."""

import json
import types

import pytest

from benchmark.harness import cli, registry
from benchmark.harness import trace as tracing

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
NAME, CELL, SPAN = "invert_s.full", "waveguide_3411.full", "panel.invert"


def _records(cell, phases=None, traced=True, attempted=4):
    win = cli.Window(seed=1, seconds=1.0, attempted=attempted,
                     calls=attempted, phases=dict(phases or {}))
    if traced:
        win.trace = tracing.TraceSummary(
            window_s=1.0, busy_s=0.5, calls=2, range_busy_s={},
            range_count={"full-order sweep": 2}, device_ops=[],
            idle_gaps=[])
    return cli.Records(setup_s=1.0, window=win, cell=cell,
                       device_kind="cpu")


def test_the_registry_takes_it_up_in_the_full_cell_alone():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert entry["layer"] == "Kernels" and entry["moves"] == "full_sweep_s"
    cell = registry.find_cell(CELL)
    assert NAME in [m["name"] for m in cell.per_layer]
    assert "full_sweep_s" in [m["name"] for m in cell.end_to_end]
    assert NAME not in [m["name"] for m in
                        registry.find_cell("waveguide_3411.mor").per_layer]


@pytest.mark.parametrize("seconds,attempted,expected", [
    (0.04, 4, 0.01), (0.006, 3, 0.002), (0.0, 2, 0.0)])
def test_it_reads_the_span_seconds_over_the_sweeps(seconds, attempted,
                                                   expected):
    read = registry.metric_reader(NAME)
    rec = _records(registry.find_cell(CELL),
                   phases={SPAN: seconds, "panel.factor": 9.0},
                   attempted=attempted)
    assert read(rec) == pytest.approx(expected)


@pytest.mark.parametrize("case", ["parent", "untraced", "no_sweep"])
def test_it_reads_nothing_without_the_span(case):
    read = registry.metric_reader(NAME)
    cell = registry.find_cell(CELL)
    if case == "parent":  # the parent's spans, without panel.invert
        rec = _records(cell, phases={"panel.factor": 0.37,
                                     "refine.step": 0.18})
    elif case == "untraced":
        rec = _records(cell, traced=False)
    else:
        rec = _records(cell, phases={SPAN: 0.01}, attempted=0)
    assert read(rec) is None
    assert isinstance(read, types.FunctionType)
