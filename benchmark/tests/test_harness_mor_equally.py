"""The equally-distributed cell on the large-N route,
`waveguide_34110.mor_equally`: the registry takes up its configuration,
mix, entry point, cell file and readers; its per-layer metrics read their
channels and nothing from a program without their spans or counters; the
plain reference finds every shifted grid of the mix and refuses a
frequency on none; and at a small size (blocks of N=256, tiled 10×) the
float64 reference agrees with the program while the float32 control does
not."""

import json
import math
import types

import numpy as np
import pytest

from benchmark.harness import cli, guard, registry, roofline, traffic
from benchmark.harness import trace as tracing
from benchmark.metrics.banded_roofline import sweep_work
from benchmark.tests.walk import small_cell

CELL = "waveguide_34110.mor_equally"
BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
# metric → (what it reads: "phases" name, trace "ranges", "counters", or
# the trace's busy time, the key)
METRICS = {
    "seed_solve_s.mor_equally": ("phases", "equally.solve"),
    "project_s.mor_equally": ("phases", "equally.project"),
    "seed_roofline.mor_equally": ("busy", "equally.solve"),
    "refine_steps.mor_equally": ("counters", "refine_steps"),
    "host_syncs.mor_equally": ("ranges", "host sync"),
    "idle_share.mor_equally": ("trace", None),
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
        "waveguide_34110_equally", "mor_equally", 1)
    assert cell.config["system"] == "tiled_waveguide"
    assert cell.config["reduced"] == []
    assert cell.config["morfem"] == {
        "error_threshold": 1e-6, "band_max_half": 3456,
        "use_equally_distributed": True,
        "equally_distributed_reduction_rate": 0.97}
    assert cell.traffic["op"] == "mor_equally"
    for fn in ("setup", "call", "reset_counters", "counters"):
        assert callable(getattr(cell.op, fn))
    assert cell.spec["sample"] == {"calls": 2, "points": 8}
    assert cell.spec["trace_calls"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["mor_solve_s",
                                                    "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(METRICS)
    # every number of the pencil is the tiled waveguide's
    base = registry.find_cell("waveguide_34110.mor_sparse")
    for k, v in base.config.items():
        if k not in ("name", "source", "deployment", "guarantees",
                     "morfem"):
            assert cell.config[k] == v, k
    # the grids are the `mor_sparse` mix's, on another entry point
    for k in ("lo_hz", "hi_hz", "points", "shift_steps", "offsets"):
        assert cell.traffic[k] == base.traffic[k]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_is_this_cell_s_alone(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "mor_solve_s"
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
        # two profiled calls, busy 0.8 s in their ranges: 3 seeds a call
        rec = _records(ranges={key: 2}, busy={key: 0.8})
        flops, nbytes = sweep_work(34110, 3410, 2, 3)
        assert flops == 3 * (2.0 * 34110 * 3410**2 + 4.0 * 34110 * 3410 * 2)
        least, bound = roofline.least_seconds(flops, nbytes)
        assert bound == "operations"
        assert read(rec) == pytest.approx(100.0 * least * 2 / 0.8)
        assert 0.4 < read(rec) < 0.7


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_reads_nothing_without_its_span(name):
    read = registry.metric_reader(name)
    # the parent's program: phases, ranges and a counter of another route
    parent = _records(phases={"projection base": 9.0, "gsm": 0.1},
                      ranges={"mor_gsm": 2, "projection base": 2},
                      counters={"escalations": 0.0})
    if name == "idle_share.mor_equally":
        parent.window.trace.busy_s = 0.0  # no kernel ran
    assert read(parent) is None
    assert read(_records()) is None  # no trace at all


def test_the_seed_count_is_upstream_s():
    from benchmark.metrics.seed_roofline import seed_count

    cell = registry.find_cell(CELL)
    assert seed_count(cell.config, cell.traffic["points"]) == 3
    rate = {"morfem": {"equally_distributed_reduction_rate": 0.9}}
    assert seed_count(rate, 100) == math.floor(100 * (1 - 0.9)) == 9


def test_the_driver_s_counters_read_the_sweep_and_the_seeds():
    from morfem_tpu_torch.mor import equally
    from morfem_tpu_torch.ops import block_tridiag as bt

    op = registry.find_cell(CELL).op
    op.reset_counters(None)
    assert op.counters(None) == {}  # nothing ran
    bt.solve_sweep_banded.chunk_iterations.extend([3, 2])
    equally.matfree_seed_basis.seeds.extend([3, 3])
    assert op.counters(None) == {"refine_steps": 5.0, "seeds": 6.0}
    op.reset_counters(None)
    assert op.counters(None) == {}


def test_the_reference_finds_every_grid_of_the_mix():
    cell = registry.find_cell(CELL)
    mod = cell.config_mod
    reqs = traffic.warmup_requests(cell.traffic) + [
        r for r, _ in zip(traffic.requests(cell.traffic, 2**31 + 5),
                          range(cell.traffic["offsets"]))]
    assert len({r.lo_hz for r in reqs}) == cell.traffic["offsets"] + 1
    rng = np.random.default_rng(0)
    for req in reqs:
        want = req.freqs()
        for idx in ([0], [99], np.sort(rng.choice(100, 8, replace=False))):
            grid = mod.call_grid(cell.config, want[idx])
            assert np.allclose(grid, want, rtol=0, atol=1e-6)
        seeds = mod.seed_points(want, 0.97)
        assert np.array_equal(seeds, want[[0, 49, 99]])


@pytest.mark.parametrize("case", ["two_grids", "half_step", "below",
                                  "above", "between"])
def test_the_reference_refuses_a_frequency_on_no_grid(case):
    cell = registry.find_cell(CELL)
    step = (5e9 - 3e9) / 99
    base = np.linspace(3e9, 5e9, 100)
    freqs = {
        "two_grids": np.array([base[3] + 0.1 * step, base[7] - 0.2 * step]),
        "half_step": np.array([base[10] + 0.5 * step]),
        "below": np.array([3e9 - 0.7 * step]),
        "above": np.array([5e9 + 0.7 * step]),
        "between": np.array([base[2], base[5] + 0.25 * step]),
    }[case]
    with pytest.raises(ValueError, match="no"):
        cell.config_mod.call_grid(cell.config, freqs)


def test_the_reference_agrees_with_the_program_and_the_control_does_not():
    """At N=256 tiled 10×: the float64 reference of the same construction
    reads the program's GSM within 1e-9, the float32 control far above."""
    if guard.forbidden_modules():
        pytest.skip("this process already holds JAX: run benchmark/tests "
                    "on their own")
    from benchmark import readings

    cell = small_cell(CELL)
    (line,) = readings.readings(cell, [2**31 + 11], 0.3, True, device="cpu")
    assert line["failed"] == 0
    assert line["program"]["gsm_err"] <= 1e-9
    assert line["control"]["gsm_err"] > 1e3 * line["program"]["gsm_err"]
    assert line["control"]["gsm_err"] > cell.spec["limits"]["gsm_err"][
        "limit"]
