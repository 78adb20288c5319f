"""A CPU walk of each cell's control flow at a small size (N=256),
the card check skipped: the result line's keys, the traced run, and the
check's answer when the timed path is broken underneath."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import cli, guard, registry
from benchmark.tests.walk import run, small_cell

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def no_jax_loaded():
    if guard.forbidden_modules():
        pytest.skip("this process already holds JAX: run benchmark/tests "
                    "on their own")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_walk_prints_the_contract_line(name, traced):
    cell = small_cell(name)
    rc, res = run(cell, traced=traced)
    assert rc == 0
    want = KEYS + ["setup_built_kernels"] + (
        ["breakdown"] if traced else []) + ["compared"]
    assert list(res) == want
    assert res["setup_built_kernels"] is False  # no card, nothing built
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = {m["name"] for m in cell.metrics(traced)}
    for k, m in res["metrics"].items():
        assert k in names and m["value"] > 0 and m["unit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(res["metrics"]) == names
    for k, c in res["compared"].items():
        assert set(c) == {"value", "limit"}


def test_no_profiler_and_no_timer_untraced(monkeypatch):
    """A --trace 0 run enables no PhaseTimer and starts no profiler."""
    import morfem_tpu_torch

    def refuse(*a, **k):
        raise AssertionError("profiler started in an untraced run")

    made = []
    real = morfem_tpu_torch.PhaseTimer

    class Spy(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(cli.tracing, "start", refuse)
    monkeypatch.setattr(morfem_tpu_torch, "PhaseTimer", Spy)
    rc, _ = run(small_cell("waveguide_3411.mor"), traced=False)
    assert rc == 0
    assert all(t.disabled for t in made)


def test_trace_leaves_no_file_behind(tmp_path, monkeypatch):
    """A traced run leaves nothing under TMPDIR (the caches that `main`
    points into the checkout go elsewhere here)."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    for name in cli.CACHE_ENV:
        monkeypatch.setenv(name, str(tmp_path / "cache" / name.lower()))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    rc, _ = run(small_cell("waveguide_3411.full"), traced=True)
    assert rc == 0
    assert list(tmp.iterdir()) == []


def test_main_refuses_without_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_main_refuses_an_unknown_cell(capsys):
    rc = cli.main(["--workload", "no_such.cell", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


# faults planted under the timed path; each has to turn `correct` false


def _altered(monkeypatch, cell):
    """An answer altered where it is produced: the GSM off by 1e-3
    relative."""
    import morfem_tpu_torch.apps.waveguide as wg

    gsm = wg.generalized_scattering_matrix
    monkeypatch.setattr(wg, "generalized_scattering_matrix",
                        lambda *a, **k: gsm(*a, **k) * (1 + 1e-3))


def _half_left_out(monkeypatch, cell):
    """Half of the batch left out: only every other point is answered and
    its answer stands in for the next."""
    import morfem_tpu_torch.apps.waveguide as wg

    def halve(fn):
        def run_half(*a, **k):
            out = fn(*a, **k)
            return torch.repeat_interleave(out[::2], 2, dim=0)[:len(out)]
        return run_half

    monkeypatch.setattr(wg, "generalized_scattering_matrix",
                        halve(wg.generalized_scattering_matrix))


def _raises(monkeypatch, cell):
    """Every call of the window fails (the warm-up's go through)."""
    call = cell.op.call

    def boom(bench, state, req, timer):
        if req.index >= 0:
            raise RuntimeError("planted")
        return call(bench, state, req, timer)

    monkeypatch.setattr(cell.op, "call", boom)


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _raises])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = small_cell(name)
    rc, sound = run(cell)
    assert rc == 0 and sound["correct"]
    cell = small_cell(name)
    fault(monkeypatch, cell)
    rc, res = run(cell)
    assert rc == 0 and res["correct"] is False
    if fault is not _raises:
        assert any(c["value"] > c["limit"]
                   for c in res["compared"].values())


def test_the_control_reads_above_the_program():
    """At N=256 the float32 reference in the program's place already
    reads far above the program's own gap."""
    from benchmark import readings

    cell = small_cell("waveguide_3411.mor")
    (line,) = readings.readings(cell, [5], 0.3, True, device="cpu")
    assert line["control"]["gsm_err"] > 100 * line["program"]["gsm_err"]
    assert np.isfinite(line["control"]["gsm_err"])


def test_kernels_built_reads_the_checkouts_build(tmp_path, monkeypatch):
    """`setup_built_kernels` rests on the kernel library in the
    checkout's ``morfem_tpu_torch/_build/<hash>/``."""
    monkeypatch.setattr(cli.registry, "ROOT", tmp_path)
    assert not cli.kernels_built()
    lib = (tmp_path / "morfem_tpu_torch" / "_build" / "0123abcd"
           / "libmorfem_kernels.so")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert cli.kernels_built()
