"""The harness finds each configuration, mix, driver, cell file and metric
by name, refuses unknown ones, and takes up new ones from files and
entries alone."""

import json
import shutil

import pytest

from benchmark.harness import guard, registry

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = registry.find_cell(name)
    assert cell.config["name"] == cell.config_name
    for fn in ("make_inputs", "reference"):
        assert callable(getattr(cell.config_mod, fn))
    for fn in ("setup", "call"):
        assert callable(getattr(cell.op, fn))
    assert cell.spec["limits"] and cell.spec["sample"]["calls"] >= 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(registry.metric_reader(name))


@pytest.mark.parametrize("bad", ["no_such.cell", "../BENCHMARK", "a/b", "",
                                 " x"])
def test_unknown_or_malformed_cells_are_refused(bad):
    with pytest.raises(registry.UnknownName):
        registry.find_cell(bad)


def test_unknown_metric_is_refused():
    with pytest.raises(registry.UnknownName):
        registry.metric_reader("no_such_metric.mor")


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark grows a cell on a new mix with a new
    per-layer metric by adding files and entries; no file there
    changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((bench_dir / "traffic" / "mor.json").read_text())
    mix["morfem"] = {"factorization": "panel"}
    (bench_dir / "traffic" / "mor_panel.json").write_text(json.dumps(mix))
    (bench_dir / "cells" / "waveguide_3411.panel.json").write_text(
        (bench_dir / "cells" / "waveguide_3411.mor.json").read_text())
    (bench_dir / "metrics" / "calls_made.py").write_text(
        "def read(rec):\n    return rec.window.attempted\n")
    bench["workloads"].append({"name": "waveguide_3411.panel",
                               "config": "waveguide_3411",
                               "traffic": "mor_panel", "chips": 1,
                               "why": "a new mix"})
    bench["end_to_end"][0]["workloads"].append("waveguide_3411.panel")
    bench["per_layer"].append({"name": "calls_made.panel", "unit": "count",
                               "better": "higher",
                               "source": "host_clock", "layer": "Device",
                               "moves": "mor_solve_s",
                               "workloads": ["waveguide_3411.panel"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.find_cell("waveguide_3411.panel", bench, bench_dir)
    assert cell.traffic["morfem"] == {"factorization": "panel"}
    assert [m["name"] for m in cell.per_layer] == ["calls_made.panel"]
    assert registry.metric_reader("calls_made.panel", bench_dir)
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("names, found", [
    (["morfem_tpu_torch", "morfem_tpu_torch.ops.solve", "torch",
      "jaxtyping", "morfem_tpu_torchx"], []),
    (["morfem_tpu.ops"], ["morfem_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen", "morfem_tpu", "jax"], ["flax", "jax", "morfem_tpu"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_the_reference_and_configs_import_nothing_of_the_program():
    """The plain reference, the configurations' makers and the metric
    readers name neither the port nor JAX."""
    files = [registry.BENCH_DIR / "harness" / "reference.py",
             registry.BENCH_DIR / "harness" / "roofline.py",
             *sorted((registry.BENCH_DIR / "configs").glob("*.py")),
             *sorted((registry.BENCH_DIR / "metrics").glob("*.py"))]
    for f in files:
        text = f.read_text()
        for bad in ("morfem_tpu", "import jax", "from jax"):
            assert bad not in text, f"{f.name} names {bad}"


def test_benchmark_json_keeps_to_its_format():
    """Keys, names, units, lengths and bounds as the benchmark's format
    asks; every configuration used, every cell with set-up, another
    end-to-end metric and a per-layer one."""
    import re

    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.fullmatch(c["name"]) and c["file"].startswith(
            "benchmark/")
        assert any(w["config"] == c["name"] for w in cells.values())
        assert c["reduced"] == json.loads(
            (registry.ROOT / c["file"]).read_text())["reduced"]
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and name.fullmatch(w["name"])
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    all_metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in all_metrics}) == len(all_metrics)
    for m in all_metrics:
        assert name.fullmatch(m["name"]) and unit.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["workloads"]
        for w in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", list(cells))
            assert w in reported
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        cell = registry.find_cell(w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(BENCH)) <= 64 * 1024
