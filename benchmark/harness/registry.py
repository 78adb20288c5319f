"""Finds a cell's configuration, traffic mix, entry driver, limits and
metric readers by the names in ``BENCHMARK.json``.

Each lives in a file of its own, so a later change adds a cell, a mix or a
metric by adding files and entries only:

* ``configs/<config>.json`` (sizes, source) with ``configs/<config>.py``
  beside it (the frozen input maker and the plain reference);
* ``traffic/<mix>.json``, parameters that `traffic.py` reads; its ``op``
  names the driver ``ops/<op>.py`` of the entry point it calls;
* ``cells/<cell>.json``, the cell's own settings: how many calls the
  profiler records (``trace_calls``), the sample the check compares
  (``sample``) and the limit of each number it compares (``limits``);
* ``metrics/<metric>.py``, else ``metrics/<part before the first dot>.py``,
  the reader of one metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class UnknownName(LookupError):
    """A cell, configuration, mix, driver, cell file or metric that is not
    there."""


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name) or ".." in name:
        raise UnknownName(f"not a valid name: {name!r}")
    return name


def load_module(path: Path, tag: str):
    if not path.is_file():
        raise UnknownName(f"no file {path}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise UnknownName(f"no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """Everything one cell's run needs, found by name."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    config_mod: Any
    traffic_name: str
    traffic: Dict[str, Any]
    op: Any
    spec: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `bench` (default: the repository's
    ``BENCHMARK.json``), with its files loaded from `bench_dir`."""
    root = bench_dir.parent
    if bench is None:
        bench = load_json(root / "BENCHMARK.json")
    _checked(name)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json "
                          f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_name = _checked(w["config"])
    if cfg_name not in configs:
        raise UnknownName(f"no config {cfg_name!r} in BENCHMARK.json")
    cfg_file = root / configs[cfg_name]["file"]
    traffic_name = _checked(w["traffic"])
    traffic = load_json(bench_dir / "traffic" / f"{traffic_name}.json")
    op_name = _checked(traffic["op"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=cfg_name,
        config=load_json(cfg_file),
        config_mod=load_module(cfg_file.with_suffix(".py"),
                               f"bench_config_{cfg_name}"),
        traffic_name=traffic_name,
        traffic=traffic,
        op=load_module(bench_dir / "ops" / f"{op_name}.py",
                       f"bench_op_{op_name}"),
        spec=load_json(bench_dir / "cells" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        bench_dir=bench_dir,
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(records)`` function of metric `name`: from
    ``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``
    (one reader serves ``idle_share.mor`` and ``idle_share.full``)."""
    _checked(name)
    folder = bench_dir / "metrics"
    for stem in (name, name.split(".")[0]):
        path = folder / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"bench_metric_{stem}").read
    raise UnknownName(f"no reader for metric {name!r} in metrics/")
