"""On the card: the control (the plain reference in float32, TF32 off,
put in the program's place) fails each cell's limits at the cell's own
size, on three seeds, while the program passes them at the same sampled
points. Skips without a card."""

import json

import pytest
import torch

from benchmark.harness import registry

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import readings

    cell = registry.find_cell(name)
    limits = {k: v["limit"] for k, v in cell.spec["limits"].items()}
    lines = list(readings.readings(cell, [811, 812, 813], 3.0, True))
    assert len(lines) == 3
    for line in lines:
        assert line["failed"] == 0
        assert all(line["program"][k] <= lim for k, lim in limits.items())
        assert any(line["control"][k] > lim for k, lim in limits.items())
