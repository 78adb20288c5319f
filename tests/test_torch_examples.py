"""The port's last six example scripts, run at small sizes on the CPU
(the two parallel ones on two gloo ranks), each checked by the accuracy
it prints; the multi-rank dry run; and the no-JAX rule for the parallel
layer's spawned ranks.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(out: str, key: str) -> float:
    return float(out.split(key)[1].split()[0])


def test_multi_geometry_example_on_two_ranks(capsys):
    from morfem_tpu_torch.examples import multi_geometry

    multi_geometry.main(["--cpu", "--ranks", "2", "--n", "48",
                         "--geometries", "4", "--points", "16",
                         "--seeds", "4"])
    out = capsys.readouterr().out
    assert "mesh: dp=1 sp=1 tp=2" in out and "Done" in out
    assert _value(out, "rel diff:") < 1e-9


def test_tp_dense_solve_example_on_two_ranks(capsys):
    from morfem_tpu_torch.examples import tp_dense_solve

    tp_dense_solve.main(["--cpu", "--ranks", "2", "--n", "200",
                         "--panel", "16"])
    out = capsys.readouterr().out
    assert out.count("rel error vs numpy") == 2 and "OK" in out
    assert _value(out, "refined: rel error vs numpy") < 1e-12


def test_large_n_sweep_example(capsys):
    from morfem_tpu_torch.examples import large_n_sweep

    large_n_sweep.main(["--cpu", "--base-n", "120", "--rate", "2",
                        "--points", "24", "--seeds", "12"])
    out = capsys.readouterr().out
    assert "N = 240 (= 120 × 2)" in out
    assert _value(out, "check points: max") < 1e-6


def test_banded_direct_greedy_example(capsys):
    from morfem_tpu_torch.examples import banded_direct_greedy

    banded_direct_greedy.main(["--cpu", "--n", "1024", "--points", "20"])
    out = capsys.readouterr().out
    assert "converged=True" in out and out.count("rel err vs dense") == 3
    assert "PASS" in out


def test_general_sparse_mor_example(capsys):
    from morfem_tpu_torch.examples import general_sparse_mor

    general_sparse_mor.main(["--cpu", "--n", "1500", "--points", "12",
                             "--far", "60", "--dense-cutoff", "1000"])
    out = capsys.readouterr().out
    assert "OK — worst rel error" in out
    assert _value(out, "worst rel error") < 1e-6


def test_random_matrix_experiment_example(capsys):
    from morfem_tpu_torch.examples import random_matrix_experiment

    random_matrix_experiment.main(["--cpu", "--n", "200", "--no-plots"])
    out = capsys.readouterr().out
    assert "reduced model: 10 columns" in out
    assert _value(out, "vs full-order sweep:") < 1e-5


@pytest.mark.parametrize("name", ["multi_geometry", "tp_dense_solve",
                                  "large_n_sweep", "random_matrix_experiment"])
def test_examples_default_to_the_card(name):
    """Without --cpu an example runs on the card, and raises without one."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"morfem_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--n", "64"] if name != "large_n_sweep"
                 else ["--base-n", "64"])


def test_dryrun_multichip_on_four_cpu_ranks():
    from morfem_tpu_torch.parallel.launch import dryrun_multichip

    dev = dryrun_multichip(4)
    assert set(dev) == {"mor", "tp_project", "sp_sweep", "greedy",
                        "spectral", "full_sweep", "tp_dense_residual",
                        "spike_banded"}
    assert all(v < 1e-9 for v in dev.values())


def test_spawned_ranks_import_neither_jax_nor_the_jax_package():
    """A fresh process imports every module of the parallel layer and the
    new examples, then spawns two ranks that import them too and run a
    sharded call; neither the process nor a rank has loaded JAX or the
    JAX package."""
    mods = ["parallel", "parallel.mesh", "parallel.sharded",
            "parallel.tp_solve", "parallel.tp_banded", "parallel.tp_dense",
            "parallel.launch", "examples.multi_geometry",
            "examples.tp_dense_solve", "examples.large_n_sweep",
            "examples.banded_direct_greedy", "examples.general_sparse_mor",
            "examples.random_matrix_experiment"]
    code = f"""
import importlib, sys
mods = {mods!r}
for m in mods:
    importlib.import_module("morfem_tpu_torch." + m)
import torch
from morfem_tpu_torch.parallel import tp_solve
from morfem_tpu_torch.parallel.launch import MESH, Call, call_on_mesh, run_spmd
imp = importlib.import_module
calls = [Call(getattr, (Call(imp, ("morfem_tpu_torch." + m,)), "__name__"))
         for m in mods]
a = torch.eye(8, dtype=torch.float64) * 3
calls.append(Call(tp_solve, (a, torch.ones(8, 1, dtype=torch.float64),
                             MESH)))
calls.append(Call(sorted, (Call(getattr, (Call(imp, ("sys",)),
                                          "modules")),)))
out = run_spmd(call_on_mesh, 2, "gloo", "cpu", (1, 1, 2), calls)
assert float(out[-2][1].max()) < 1e-10
def bad(names):
    return [m for m in names if m == "jax" or m.startswith("jax.")
            or m == "morfem_tpu" or m.startswith("morfem_tpu.")]
print(bad(sys.modules), bad(out[-1]))
sys.exit(1 if bad(sys.modules) or bad(out[-1]) else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
