"""The port's benchmark (`morfem_tpu_torch.bench`, `bench_banded`) on the
CPU, against the reference bench's formulas and pipeline.

(a) the solution-error and GSM-error helpers against the reference bench's
own formulas (`gim_real`, `gsm_from_y`, the N-contraction einsum) on the
same numpy inputs; (b) the chained-sweep recurrence step for step against a
plain loop of spectral sweeps; (c) the bench as a user runs it with
``--cpu`` at a small size: one JSON line with the reference bench's keys
(renamed and extended as the port's docs say) and three of its full-order
solutions against numpy; (d) without a card and without ``--cpu`` it fails
with one JSON line; a raising extra and the watchdog make it exit 1; (e)
the banded extra against the reference pipeline on the same small pencil.
The reference `bench.py` itself is not imported: it sets JAX's
compilation cache when imported.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morfem_tpu.apps.waveguide import gim_real, gsm_from_y

from morfem_tpu_torch import bench, bench_banded

REPO = Path(__file__).resolve().parents[1]

# the keys of the reference bench's line after a complete run (bench.py)
REFERENCE_TOP = {"metric", "value", "unit", "vs_baseline", "extras"}
REFERENCE_EXTRAS = {
    "n_dof", "grid_points", "device", "full_order_sweep_s", "basis_size",
    "basis_build_s", "greedy_compile_s", "reduced_sweep_ms",
    "reduced_sweep_chain256_ms", "reduced_sweep_chain1024_ms",
    "reduced_sweep_single_dispatch_ms", "reduced_sweep_lu_ms",
    "latency_floor_ms", "sweep_method_used", "solution_rel_error",
    "gsm_error_max", "dense_points_per_s_lu", "dense_points_per_s_pallas",
    "pallas_vs_lu_rel", "dense_points_per_s", "spectral_vs_lu_rel",
    "banded_n_dof", "banded_mor_total_s", "banded_basis_size",
    "banded_rel_error_vs_oracle", "banded_full_order_ms_per_point",
    "banded_points_per_s", "panel_factor_ms_per_matrix",
    "panel_factor_tflops", "panel_factor_pivot",
    "panel_factor_full_ms_per_matrix", "panel_factor_full_tflops",
    "three_term_points_per_s_lu", "three_term_points_per_s_pallas",
    "three_term_pallas_vs_lu_rel", "gj_inverse_ms", "gj_identity_residual",
    "gj_identity_residual_note", "gj_refined_solve_residual",
    "full_spectral_points_per_s", "full_spectral_prepare_s",
    "full_spectral_vs_lu_rel",
}
RENAMED = {
    "dense_points_per_s_pallas": "dense_points_per_s_k4",
    "pallas_vs_lu_rel": "k4_vs_lu_rel",
    "three_term_points_per_s_pallas": "three_term_points_per_s_k4",
    "three_term_pallas_vs_lu_rel": "three_term_k4_vs_lu_rel",
    "greedy_compile_s": "greedy_first_call_s",
}
ADDED = {"power_limit", "gpu_name", "escalations", "launches",
         "kernel_build_s", "timer", "vs_baseline_note"}
SMALL = {"BENCH_N": "192", "BENCH_POINTS": "30", "BENCH_DENSE_POINTS": "500",
         "BENCH_BANDED_P": "16", "BENCH_BANDED_POINTS": "20"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(*args, **env):
    """`python -m morfem_tpu_torch.bench` in a subprocess → (rc, stdout
    lines, stderr)."""
    out = subprocess.run(
        [sys.executable, "-m", "morfem_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", **env),
    )
    return out.returncode, out.stdout.splitlines(), out.stderr


def test_error_helpers_match_the_reference_formulas():
    """(a) S from the port's complex128 GSM equals the reference bench's
    real Cayley form to 1e-12, and the two error figures agree."""
    rng = np.random.default_rng(5)
    n, k, m, i = 40, 6, 2, 7
    freq = np.linspace(3e9, 5e9, i)
    b = rng.standard_normal((n, m))
    cb = np.sqrt(freq) * 1e-4
    x_full = rng.standard_normal((i, n, m))
    q, _ = np.linalg.qr(rng.standard_normal((n, k)))
    x_r = np.einsum("nk,inm->ikm", q, x_full) + 1e-3 * rng.standard_normal(
        (i, k, m))
    b_full = cb[:, None, None] * b
    b_r = cb[:, None, None] * (q.T @ b)

    g_ref = gsm_from_y(gim_real(freq, jnp.asarray(x_full),
                                jnp.asarray(b_full)))
    s_ref = np.asarray(g_ref[0]) + 1j * np.asarray(g_ref[1])
    from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix

    s_port = generalized_scattering_matrix(
        torch.as_tensor(freq), torch.as_tensor(x_full),
        torch.as_tensor(b_full)).numpy()
    assert np.linalg.norm(s_port - s_ref) <= 1e-12 * np.linalg.norm(s_ref)

    y_mor = gim_real(freq, jnp.asarray(x_r), jnp.asarray(b_r))
    g_mor = gsm_from_y(y_mor)
    ref_err = float(jnp.max(jnp.sqrt(jnp.sum(
        (g_mor[0] - g_ref[0]) ** 2 + (g_mor[1] - g_ref[1]) ** 2,
        axis=(-1, -2)))))
    port_err = bench.gsm_error_max(*(torch.as_tensor(a) for a in (
        freq, x_full, b_full, x_r, b_r)))
    assert ref_err > 1e-6  # a real difference, not roundoff
    assert abs(port_err - ref_err) <= 1e-10 * ref_err

    rec = jnp.einsum("nk,ikm->inm", jnp.asarray(q), jnp.asarray(x_r))
    ref_rel = float(jnp.linalg.norm(rec - x_full) / jnp.linalg.norm(x_full))
    port_rel = bench.solution_rel_error(
        torch.as_tensor(q), torch.as_tensor(x_r), torch.as_tensor(x_full))
    assert abs(port_rel - ref_rel) <= 1e-12 * ref_rel


def test_chained_sweeps_follow_a_plain_loop():
    """(b) The chain's recurrence, step for step, bit for bit on the CPU:
    gi = g·(1 + carry·1e-30) + i·1e-3, carry = min|x|·1e-300."""
    from morfem_tpu_torch.mor.reduced import ReducedModel
    from morfem_tpu_torch.mor.spectral import prepare_spectral, spectral_sweep

    rng = np.random.default_rng(3)
    kr, m = 6, 2
    a = rng.standard_normal((kr, kr))
    r0 = torch.as_tensor(a + a.T)
    r2 = torch.as_tensor(-(a @ a.T + kr * np.eye(kr)) * 1e-2)
    rm = ReducedModel(
        domain=torch.linspace(1.0, 2.0, 12, dtype=torch.float64),
        q=torch.eye(kr, dtype=torch.float64), r0=r0,
        r1=torch.zeros_like(r0), r2=r2,
        b_r=torch.as_tensor(rng.standard_normal((kr, m))), ncols=kr,
        t_a0=torch.ones_like, t_a1=lambda t: t, t_a2=lambda t: t**2,
        t_b=lambda t: t,
    )
    sm = prepare_spectral(rm)
    g = rm.domain.clone()
    steps, carry = [], torch.tensor(0.0, dtype=torch.float64)
    for i in range(5):
        x = spectral_sweep(sm, g * (1.0 + carry * 1e-30) + i * 1e-3)
        carry = x.abs().min() * 1e-300
        steps.append((carry, x))
    for k in (1, 2, 3, 5):
        c_k, x_k = bench.chained_sweeps(sm, g, k)
        assert torch.equal(c_k, steps[k - 1][0])
        assert torch.equal(x_k, steps[k - 1][1])


def test_bench_cpu_run_prints_the_reference_line(tmp_path):
    """(c) The bench with --cpu at a small size: rc 0, one JSON line with
    the reference bench's keys (renamed, extended), and its full-order
    solutions at three points equal numpy's solves."""
    points = tmp_path / "points.npz"
    rc, lines, err = _bench("--cpu", "--check-points", str(points), **SMALL)
    assert rc == 0, err[-3000:]
    assert len(lines) == 1, lines
    res = json.loads(lines[0])
    assert res["metric"] == "reduced_sweep_speedup_vs_full_order"
    assert res["value"] > 0 and res["unit"] == "x"
    assert res["vs_baseline"] == pytest.approx(res["value"] / 50, rel=1e-2)
    assert set(res) == REFERENCE_TOP
    want = {RENAMED.get(k, k) for k in REFERENCE_EXTRAS} | ADDED
    assert set(res["extras"]) == want
    ex = res["extras"]
    assert ex["timer"] == "perf_counter" and ex["device"] == "cpu"
    assert ex["n_dof"] == 192 and ex["banded_n_dof"] == 256
    assert ex["gsm_error_max"] < 1e-8 and ex["solution_rel_error"] < 1e-8
    assert max(ex["k4_vs_lu_rel"], ex["three_term_k4_vs_lu_rel"],
               ex["full_spectral_vs_lu_rel"]) < 1e-9
    assert ex["gj_refined_solve_residual"] < 1e-9
    assert ex["escalations"] == 0
    assert set(ex["launches"].values()) == {0}  # CPU tensors: plain twins

    from morfem_tpu_torch.apps.waveguide import (
        B_SCALE,
        GAMMA_SCALE,
        b_coefficient,
        load_waveguide_data,
    )

    data = load_waveguide_data(n_fallback=192)
    with np.load(points) as z:
        ts, xs = z["ts"], z["x"]
    assert ts.tolist() == np.linspace(3e9, 5e9, 30)[[0, 15, 29]].tolist()
    for t, x in zip(ts, xs):
        a = data.c_mat + t**2 * data.t_mat * GAMMA_SCALE
        cb = float(b_coefficient(torch.tensor(t, dtype=torch.float64)))
        xr = np.linalg.solve(a, cb * data.wp * B_SCALE)
        assert np.linalg.norm(x - xr) <= 1e-9 * np.linalg.norm(xr)


def test_bench_without_a_card_fails_with_one_line():
    """(d) Without a card and without --cpu: one JSON line with "error"
    and a non-zero exit; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, lines, _ = _bench(**SMALL)
    assert rc != 0
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert "no CUDA device" in res["error"] and res["value"] == 0.0
    assert "n_dof" not in res["extras"]


def test_bench_banded_without_a_card_fails_with_one_line(capsys):
    """(d) The banded case alone, without a card and without --cpu: one
    JSON line with "error" and exit code 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_banded.main([]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert "no CUDA device" in json.loads(lines[0])["error"]


def test_failed_extra_and_watchdog_exit_one(capsys):
    """(d) An extra that raises is recorded and the others still run, but
    the run exits 1; an extra over budget is skipped; the watchdog's
    emission exits 1."""
    run = bench.Run(100.0)
    run.result.pop("error")  # as after the headline

    def boom(r):
        raise ValueError("broken")

    ran = []
    run.extra("first", 0, boom)
    run.extra("second", 0, lambda r: ran.append(r))
    run.extra("third", 1000, lambda r: ran.append(r))
    assert run.extras["first_error"] == "ValueError: broken"
    assert ran == [run] and run.extras["third_skipped"] == "budget"
    assert run.exit_code() == 1
    run.emit()
    run.emit()  # single shot
    assert len(capsys.readouterr().out.splitlines()) == 1

    rc, lines, _ = _bench("--cpu", BENCH_BUDGET_S="15.3", **SMALL)
    assert rc == 1 and len(lines) == 1
    res = json.loads(lines[0])
    assert res["extras"]["watchdog_forced_emit"] is True


def _jax_banded_pipeline(p, n_points, cfg):
    """tools/bench_banded.py's pipeline in the JAX package (that script
    sets JAX's compilation cache when imported, so it is not imported)."""
    from morfem_tpu import morfem
    from morfem_tpu.apps.waveguide import GAMMA_SCALE
    from morfem_tpu.ops.block_tridiag import (
        banded_direct_solve,
        banded_via_rcm,
    )
    from morfem_tpu.utils.synthetic import banded_waveguide_system_2d

    freq = np.linspace(3e9, 5e9, n_points)
    c_sp, tt_sp, wp = banded_waveguide_system_2d(p, m=2, seed=1)
    gamma_sp = (tt_sp * GAMMA_SCALE).tocsr()
    zero_sp = 0.0 * c_sp
    xb, qb, *_ = morfem(freq, c_sp, zero_sp, gamma_sp, wp, config=cfg)
    op, perm = banded_via_rcm(c_sp, zero_sp, gamma_sp,
                              symmetrize=cfg.symmetrize)
    b_dev = jnp.asarray(wp)[perm]
    idx = np.linspace(0, n_points - 1, 7, dtype=int)
    t_vals = jnp.asarray(freq)[idx]
    cs = jnp.stack([jnp.ones_like(t_vals), t_vals, t_vals**2], axis=-1)
    x_oracle = jnp.stack([banded_direct_solve(op, cs[j], t_vals[j] * b_dev,
                                              cfg)[0]
                          for j in range(len(idx))])
    rec = jnp.einsum("nk,ikm->inm", jnp.asarray(qb)[perm], xb[idx])
    rel = float(jnp.linalg.norm(rec - x_oracle) / jnp.linalg.norm(x_oracle))
    return qb.shape[1], rel


def test_bench_banded_matches_the_reference_pipeline(monkeypatch):
    """(e) The banded extra at p=20 (N=400) against the reference pipeline
    on the same pencil, both on the matrix-free route the bench measures
    at its default size (dense_cutoff lowered below N): the same basis
    size, both within 1e-7 of their banded oracles."""
    import morfem_tpu as mt

    from morfem_tpu_torch import MorfemConfig

    monkeypatch.setenv("BENCH_BANDED_P", "20")
    monkeypatch.setenv("BENCH_BANDED_POINTS", "40")
    res = bench_banded.run("cpu", MorfemConfig(error_threshold=1e-8,
                                               dense_cutoff=128))
    nr_ref, rel_ref = _jax_banded_pipeline(
        20, 40, mt.MorfemConfig(error_threshold=1e-8, dense_cutoff=128))
    assert res["banded_n_dof"] == 400
    assert res["banded_basis_size"] == nr_ref
    assert res["banded_rel_error_vs_oracle"] < 1e-7 and rel_ref < 1e-7
