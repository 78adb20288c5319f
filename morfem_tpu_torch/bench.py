"""Benchmark: reduced-sweep speedup vs the full-order sweep, on the card.

Counterpart of the JAX package's `bench.py`, with the same headline, the
same configuration and the same extras:

  1. the full-order sweep's wall time over the waveguide grid (N=3411,
     M=2, I=100 on 3–5 GHz, the panel LU through K1–K3 in chunks of 20;
     warm, median of 3, each run ended by a synchronise),
  2. the device time of one auto/spectral reduced sweep on the same grid,
     amortized as the two-point slope (t(1024) − t(256)) / 768 between
     two chains of data-dependent sweeps. On the card each chain is one
     CUDA graph (the counterpart of "inside one jit"), replayed on one of
     8 perturbed grids and timed with CUDA events, median of 5; on the
     CPU the chains run eagerly under `time.perf_counter`,
  3. headline = (1) / (2); ``vs_baseline`` = headline / 50, the
     reference's target (not a measurement),
  4. extras: dense-grid throughput (batched LU, K4, spectral), the banded
     large-N case (`morfem_tpu_torch.bench_banded`, in this process),
     panel-factor rates, the three-term pencil (K4 against LU), the
     Gauss–Jordan inverse and the full-order spectral sweep.

    python -m morfem_tpu_torch.bench [--cpu] [--check-points PATH]

Runs on the card; ``--cpu`` is the only way onto the CPU. Prints exactly
one JSON line on stdout in every path, progress on stderr. A global wall
budget (``BENCH_BUDGET_S``, default 540 s) starts with the run: an extra
starts only if its estimate and a 30 s reserve fit in what is left, else
it records ``<name>_skipped``; an extra that raises records
``<name>_error`` and the rest still run; a watchdog emits what has been
measured when 15 s are left. The exit code is 0 only when the headline
was measured, no extra raised and the watchdog did not fire.
``--check-points PATH`` also writes three of the full-order solutions
(first, middle and last grid point) to an ``.npz`` file, for a check
against an independent solver.

Knobs (environment): BENCH_N (3411), BENCH_POINTS (100),
BENCH_DENSE_POINTS (10000), BENCH_BUDGET_S (540); the banded extra reads
BENCH_BANDED_P and BENCH_BANDED_POINTS.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from morfem_tpu_torch.device import (
    capture_graph,
    median_event_ms,
    median_wall_s,
    sync,
)

BASELINE_TARGET_SPEEDUP = 50.0  # the reference's target speed-up
CHAIN_SHORT, CHAIN_LONG = 256, 1024
PERTURBED_GRIDS = 8
THREE_TERM_POINTS = 4000  # an A/B ratio needs no 10k grid
FULL_DENSE = 2000
REPO = Path(__file__).resolve().parents[1]


class Run:
    """One bench run's result, budget and single-shot emission.

    `result` is filled in place as stages complete, so that an emission
    forced by the watchdog carries everything measured so far.
    """

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.t0 = time.monotonic()
        self.result = {
            "metric": "reduced_sweep_speedup_vs_full_order",
            "value": 0.0,
            "unit": "x",
            "vs_baseline": 0.0,
            "error": "core measurement did not complete",
            "extras": {},
        }
        self.extras = self.result["extras"]
        self.failed = False  # an extra raised
        self._lock = threading.Lock()
        self._emitted = threading.Event()

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def log(self, *a) -> None:
        print(f"[{time.monotonic() - self.t0:6.1f}s]", *a, file=sys.stderr,
              flush=True)

    def emit(self) -> None:
        """Print the one JSON line, once, with the launches so far."""
        from morfem_tpu_torch.ops.kernels import launch_counts

        with self._lock:
            if self._emitted.is_set():
                return
            self.extras["launches"] = launch_counts()
            print(json.dumps(self.result), flush=True)
            self._emitted.set()

    def exit_code(self) -> int:
        bad = ("error" in self.result or self.failed
               or "watchdog_forced_emit" in self.extras)
        return 1 if bad else 0

    def watchdog(self) -> None:
        """Emit and end the process when 15 s of budget are left."""
        while not self._emitted.wait(max(0.0, min(self.remaining() - 15.0,
                                                  5.0))):
            if self.remaining() <= 15.0:
                self.log(f"WATCHDOG: budget {self.budget_s:.0f} s nearly "
                         "exhausted — emitting the result now and exiting")
                self.extras["watchdog_forced_emit"] = True
                self.emit()
                sys.stderr.flush()
                os._exit(1)

    def extra(self, name: str, est_s: float, fn, *args) -> None:
        """Run one extra if the budget allows; record its failure."""
        if self.remaining() < est_s + 30.0:
            self.log(f"extra '{name}' skipped: {self.remaining():.0f} s left "
                     f"< {est_s:.0f} s estimate + reserve")
            self.extras[f"{name}_skipped"] = "budget"
            return
        try:
            fn(self, *args)
        except Exception as e:  # recorded; the exit code reports it
            self.log(f"extra '{name}' FAILED: {type(e).__name__}: {e}")
            self.extras[f"{name}_error"] = f"{type(e).__name__}: {e}"
            self.failed = True


@dataclasses.dataclass
class Headline:
    """What the extras reuse from the headline's run."""

    dev: torch.device
    cfg: object
    sys_: object
    freq: np.ndarray
    rm: object
    sm: object
    x_full: torch.Tensor


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nvidia_smi():
    """(name, power limit) as nvidia-smi gives them, or (None, None)."""
    try:
        out = nvidia_smi_line()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, limit = out.rpartition(",")
    return name.strip(), limit.strip()


def wall_median(fn, grids, reps: int, dev) -> float:
    """Median wall seconds of fn(grid), each call synchronised; the grid
    changes between calls. One warm-up call first."""
    fn(grids[0])
    grid = itertools.cycle(list(grids[1:]) + list(grids[:1]))
    return median_wall_s(lambda: fn(next(grid)), reps, dev)


def _rel(x, ref) -> float:
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def reduced_sweep_lu(rm, ts, cfg):
    from morfem_tpu_torch.mor.reduced import (
        assemble_reduced,
        solve_reduced_batch,
    )

    a, rhs = assemble_reduced(rm, ts, cfg)
    return solve_reduced_batch(a, rhs, cfg)


def chained_sweeps(sm, g: torch.Tensor, k: int):
    """k data-dependent spectral sweeps, the reference bench's recurrence:
    gi = g·(1 + carry·1e-30) + i·1e-3, carry = min|x|·1e-300. Returns
    (carry, the last sweep's x). No host synchronisation: a CUDA graph
    captures it whole."""
    from morfem_tpu_torch.mor.spectral import spectral_sweep

    carry = torch.zeros((), dtype=g.dtype, device=g.device)
    x = None
    for i in range(k):
        gi = g * (1.0 + carry * 1e-30) + i * 1e-3
        x = spectral_sweep(sm, gi)
        carry = x.abs().min() * 1e-300
    return carry, x


def chain_seconds(sm, grids, k: int, dev, reps: int = 5) -> float:
    """Median seconds of one k-sweep chain. On the card: one CUDA graph,
    replayed after copying a perturbed grid into its static input (the
    copy is timed with it), timed with CUDA events. On the CPU: eager
    calls under perf_counter."""
    if dev.type != "cuda":
        return wall_median(lambda g: chained_sweeps(sm, g, k), grids, reps,
                           dev)
    static = grids[0].clone()
    graph, (_, x_last) = capture_graph(
        dev, lambda g: chained_sweeps(sm, g, k), static)
    # the replay computes what the eager chain computes on a new grid
    static.copy_(grids[1])
    graph.replay()
    _, x_eager = chained_sweeps(sm, grids[1], k)
    rel = _rel(x_last, x_eager)
    if not rel <= 1e-12:
        raise RuntimeError(f"the CUDA graph of the {k}-sweep chain differs "
                           f"from the eager chain by {rel:.3e}")
    grid = itertools.cycle(list(grids[1:]) + list(grids[:1]))

    def replay():
        static.copy_(next(grid))
        graph.replay()

    ms = median_event_ms(replay, reps)
    del graph
    return ms / 1e3


def solution_rel_error(q, x_r, x_full) -> float:
    """‖Q·x_r − x_full‖ / ‖x_full‖ over the whole grid."""
    return _rel(torch.einsum("nk,ikm->inm", q, x_r), x_full)


def gsm_error_max(domain, x_full, b_full, x_r, b_r) -> float:
    """Largest Frobenius norm of S_mor − S_full over the grid (b_full,
    b_r the impulse vectors at each point, t_b included)."""
    from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix

    g_ref = generalized_scattering_matrix(domain, x_full, b_full)
    g_mor = generalized_scattering_matrix(domain, x_r, b_r)
    return float(torch.linalg.norm(g_mor - g_ref, dim=(-2, -1)).max())


def headline(run: Run, dev: torch.device, check_points=None) -> Headline:
    """The headline and its accuracy, recorded in `run` before any
    extra; `check_points`, a path, also gets three full-order solutions."""
    from morfem_tpu_torch import MorfemConfig, greedy_basis, project
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data,
        waveguide_system,
    )
    from morfem_tpu_torch.mor.spectral import prepare_spectral, spectral_sweep
    from morfem_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from morfem_tpu_torch.ops.panel_lu import (
        reset_sweep_counters,
        solve_sweep_panel,
    )
    from morfem_tpu_torch.ops.solve import solve_sweep

    ex = run.extras
    n_dof = int(os.environ.get("BENCH_N", 3411))
    n_points = int(os.environ.get("BENCH_POINTS", 100))
    if dev.type == "cuda":
        from morfem_tpu_torch.ops.kernels import _lib

        t0 = time.perf_counter()
        _lib.load()
        ex["kernel_build_s"] = round(time.perf_counter() - t0, 3)
        gpu_name, power_limit = nvidia_smi()
        ex.update(device=torch.cuda.get_device_name(dev),
                  gpu_name=gpu_name, power_limit=power_limit,
                  timer="cuda_graph_events")
    else:
        ex.update(kernel_build_s=None, device="cpu", gpu_name=None,
                  power_limit=None, timer="perf_counter")
    run.log(f"device: {ex['device']} ({ex['gpu_name']}, {ex['power_limit']}; "
            f"budget {run.budget_s:.0f} s; kernels built or loaded in "
            f"{ex['kernel_build_s']} s)")
    reset_launch_counts()
    # the bundled waveguide is read from the repository's cache; other
    # sizes are synthesized (and cached there)
    data = load_waveguide_data(
        n_fallback=n_dof, cache_dir=str(REPO / "data" / "synthetic_cache"))
    freq = np.linspace(3e9, 5e9, n_points)
    sys_ = waveguide_system(freq, data, device=dev)
    # mgs: the reference bench's choice (same convergence as svd at N=3411)
    cfg = MorfemConfig(solve_chunk=20, error_threshold=1e-8,
                       orthonormalization="mgs")
    run.log(f"N={sys_.n} M={sys_.m} I={n_points} (synthetic={data.synthetic})")
    ex.update(n_dof=int(sys_.n), grid_points=n_points)

    # ---- full-order baseline: warm-up, then the median of 3 ----
    reset_sweep_counters()
    x_full = solve_sweep(sys_, cfg)
    sync(dev)
    full_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        x_full = solve_sweep(sys_, cfg)
        sync(dev)
        full_times.append(time.perf_counter() - t0)
    t_full = statistics.median(full_times)
    ex["escalations"] = solve_sweep_panel.escalations
    run.log(f"full-order sweep ({n_points} pts, warm, median of 3): "
            f"{t_full:.3f} s; over its 4 runs, block-pivot escalations "
            f"{ex['escalations']}, launches {launch_counts()}")
    ex["full_order_sweep_s"] = round(t_full, 4)
    if check_points:
        idx = [0, n_points // 2, n_points - 1]
        np.savez(check_points, ts=freq[idx],
                 x=x_full[idx].cpu().numpy())

    # ---- reduced model build: the first call and a warm one ----
    t0 = time.perf_counter()
    greedy_basis(sys_, cfg)
    sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    greedy = greedy_basis(sys_, cfg)
    sync(dev)
    t_build = time.perf_counter() - t0
    rm = project(sys_, greedy.q, greedy.ncols).trim()
    nr = rm.q.shape[1]
    run.log(f"basis build: {t_build:.3f} s warm, {t_first:.3f} s first call "
            f"(Nr={nr}, iters={greedy.iterations})")
    ex.update(basis_size=int(nr), basis_build_s=round(t_build, 3),
              greedy_first_call_s=round(t_first, 3))

    # ---- the reduced sweep on the same grid ----
    ts = sys_.domain
    step = (freq[1] - freq[0]) * 1e-3
    grids = [ts + i * step for i in range(PERTURBED_GRIDS)]
    t_floor = wall_median(torch.sum, grids, 7, dev)
    run.log(f"latency floor (torch.sum, synchronised): {t_floor * 1e3:.3f} ms")
    t_lu = wall_median(lambda g: reduced_sweep_lu(rm, g, cfg), grids, 7, dev)
    x_r = reduced_sweep_lu(rm, ts, cfg)
    run.log(f"reduced sweep LU ({n_points} pts): {t_lu * 1e3:.3f} ms")
    # what morfem() runs by default ('auto' → spectral for this pencil)
    sm = prepare_spectral(rm, cfg)
    t_single = wall_median(lambda g: spectral_sweep(sm, g), grids, 7, dev)
    run.log(f"reduced sweep auto/spectral ({n_points} pts, one call): "
            f"{t_single * 1e3:.4f} ms")
    t_short = chain_seconds(sm, grids, CHAIN_SHORT, dev)
    t_long = chain_seconds(sm, grids, CHAIN_LONG, dev)
    t_reduced = max((t_long - t_short) / (CHAIN_LONG - CHAIN_SHORT), 1e-9)
    run.log(f"reduced sweep auto/spectral device time (chain slope "
            f"{CHAIN_SHORT}→{CHAIN_LONG}, {ex['timer']}): "
            f"{t_reduced * 1e3:.5f} ms/sweep (chains: {t_short * 1e3:.2f} / "
            f"{t_long * 1e3:.2f} ms)")
    speedup = t_full / t_reduced

    # ---- accuracy against the full-order oracle ----
    rel = solution_rel_error(rm.q, x_r, x_full)
    _, cb = sys_.coefficients(ts)
    gsm_err = gsm_error_max(ts, x_full, cb[:, None, None] * sys_.b, x_r,
                            cb[:, None, None] * rm.b_r)
    run.log(f"solution rel error vs full-order: {rel:.3e}")
    run.log(f"GSM error max: {gsm_err:.3e}")

    # ---- the headline is measured: record it before any extra ----
    run.result["value"] = round(speedup, 2)
    run.result["vs_baseline"] = round(speedup / BASELINE_TARGET_SPEEDUP, 3)
    run.result.pop("error", None)
    ex.update({
        "vs_baseline_note": "value / 50, the reference's target speed-up "
        "(BASELINE.md), not a measurement",
        "reduced_sweep_ms": round(t_reduced * 1e3, 5),
        "reduced_sweep_chain256_ms": round(t_short * 1e3, 3),
        "reduced_sweep_chain1024_ms": round(t_long * 1e3, 3),
        "reduced_sweep_single_dispatch_ms": round(t_single * 1e3, 4),
        "reduced_sweep_lu_ms": round(t_lu * 1e3, 4),
        "latency_floor_ms": round(t_floor * 1e3, 4),
        "sweep_method_used": "spectral (morfem auto dispatch)",
        "solution_rel_error": rel,
        "gsm_error_max": gsm_err,
    })
    run.log(f"HEADLINE measured: {speedup:.1f}x ({run.remaining():.0f} s of "
            "budget left for extras)")
    return Headline(dev, cfg, sys_, freq, rm, sm, x_full)


def extra_dense_throughput(run: Run, h: Headline) -> None:
    """The serving re-sweep at BENCH_DENSE_POINTS: batched LU, K4 and the
    spectral sweep, K4 and spectral against LU."""
    from morfem_tpu_torch.mor.spectral import spectral_sweep
    from morfem_tpu_torch.ops.kernels.reduced_sweep import fused_reduced_sweep

    points = int(os.environ.get("BENCH_DENSE_POINTS", 10000))
    grids = [torch.linspace(h.freq[0] + i * 1e3, h.freq[-1], points,
                            dtype=torch.float64, device=h.dev)
             for i in range(PERTURBED_GRIDS)]

    def lu(g):
        return reduced_sweep_lu(h.rm, g, h.cfg)

    def k4(g):
        return fused_reduced_sweep(h.rm, g, h.cfg)

    def spectral(g):
        return spectral_sweep(h.sm, g)

    t_lu = wall_median(lu, grids, 5, h.dev)
    run.log(f"dense re-sweep LU ({points} pts): {t_lu * 1e3:.2f} ms "
            f"({points / t_lu:,.0f} points/s)")
    run.extras["dense_points_per_s_lu"] = round(points / t_lu)
    x_lu = lu(grids[0])
    t_k4 = wall_median(k4, grids, 5, h.dev)
    k4_rel = _rel(k4(grids[0]), x_lu)
    run.log(f"dense re-sweep K4 ({points} pts): {t_k4 * 1e3:.2f} ms "
            f"({points / t_k4:,.0f} points/s; vs LU rel {k4_rel:.1e})")
    run.extras.update(dense_points_per_s_k4=round(points / t_k4),
                      k4_vs_lu_rel=k4_rel)
    t_sp = wall_median(spectral, grids, 5, h.dev)
    sp_rel = _rel(spectral(grids[0]), x_lu)
    run.log(f"dense re-sweep spectral ({points} pts): {t_sp * 1e3:.2f} ms "
            f"({points / t_sp:,.0f} points/s; vs LU rel {sp_rel:.1e})")
    run.extras.update(dense_points_per_s=round(points / t_sp),
                      spectral_vs_lu_rel=sp_rel)


def extra_banded(run: Run, h: Headline) -> None:
    """The large-N banded case, in this process (the card compiles
    nothing at run time, so nothing can hang the way a remote compile
    could)."""
    from morfem_tpu_torch import bench_banded

    run.extras.update(bench_banded.run(h.dev))


def extra_panel_factor(run: Run, h: Headline) -> None:
    """Panel-LU factor rates at the sweep's batch (solve_chunk): the
    block-pivot factor at panel_width (K1, K2, K3) and the full-pivot
    factor at panel 128 (K1 with C̃ on 8-CTA clusters, K2, K3)."""
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.panel_lu import (
        panel_lu_factor,
        panel_lu_factor_block,
    )

    g_fac, n = h.cfg.solve_chunk, h.sys_.n
    idx = np.linspace(0, len(h.freq) - 1, g_fac, dtype=int)
    a_batch = torch.stack([
        assemble_at(h.sys_, h.sys_.domain[j], symmetrize=True)[0].to(
            torch.float32) for j in idx])

    def time_factor(fac, panel):
        fac(a_batch, panel=panel)  # warm-up
        sync(h.dev)
        times = []
        for rep in range(3):
            a_rep = a_batch * (1.0 + 1e-7 * (rep + 1))
            sync(h.dev)
            t0 = time.perf_counter()
            fac(a_rep, panel=panel)
            sync(h.dev)
            times.append(time.perf_counter() - t0)
        return min(times) / g_fac

    t_fac = time_factor(panel_lu_factor_block, h.cfg.panel_width)
    tflops = (2 / 3) * n**3 / t_fac / 1e12
    run.log(f"panel LU factor N={n} G={g_fac}: block-pivot (default) "
            f"{t_fac * 1e3:.2f} ms/matrix ({tflops:.3f} TFLOP/s effective)")
    run.extras.update(
        panel_factor_ms_per_matrix=round(t_fac * 1e3, 3),
        panel_factor_tflops=round(tflops, 3),
        panel_factor_pivot="block (config default; escalation-guarded, see "
        "solve_sweep_panel)",
    )
    if run.remaining() < 90:
        run.extras["panel_factor_full_skipped"] = "budget"
        return
    t_full = time_factor(panel_lu_factor, 128)
    tflops_full = (2 / 3) * n**3 / t_full / 1e12
    run.log(f"panel LU factor full-pivot {t_full * 1e3:.2f} ms/matrix "
            f"({tflops_full:.3f} TFLOP/s)")
    run.extras.update(
        panel_factor_full_ms_per_matrix=round(t_full * 1e3, 3),
        panel_factor_full_tflops=round(tflops_full, 3),
    )


def three_term_model(h: Headline):
    """A well-conditioned random symmetric reduced pencil of the basis's
    size with r1 ≠ 0 (no two-term spectral sweep) and t_a2 = t^1.5 ≠ t_a1²
    (no quadratic companion form): K4's niche."""
    from morfem_tpu_torch.mor.reduced import ReducedModel

    nr = h.rm.q.shape[1]
    rng = np.random.default_rng(7)

    def sym(x):
        return torch.as_tensor((x + x.T) / 2, device=h.dev)

    r0 = sym(rng.standard_normal((nr, nr))) + 3 * torch.eye(
        nr, dtype=torch.float64, device=h.dev)
    r1 = sym(rng.standard_normal((nr, nr))) * 0.1
    r2 = sym(rng.standard_normal((nr, nr))) * 0.05
    b3 = torch.as_tensor(rng.standard_normal((nr, h.sys_.m)), device=h.dev)
    dom = torch.linspace(1.0, 2.0, len(h.freq), dtype=torch.float64,
                         device=h.dev)
    return ReducedModel(
        domain=dom, q=h.rm.q, r0=r0, r1=r1, r2=r2, b_r=b3, ncols=nr,
        t_a0=torch.ones_like, t_a1=lambda t: t, t_a2=lambda t: t**1.5,
        t_b=lambda t: t,
    )


def extra_three_term(run: Run, h: Headline) -> None:
    """K4 against the batched LU on a three-term pencil that both spectral
    transforms must reject."""
    from morfem_tpu_torch.mor.spectral import (
        prepare_spectral,
        prepare_spectral_quadratic,
    )
    from morfem_tpu_torch.ops.kernels.reduced_sweep import fused_reduced_sweep

    rm3 = three_term_model(h)
    for prep in (prepare_spectral, prepare_spectral_quadratic):
        try:
            prep(rm3, h.cfg)
        except ValueError:
            continue
        raise RuntimeError(f"{prep.__name__} accepted the three-term pencil")
    grids = [torch.linspace(1.0 + i * 1e-4, 2.0, THREE_TERM_POINTS,
                            dtype=torch.float64, device=h.dev)
             for i in range(PERTURBED_GRIDS)]

    def lu(g):
        return reduced_sweep_lu(rm3, g, h.cfg)

    def k4(g):
        return fused_reduced_sweep(rm3, g, h.cfg)

    t_lu = wall_median(lu, grids, 5, h.dev)
    t_k4 = wall_median(k4, grids, 5, h.dev)
    rel = _rel(k4(grids[0]), lu(grids[0]))
    run.log(f"three-term pencil ({THREE_TERM_POINTS} pts, Nr={rm3.k}): LU "
            f"{t_lu * 1e3:.2f} ms ({THREE_TERM_POINTS / t_lu:,.0f} pts/s), "
            f"K4 {t_k4 * 1e3:.2f} ms ({THREE_TERM_POINTS / t_k4:,.0f} pts/s, "
            f"{t_lu / t_k4:.2f}x vs LU, rel {rel:.1e})")
    run.extras.update(
        three_term_points_per_s_lu=round(THREE_TERM_POINTS / t_lu),
        three_term_points_per_s_k4=round(THREE_TERM_POINTS / t_k4),
        three_term_k4_vs_lu_rel=rel,
    )


def extra_gj(run: Run, h: Headline) -> None:
    """The Gauss–Jordan f32 inverse at the mid-band point: its time, its
    raw |MA − I|/√N, and the refined solve's relative residual."""
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.blocked_inverse import gj_inverse_f32
    from morfem_tpu_torch.ops.precision import matmul_f32_accurate
    from morfem_tpu_torch.ops.solve import gj_solve_refined

    n, m = h.sys_.n, h.sys_.m
    a_mid, _ = assemble_at(h.sys_, h.sys_.domain[len(h.freq) // 2],
                           symmetrize=True)
    gj_inverse_f32(a_mid)  # warm-up
    sync(h.dev)
    t0 = time.perf_counter()
    gj_inverse_f32(a_mid * (1.0 + 1e-7))
    sync(h.dev)
    t_gj = time.perf_counter() - t0
    ainv = gj_inverse_f32(a_mid)
    eye = torch.eye(n, dtype=torch.float32, device=h.dev)
    gj_res = float(torch.linalg.norm(
        matmul_f32_accurate(ainv, a_mid.to(torch.float32)) - eye)
        / np.sqrt(n))
    b_mid = torch.as_tensor(np.random.default_rng(3).standard_normal((n, m)),
                            device=h.dev)
    x_gj = gj_solve_refined(a_mid, b_mid)
    solve_res = _rel(a_mid @ x_gj, b_mid)
    run.log(f"gj_inverse N={n}: {t_gj * 1e3:.1f} ms, |MA-I|/sqrt(N) = "
            f"{gj_res:.1e} (raw f32 inverse); refined solve rel residual "
            f"{solve_res:.1e}")
    run.extras.update(
        gj_inverse_ms=round(t_gj * 1e3, 2),
        gj_identity_residual=gj_res,
        gj_identity_residual_note="raw f32 explicit inverse; production "
        "callers refine in f64 (see gj_refined_solve_residual)",
        gj_refined_solve_residual=solve_res,
    )


def extra_full_spectral(run: Run, h: Headline) -> None:
    """The full-order spectral oracle: prepare once, sweep FULL_DENSE
    points, and its 100-point sweep against the panel-LU sweep."""
    from morfem_tpu_torch.ops.spectral_solve import prepare_spectral_full

    t0 = time.perf_counter()
    fs = prepare_spectral_full(h.sys_, h.cfg)
    sync(h.dev)
    t_prep = time.perf_counter() - t0
    grids = [torch.linspace(h.freq[0] + i * 1e3, h.freq[-1], FULL_DENSE,
                            dtype=torch.float64, device=h.dev)
             for i in range(PERTURBED_GRIDS)]
    t_fs = wall_median(fs.sweep, grids, 3, h.dev)
    fs_rel = _rel(fs.sweep(h.sys_.domain), h.x_full)
    run.log(f"FULL-ORDER spectral re-sweep ({FULL_DENSE} pts): "
            f"{t_fs * 1e3:.2f} ms ({FULL_DENSE / t_fs:,.0f} points/s; prepare "
            f"{t_prep:.3f} s; vs LU full sweep rel {fs_rel:.1e})")
    run.extras.update(
        full_spectral_points_per_s=int(FULL_DENSE / t_fs),
        full_spectral_prepare_s=round(t_prep, 3),
        full_spectral_vs_lu_rel=fs_rel,
    )


# (name, budget estimate in s, function), in the reference bench's order
EXTRAS = (
    ("dense_throughput", 60, extra_dense_throughput),
    ("banded", 60, extra_banded),
    ("panel_factor", 70, extra_panel_factor),
    ("three_term", 45, extra_three_term),
    ("gj", 25, extra_gj),
    ("full_spectral", 45, extra_full_spectral),
)


def main(argv=None) -> int:
    from morfem_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(
        description="Reduced-sweep speedup vs the full-order sweep; prints "
        "one JSON line.")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--check-points", metavar="PATH",
                   help="also write three full-order solutions to PATH (.npz)")
    args = p.parse_args(argv)
    run = Run(float(os.environ.get("BENCH_BUDGET_S", 540)))
    threading.Thread(target=run.watchdog, daemon=True).start()
    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
        h = headline(run, dev, args.check_points)
        for name, est_s, fn in EXTRAS:
            run.extra(name, est_s, fn, h)
        run.log(f"bench complete with {run.remaining():.0f} s of budget to "
                "spare")
    except Exception as e:  # reported in the line and by the exit code
        run.log(f"BENCH FAILED: {type(e).__name__}: {e}")
        run.result["error"] = f"{type(e).__name__}: {e}"
    finally:
        run.emit()
    return run.exit_code()


if __name__ == "__main__":
    sys.exit(main())
