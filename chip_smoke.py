#!/usr/bin/env python3
"""Drive the PyTorch port (morfem_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one progress line with its seconds and numbers:

  1. device  — the card's name, and its name and power limit from nvidia-smi;
  2. build   — the one-`nvcc` build of the CUDA kernels, with the registers,
               shared memory and spills that ptxas reports per kernel;
  3. kernels — each kernel (K1 panel_factor, K2 mm_words, K3 gather_rows)
               against its plain PyTorch version on the card, at the panel
               LU's shapes on the waveguide, with kernel, plain, library and
               bound times;
  4. slice   — the waveguide (N=3411, M=2, I=100, bundled data): the MOR GSM
               (greedy + spectral sweep) against the full-order GSM (panel-LU
               sweep through K1-K3), f64 spot checks of full-order solutions,
               and each kernel's launch count over that run.

A watchdog (faulthandler) ends a phase that hangs, with a traceback and a
non-zero exit; the phase's name is on the last progress line. Any failed
check exits non-zero. The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import re
import subprocess
import sys
import time

# seconds each phase may take before the watchdog ends the run
BUDGET = {"device": 60, "build": 600, "kernels": 300, "slice": 900}
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
REPLACES = {
    "panel_factor": "morfem_tpu/ops/pallas/panel_factor.py:60",
    "mm_words": "morfem_tpu/ops/pallas/fused_mm.py:74",
    "gather_rows": "morfem_tpu/ops/pallas/row_gather.py:45",
}
SOURCES = {
    "panel_factor": "morfem_tpu_torch/csrc/panel_factor.cu",
    "mm_words": "morfem_tpu_torch/csrc/fused_mm.cu",
    "gather_rows": "morfem_tpu_torch/csrc/row_gather.cu",
}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


@contextlib.contextmanager
def phase(name: str):
    print(f"[phase {name}] start", flush=True)
    faulthandler.dump_traceback_later(BUDGET[name], exit=True)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"[phase {name}] done in {time.perf_counter() - t0:.3f} s",
          flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of `fn` on the card in ms (CUDA events, after warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes/bandwidth and flops/peak."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """Per kernel: registers, shared memory and spill bytes from ptxas -v."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"kernel": m.group(1)}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            current["smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes.

    Returns {kernel: record} for the principal shape of each kernel (the
    one the default block-pivot path runs most), with max_abs_err the
    largest over all shapes checked.
    """
    import torch

    from morfem_tpu_torch.ops.kernels import (
        gather_rows, gather_rows_plain, mm_words, mm_words_plain,
        panel_factor, panel_factor_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}  # kernel -> [(principal, record)]

    def keep(name, principal, **r):
        results.setdefault(name, []).append((principal, r))

    # K1: full-pivot panel [8, 128, 3456] and block-pivot [8, 384, 384];
    # the relative tolerance 1e-5 covers rounding-order differences (the
    # kernel and the plain version round each product and sum alike, so in
    # practice they agree bit for bit); pivots and availability exactly
    for (g, p, npl), principal in (((8, 128, 3456), False),
                                   ((8, 384, 384), True)):
        pt = torch.randn((g, p, npl), generator=gen, device=dev)
        av = torch.ones((g, npl), device=dev)
        out_k = panel_factor(pt, av)
        out_p = panel_factor_plain(pt, av)
        check(torch.equal(out_k[2], out_p[2]), f"K1 pivots differ at {pt.shape}")
        check(torch.equal(out_k[3], out_p[3]), f"K1 avail differs at {pt.shape}")
        err = max(float((out_k[i] - out_p[i]).abs().max()) for i in (0, 1))
        scale = max(float(out_p[i].abs().max()) for i in (0, 1))
        check(err <= 1e-5 * scale, f"K1 error {err} at {pt.shape}")
        ms = cuda_ms(lambda: panel_factor(pt, av), 5)
        plain_ms = cuda_ms(lambda: panel_factor_plain(pt, av), 2)
        # work this data needs: step j updates P-1 rows over the lanes still
        # available and not the pivot (npl - j - 1 of them here)
        flops = g * sum(2 * (p - 1) * (npl - j - 1) for j in range(p))
        nbytes = 4 * (3 * g * p * npl + 2 * g * npl + g * p)
        b_ms, b_by = bound(nbytes, flops)
        print(f"  K1 panel_factor {list(pt.shape)}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        keep("panel_factor", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=None, shape=list(pt.shape))

    # K2: trailing updates of the block-pivot factor (S = A22 - L21·U12),
    # the U12 = L11⁻¹·A12 product, and the full-pivot trailing update with
    # the transposed coefficient view; FP32 accumulation over K ≤ 384 in
    # another order than cuBLAS: tolerance 1e-5 of the largest |output|
    cases = (
        ((8, 3072, 384, 3072), True, -1, False, True),
        ((8, 384, 384, 3072), False, 1, False, False),
        ((8, 3456, 128, 3328), True, 1, True, False),
    )
    for (g, m, k, n), with_t, sign, transposed, principal in cases:
        if transposed:
            c = torch.randn((g, k, m), generator=gen, device=dev).transpose(1, 2)
        else:
            c = torch.randn((g, m, k), generator=gen, device=dev)
        r = torch.randn((g, k, n), generator=gen, device=dev)
        t = torch.randn((g, m, n), generator=gen, device=dev) if with_t else None
        out_k = mm_words(c, r, t, sign=sign)
        out_p = mm_words_plain(c, r, t, sign=sign)
        err = float((out_k - out_p).abs().max())
        check(err <= 1e-5 * float(out_p.abs().max()),
              f"K2 error {err} at {(g, m, k, n)}")
        ms = cuda_ms(lambda: mm_words(c, r, t, sign=sign))
        plain_ms = cuda_ms(lambda: mm_words_plain(c, r, t, sign=sign))
        if t is not None:
            lib_ms = cuda_ms(lambda: torch.baddbmm(t, c, r, alpha=sign))
        else:
            lib_ms = cuda_ms(lambda: torch.bmm(c, r))
        flops = 2 * g * m * n * k
        nbytes = 4 * g * (m * k + k * n + m * n * (2 if with_t else 1))
        b_ms, b_by = bound(nbytes, flops)
        print(f"  K2 mm_words [{g},{m},{k}]@[{g},{k},{n}] t={with_t} "
              f"sign={sign}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) "
              f"tflops={flops / ms / 1e9:.2f}", flush=True)
        keep("mm_words", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[g, m, k, n])

    # K3: pivot rows of the block factor's A12 (principal), pivot rows of
    # the full-pivot trailing block, the final permutation; exact
    cases = (
        ((8, 384, 3072), 384, True),
        ((8, 3456, 3328), 128, False),
        ((8, 3456, 3456), 3456, False),
    )
    for (g, n, w), p, principal in cases:
        src = torch.randn((g, n, w), generator=gen, device=dev)
        idx = torch.stack([
            torch.randperm(n, generator=gen, device=dev)[:p] for _ in range(g)
        ]).to(torch.int32)
        out_k = gather_rows(src, idx)
        out_p = gather_rows_plain(src, idx)
        err = float((out_k - out_p).abs().max())
        check(err == 0.0, f"K3 not exact at {(g, n, w)}")
        ms = cuda_ms(lambda: gather_rows(src, idx))
        plain_ms = cuda_ms(lambda: gather_rows_plain(src, idx))
        batch = torch.arange(g, device=dev)[:, None]
        idx64 = idx.long()
        lib_ms = cuda_ms(lambda: src[batch, idx64])
        b_ms, b_by = bound(4 * (2 * g * p * w + g * p), 0)
        print(f"  K3 gather_rows src={[g, n, w]} P={p}: max_abs_err={err} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
              flush=True)
        keep("gather_rows", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[g, n, w, p])
    rec = {}
    for name, rows in results.items():
        principal = next(r for p, r in rows if p)
        worst = max(r["max_abs_err"] for _, r in rows)
        rec[name] = dict(principal, max_abs_err=worst)
    return rec


def slice_phase(dev, n_expected=3411, points=100):
    """The waveguide end to end: MOR GSM vs full-order GSM, spot checks,
    and the kernels' launch counts over the MOR + full-order run."""
    import numpy as np
    import torch

    from morfem_tpu_torch import MorfemConfig, PhaseTimer
    from morfem_tpu_torch.apps.waveguide import (
        full_order_gsm, load_waveguide_data, mor_gsm, waveguide_system,
    )
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from morfem_tpu_torch.ops.solve import solve_sweep

    data = load_waveguide_data(n_fallback=n_expected)
    check(data.c_mat.shape == (n_expected, n_expected),
          f"waveguide data has shape {data.c_mat.shape}")
    freq = np.linspace(3e9, 5e9, points)
    sys_ = waveguide_system(freq, data, device=dev)
    cfg = MorfemConfig(error_threshold=1e-10)
    timer = PhaseTimer(device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    gsm_mor, rm, greedy = mor_gsm(sys_, cfg, timer)
    t_mor = time.perf_counter() - t0
    t0 = time.perf_counter()
    gsm_full = full_order_gsm(sys_, cfg, timer)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    counts = launch_counts()
    check(bool(torch.isfinite(gsm_mor).all() and torch.isfinite(gsm_full).all()),
          "non-finite GSM")
    check(tuple(gsm_full.shape) == (points, 2, 2),
          f"GSM shape {tuple(gsm_full.shape)}")
    d = (gsm_mor - gsm_full).abs()
    err_max = float(d.max())
    err_fro = float(torch.linalg.norm(gsm_mor - gsm_full, dim=(1, 2)).max())
    print(f"  slice N={sys_.n} M={sys_.m} I={points}: Nr={rm.ncols} "
          f"greedy_iterations={greedy.iterations} "
          f"converged={greedy.converged} mor_s={t_mor:.3f} "
          f"full_s={t_full:.3f} max|S_mor-S_full|={err_max:.3e} "
          f"max_point_fro={err_fro:.3e}", flush=True)
    for name, t in timer.times.items():
        print(f"  slice phase '{name}': {t:.3f} s", flush=True)
    check(err_max < 1e-8, f"max|S_mor - S_full| = {err_max} >= 1e-8")

    # f64 spot checks of the panel-LU sweep at three grid points
    ts3 = sys_.domain[[0, points // 2, points - 1]]
    x3 = solve_sweep(sys_.with_domain(ts3), cfg)
    for t, x in zip(ts3, x3):
        a, b = assemble_at(sys_, t, symmetrize=cfg.symmetrize)
        xr = torch.linalg.solve(a, b)
        rel = float(torch.linalg.norm(x - xr) / torch.linalg.norm(xr))
        print(f"  spot f={float(t):.6e}: rel_err_vs_torch_solve={rel:.3e}",
              flush=True)
        check(rel < 1e-9, f"spot check at f={float(t)}: {rel} >= 1e-9")
    print("  kernels " + json.dumps(counts), flush=True)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import morfem_tpu_torch  # noqa: F401
        from morfem_tpu_torch.ops.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the morfem_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    with phase("device"):
        name = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"device={name!r} count={torch.cuda.device_count()}",
              flush=True)
        print(f"  nvidia-smi: {smi}", flush=True)
    with phase("build"):
        lib = _lib.load()
        print(f"  nvcc build {lib.build_seconds:.3f} s -> {lib.path.name}",
              flush=True)
        for row in ptxas_summary(lib.ptxas_log):
            print("  ptxas " + json.dumps(row), flush=True)
    with phase("kernels"):
        rec = kernel_phase(dev)
    with phase("slice"):
        counts = slice_phase(dev)

    kernels = []
    for kname in ("panel_factor", "mm_words", "gather_rows"):
        r = rec[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
    print(smi, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
