#!/usr/bin/env python3
"""Drive the PyTorch port (morfem_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one progress line with its seconds and numbers:

  1. device  — the card's name, and its name and power limit from nvidia-smi;
  2. build   — the `nvcc` build of the CUDA kernels (one per source, run
               together, and a link), with the registers,
               shared memory and spills that ptxas reports per kernel;
  3. kernels — each kernel (K1 panel_factor, K2 mm_words, K3 gather_rows,
               K7 tri_inverse) against its plain PyTorch version on the
               card, at the panel LU's shapes on the waveguide, with
               kernel, plain, library and bound times (K1's library call:
               torch.linalg.lu_factor on the block-pivot blocks; K2's:
               baddbmm / bmm; K7's: the two solve_triangular calls it
               replaced); each K1 row names
               its variant (cluster of 8 or 16 CTAs, lanes in shared or
               device memory); then K1-K3 once each at a batch of 65,536
               (past a grid dimension's limit), bit for bit;
  4. slice   — the waveguide (N=3411, M=2, I=100, bundled data): the MOR GSM
               (greedy + spectral sweep) against the full-order GSM (panel-LU
               sweep through K1-K3, with its block-pivot escalations and
               refinement iterations per chunk), f64 spot checks of
               full-order solutions, and each kernel's launch count over that
               run;
  4b. banded — the banded full-order sweep's Schur-complement inverses
               on the 10× tiled waveguide (N=34,110, blocks of 3,456, one
               chunk of 8 points): K2 at the substitutions' shapes and
               strided views against its plain versions; both routes (8
               `inv_ex` calls; the panel LU's K1-K3, K7 and K2 together)
               timed at G = 1, 2, 4, 8; S⁻¹ against `inv_ex`'s and the
               f64 inverse, with each panel's residual; the chunk's sweep
               with its launches and `batched_inverses` counted, its GSM
               against the sweep of one point a chunk;
  5. entry   — the flagship forward step (`morfem_tpu_torch/entry.py`, the
               counterpart of `__graft_entry__.entry`): seed solves,
               thin SVD, projection, reduced sweep, GSM, captured as CUDA
               graphs (the SVD eager between two graphs: it synchronises).
               (a) entry()'s example (N=256): replay against the eager
               step; (b) the slice's waveguide with 6 and 16 seeds against
               the library route (equally_distributed_basis, project,
               sweep, GSM), and its distance to the full-order GSM; (c)
               factorization="panel" with 6 seeds: the seed solves through
               K1 (with C̃, on 8-CTA clusters), K2 and K3 inside the first
               graph, against (b). Eager, replay and capture times,
               segments, unitarity of the GSM;
  5b. panel  — morfem(factorization="panel") on the same waveguide: every
               greedy snapshot solve through the full-pivot panel LU (K1
               with C̃ at G=1, K2, K3), its GSM against the full-order GSM
               (< 1e-8), with its K1 launches and wall time;
  6. reduced_lu — the same waveguide through morfem() with the reduced LU
               sweep on K4 (sweep_method="lu", use_pallas_reduced_sweep=True):
               its GSM against the full-order GSM, then the serving re-sweep
               of the trimmed model on a 10,000-point grid against the
               batched library LU, with points/s;
  7. serve   — the rest of the single-GPU surface on the same waveguide:
               the trimmed MOR model saved and loaded (the default t_b must
               warn) and re-swept on 10,000 points through K4, bit for bit
               as the in-memory model; the full-order spectral oracle
               (prepare in f64 on the card) against the slice phase's
               panel-LU sweep, f64 solves and the full-order GSM, then a
               10,000-point full-order sweep; the Gauss-Jordan inverse and
               morfem(factorization="gj") against the full-order GSM; cyclic
               reduction against block Thomas on the N=34,225 pencil at 3
               points; the basis-size study (3..29 seeds) on the slice
               phase's full-order sweep against an independent recompute
               at two sizes;
  8. matfree — the 2-D waveguide pencil at N=34,225 (SciPy sparse, RCM-banded
               matrix-free route) through morfem(), default sweep and then the
               K4 LU sweep, against banded direct oracle solves at 7 points;
  9. general — the same pencil at N=9,409 forced onto the general-sparsity
               route (band_max_half=128: truncated band + exact-operator
               GMRES), same oracle check; then the same pencil plus weak
               scattered couplings, so that the preconditioner drops mass
               outside the band, against SciPy's spsolve at 3 points;
 10. krylov  — greedy_basis_matfree(method="bicgstab") on a banded operator
               (K5) and on a block-sparse operator (K6) at N=34,225, checked
               against scipy.sparse.linalg.spsolve at 3 points;
 11. complex — (a) the waveguide with a lossy Γ·T slot through morfem()'s
               native complex128 dense route, against the full-order
               complex sweep at all points (no K1-K3 launch), then the
               complex model's serving re-sweep on the 10,000-point grid
               (batched LU, no K4 launch) beside K4's real one; (b) the
               lossy N=34,225 pencil through the matrix-free route on the
               interleaved 2N embedding, default sweep and K4's flag (no K4
               launch: the embedded model is not swept), and (c) the same
               physics as real operators with a complex t_a2, each against
               complex spsolve at 3 points; (d) the BiCGStab greedy on the
               embedding of a complex banded pencil (K5);
 12. parallel — the multi-GPU layer on torch.distributed: a singular
               Schur block factors to non-finite values (no exception);
               (a) one NCCL rank in this process, mesh (1,1,1): the sharded
               full-order sweep (K1-K3) against the slice phase's sweep,
               the sharded reduced and spectral sweeps at 10,000 points,
               the tp projection and the tp Gauss-Jordan solve at
               N=3411; (b) two ranks spawned on the one card over gloo
               with CUDA tensors: sp=2 full-order sweep (K1-K3 on each
               rank) and reduced sweep, tp=2 projection, Gauss-Jordan
               solve, SPIKE on the N=34,225 pencil at 3 points against
               the single-card banded direct solve, row-parallel BiCGStab
               at N=4096, and dp=2 multi_geometry_mor on four waveguides
               against a serial loop. Two ranks share one card's SMs and
               memory: the phase's times show correctness and overhead,
               not a speed-up.

Each path's kernels are counted from zero over that path's run alone and
must have launched (the parallel phase's ranks report theirs to this
process, and the totals include them; the entry phase's panel step calls
K1 with C̃ at G=6 inside a CUDA graph and the panel phase at G=1, both
outside escalation, and
the entry phase counts its kernels in the eager step and in `capture`,
whose graph records as many as its warm-up launches); the kernels phase
(3) holds K4-K6 against their plain versions too, at the shapes these
paths give them: K4's warp variant at the build and serving grids and
its block variant at K=84, bit for bit;
K6 packed on the fly and through the Krylov operator's own packing; K3 at
each of the panel LU's shapes and views (`k3_inputs`) with int32 and int64
indices; K5 at the real and the embedded complex pencil's bands, with
float32 and float64 x, and through the operator's `bind` as the Krylov
loop calls it. K3-K6 and their library calls are also timed on the device
alone (`device_ms`), beside the launch floor (one tiny PyTorch launch
timed the same way), since their time per call is mostly the host's.

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
import warnings

# seconds each phase may take before the watchdog ends the run
BUDGET = {"device": 60, "build": 600, "kernels": 300, "banded": 600,
          "slice": 900,
          "entry": 300, "panel": 300, "reduced_lu": 300, "serve": 900,
          "matfree": 600, "general": 600, "krylov": 600, "complex": 900,
          "parallel": 600}
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, SXM, 700 W
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
PARENT_FULL_ORDER_S = 2.33  # the full-order sweep before K1/K2's redesign
REPLACES = {
    "panel_factor": "morfem_tpu/ops/pallas/panel_factor.py:60",
    "mm_words": "morfem_tpu/ops/pallas/fused_mm.py:74",
    "gather_rows": "morfem_tpu/ops/pallas/row_gather.py:45",
    "gauss_jordan_sweep_solve": "morfem_tpu/ops/pallas/reduced_sweep.py:51",
    "banded_matvec_padded": "morfem_tpu/ops/pallas/banded_matvec.py:75",
    "bsr_matmul_f32": "morfem_tpu/ops/block_sparse.py:125",
    "tri_inverse": "morfem_tpu/ops/panel_lu.py:85,127 (not a Pallas kernel)",
}
SOURCES = {
    "panel_factor": "morfem_tpu_torch/csrc/panel_factor.cu",
    "mm_words": "morfem_tpu_torch/csrc/fused_mm.cu",
    "gather_rows": "morfem_tpu_torch/csrc/row_gather.cu",
    "gauss_jordan_sweep_solve": "morfem_tpu_torch/csrc/reduced_sweep.cu",
    "banded_matvec_padded": "morfem_tpu_torch/csrc/banded_matvec.cu",
    "bsr_matmul_f32": "morfem_tpu_torch/csrc/block_sparse.cu",
    "tri_inverse": "morfem_tpu_torch/csrc/tri_inverse.cu",
}
GRID_LIMIT = 65_535  # a grid's y and z dimensions: K1-K3 launch past it
P_34K = 185  # N = 185² = 34,225: the reference's ~34k-DOF stress size
# Cross-section side of the general-route phase: N = 97² = 9,409, the
# reference's in-bench banded size (tools/bench_banded.py). Its RCM
# half-bandwidth (~2p) exceeds band_max_half=128, so morfem() takes the
# general route; the natural ordering's (p+1) does not, so the truncated
# band keeps every coupling and the shifted preconditioner is exact up to
# its shift. At p=185 the truncated band drops the vertical couplings and
# GMRES stalls at ~1e-2 relative residual (PERF.md).
GENERAL_P = 97


class CheckFailed(RuntimeError):
    pass


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def device_ms(fn, reps: int = 20):
    """Device time of `fn` in ms, without the host's time per call: the
    calls are queued behind a sleeping kernel, so they run back to back,
    and CUDA events time them there. None if the host could not queue
    them all while the card slept (a call that synchronises)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(nbytes: float, flops: float, peak: float = H100_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes/bandwidth and flops/peak
    (FP32 on the CUDA cores unless another peak is given)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            current["stack_frame"] = int(m.group(1))
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
    from morfem_tpu_torch.ops.kernels.panel_factor import (
        max_active_clusters, panel_factor_plan, placeable_on,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}  # kernel -> [(principal, record)]
    floor_ms = launch_floor_ms(dev)
    print(f"  launch floor (t.add_(1) on one element, device): "
          f"{_fmt(floor_ms)} ms", flush=True)

    def keep(name, principal, **r):
        results.setdefault(name, []).append((principal, r))

    # K1: the block-pivot diagonal blocks [8, 384, 384] without C̃ (the
    # path's call), the same with C̃, and the full-pivot panel [8, 128, 3456]
    # with C̃ (escalation's chunk of 8); then a batch of 20
    # (solve_chunk=20): the block-pivot blocks (160 CTAs, more than one
    # wave) and its full-pivot factor's panel; the entry phase's 6 and 16
    # seeds under factorization="panel", and one solve (G=1, morfem()'s
    # greedy under "panel"); then the widest full-pivot panels: 384 over
    # Npl=1536 (16 CTAs) and 128 over Npl=8192 (dense_cutoff: the lanes in
    # device memory). Each row names the variant that ran it.
    # The kernel rounds every update as the plain version does, so they
    # agree bit for bit in practice; the gate is 1e-5 of the largest entry.
    # Pivots and availability exactly.
    for (g, p, npl), want_ct, principal in (((8, 384, 384), False, True),
                                            ((8, 384, 384), True, False),
                                            ((8, 128, 3456), True, False),
                                            ((20, 384, 384), False, False),
                                            ((20, 128, 3456), True, False),
                                            ((6, 128, 3456), True, False),
                                            ((1, 128, 3456), True, False),
                                            ((16, 128, 3456), True, False),
                                            ((1, 384, 1536), True, False),
                                            ((1, 128, 8192), True, False)):
        pt = torch.randn((g, p, npl), generator=gen, device=dev)
        av = torch.ones((g, npl), device=dev)
        out_k = panel_factor(pt, av, want_ct=want_ct)
        out_p = panel_factor_plain(pt, av, want_ct=want_ct)
        what = f"{list(pt.shape)} want_ct={want_ct}"
        check(torch.equal(out_k[2], out_p[2]), f"K1 pivots differ at {what}")
        check(torch.equal(out_k[3], out_p[3]), f"K1 avail differs at {what}")
        outs = (0, 1) if want_ct else (0,)
        err = max(float((out_k[i] - out_p[i]).abs().max()) for i in outs)
        scale = max(float(out_p[i].abs().max()) for i in outs)
        check(err <= 1e-5 * scale, f"K1 error {err} at {what}")
        plan = panel_factor_plan(p, npl, want_ct, placeable_on(dev))
        at_once = max_active_clusters(dev, p, npl, want_ct, plan.cluster,
                                      plan.in_smem)
        ms = cuda_ms(lambda: panel_factor(pt, av, want_ct=want_ct), 5)
        plain_ms = cuda_ms(lambda: panel_factor_plain(pt, av, want_ct), 2)
        lib_ms = None
        if p == npl and not want_ct:
            # all lanes available, no C̃: exactly LU with partial pivoting
            # of the [P, P] block, as torch.linalg.lu_factor computes it
            a_blk = pt.transpose(1, 2).contiguous()
            lib_ms = cuda_ms(lambda: torch.linalg.lu_factor(a_blk), 5)
        # work this data needs: step j updates the later rows (and, with
        # C̃, the earlier coefficient rows) over the lanes still available
        # and not the pivot (npl - j - 1 of them here)
        rows = [(p - 1) if want_ct else (p - j - 1) for j in range(p)]
        flops = g * sum(2 * rows[j] * (npl - j - 1) for j in range(p))
        nbytes = 4 * ((2 + want_ct) * g * p * npl + 2 * g * npl + g * p)
        b_ms, b_by = bound(nbytes, flops)
        lib_txt = "None" if lib_ms is None else f"{lib_ms:.4f} (lu_factor)"
        print(f"  K1 panel_factor {what} ({plan.variant}: {plan.cluster} CTAs "
              f"of {plan.threads} threads a panel, {plan.smem} B shared "
              f"memory a CTA, {at_once} such clusters at once): "
              f"max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_txt} bound_ms={b_ms:.5f} ({b_by})",
              flush=True)
        keep("panel_factor", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=list(pt.shape),
             variant=f"{plan.variant}{' with C~' if want_ct else ''}")

    # K2: trailing updates of the block-pivot factor (S = A22 - L21·U12),
    # the U12 = L11⁻¹·A12 product, and the full-pivot trailing update with
    # the transposed coefficient view, each held by `check_k2` (against
    # the FP32 product and the six-product word split: exact word products
    # summed in f32 in another order). The bound is the least time
    # of an f32-true product on this card: six bf16 tensor-core passes
    # (fp32_bound_ms: the same work at the FP32 CUDA-core rate).
    cases = (
        ((8, 3072, 384, 3072), True, -1, False, True),
        ((8, 384, 384, 3072), False, 1, False, False),
        ((8, 3456, 128, 3328), True, 1, True, False),
        ((20, 3072, 384, 3072), True, -1, False, False),  # solve_chunk=20
        ((6, 3456, 128, 3328), True, 1, True, False),  # the entry's seeds
    )
    for (g, m, k, n), with_t, sign, transposed, principal in cases:
        if transposed:
            c = torch.randn((g, k, m), generator=gen, device=dev).transpose(1, 2)
        else:
            c = torch.randn((g, m, k), generator=gen, device=dev)
        r = torch.randn((g, k, n), generator=gen, device=dev)
        t = torch.randn((g, m, n), generator=gen, device=dev) if with_t else None
        _, err, err_split, mean_k, mean_p = check_k2(c, r, t, sign)
        ms = cuda_ms(lambda: mm_words(c, r, t, sign=sign))
        plain_ms = cuda_ms(lambda: mm_words_plain(c, r, t, sign=sign))
        if t is not None:
            lib_ms = cuda_ms(lambda: torch.baddbmm(t, c, r, alpha=sign))
        else:
            lib_ms = cuda_ms(lambda: torch.bmm(c, r))
        flops = 2 * g * m * n * k
        nbytes = 4 * g * (m * k + k * n + m * n * (2 if with_t else 1))
        b_ms, b_by = bound(nbytes, 6 * flops, H100_BF16_FLOPS)
        fp32_ms, _ = bound(nbytes, flops)
        print(f"  K2 mm_words [{g},{m},{k}]@[{g},{k},{n}] t={with_t} "
              f"sign={sign}: max_abs_err={err:.3e} "
              f"err_vs_word_split={err_split:.3e} mean_err_vs_f64="
              f"{mean_k:.3e} (FP32 product: {mean_p:.3e}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}, six bf16 passes) "
              f"fp32_bound_ms={fp32_ms:.5f} "
              f"f32_true_tflops={flops / ms / 1e9:.2f}", flush=True)
        keep("mm_words", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[g, m, k, n])

    # K3 at the panel LU's shapes and views (`k3_inputs`), with int32
    # indices (the panel factor's pivots) and again with int64 ones, which
    # the kernel reads as they are; exact. Per call and on the device
    # alone, beside advanced indexing (the library call) timed both ways.
    for label, src, idx, principal in k3_inputs(dev, gen):
        g, n, w = src.shape
        p = idx.shape[1]
        idx64 = idx.long()
        out_k = gather_rows(src, idx)
        out_p = gather_rows_plain(src, idx)
        out_64 = gather_rows(src, idx64)
        err = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p) and torch.equal(out_64, out_p),
              f"K3 not exact at {label}")
        ms = cuda_ms(lambda: gather_rows(src, idx), 20)
        dev_ms = device_ms(lambda: gather_rows(src, idx))
        plain_ms = cuda_ms(lambda: gather_rows_plain(src, idx))
        batch = torch.arange(g, device=dev)[:, None]
        lib_ms = cuda_ms(lambda: src[batch, idx64], 20)
        lib_dev_ms = device_ms(lambda: src[batch, idx64])
        b_ms, b_by = bound(4 * (2 * g * p * w + g * p), 0)
        print(f"  K3 gather_rows {label}: src={[g, n, w]} strides="
              f"{list(src.stride())} P={p} max_abs_err={err} "
              f"kernel_ms={ms:.4f} (device {_fmt(dev_ms)}) plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} (indexing; device "
              f"{_fmt(lib_dev_ms)}) bound_ms={b_ms:.5f} ({b_by})", flush=True)
        keep("gather_rows", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[g, n, w, p], device_ms=dev_ms,
             library_device_ms=lib_dev_ms)
        del src, idx, idx64, out_k, out_p, out_64
    _kernels_k7(dev, gen, keep)
    _kernels_past_grid_limit(dev, gen)
    _kernels_k4(dev, gen, keep)
    _kernels_k5(dev, gen, keep)
    _kernels_k6(dev, gen, keep)
    rec = {}
    for name, rows in results.items():
        principal = next(r for p, r in rows if p)
        worst = max(r["max_abs_err"] for _, r in rows)
        rec[name] = dict(principal, max_abs_err=worst)
        if "variant" in principal:  # K1, K4: which variant ran each shape
            rec[name]["variants"] = [[r["shape"], r["variant"]]
                                     for _, r in rows]
    return rec


def check_k2(c, r, t, sign):
    """K2 (`mm_words`) on c @ r (+ t) held against the FP32 product
    (`mm_words_plain`) and the six-product word split (the kernel's own
    arithmetic) to 1e-5 of the largest |output|, and, f32-true, no
    farther from the exact (f64) result on average than the FP32 product
    (a drifting tensor-core accumulation fails this). Returns (K2's
    output, its error against the FP32 product and against the word
    split, its and the FP32 product's mean error against f64)."""
    from morfem_tpu_torch.ops.kernels import mm_words, mm_words_plain
    from morfem_tpu_torch.ops.kernels.fused_mm import mm_words_split_plain

    what = f"{list(c.shape)}@{list(r.shape)} t={t is not None}"
    out_k = mm_words(c, r, t, sign=sign)
    out_p = mm_words_plain(c, r, t, sign=sign)
    out_s = mm_words_split_plain(c, r, t, sign=sign)
    err = float((out_k - out_p).abs().max())
    err_split = float((out_k - out_s).abs().max())
    top = float(out_p.abs().max())
    check(err <= 1e-5 * top, f"K2 error {err} at {what}")
    check(err_split <= 1e-5 * top,
          f"K2 error vs the word split {err_split} at {what}")
    exact = sign * (c.double() @ r.double())
    if t is not None:
        exact = exact + t.double()
    mean_k = float((out_k.double() - exact).abs().mean())
    mean_p = float((out_p.double() - exact).abs().mean())
    check(mean_k <= mean_p,
          f"K2 mean error vs f64 {mean_k} > FP32's {mean_p} at {what}")
    return out_k, err, err_split, mean_k, mean_p


def _kernels_k7(dev, gen, keep):
    """K7 against its plain version (two `solve_triangular` calls against
    an identity, with `tril`/`triu`) at the panel LU's shapes: the
    block-pivot factor's diagonal blocks [8, 384, 384] (the sweep's chunk)
    and [20, 384, 384] (solve_chunk=20), contiguous, and the full-pivot
    factor's [6, 27, 128, 128] view of lug [6, 3456, 3456] (the flagship
    step's 6 seeds under factorization="panel"). Blocks: packed LU of
    random matrices plus 2·√P·I. Gate: |T·X − I| within 4× the plain
    version's, zero off the triangles. Per call, and on the device alone
    beside the library pair (`solve_triangular` on built triangles)."""
    import torch

    from morfem_tpu_torch.ops.kernels import tri_inverse, tri_inverse_plain
    from morfem_tpu_torch.ops.panel_lu import _diagonal_blocks

    def blocks(b, p):
        a = torch.randn((b, p, p), generator=gen, device=dev)
        a += 2.0 * p**0.5 * torch.eye(p, device=dev)
        return torch.linalg.lu_factor(a).LU.contiguous()  # column-major

    def inv_err(lu, linv, uinv):
        lu = lu.double().reshape(-1, *lu.shape[-2:])
        eye = torch.eye(lu.shape[-1], dtype=torch.float64, device=dev)
        lo, up = torch.tril(lu, -1) + eye, torch.triu(lu)
        return max(float((lo @ linv.double().reshape(lu.shape) - eye)
                         .abs().max()),
                   float((up @ uinv.double().reshape(lu.shape) - eye)
                         .abs().max()))

    cases = (("[8,384,384] (block-pivot step)", (8, 384), None, True),
             ("[20,384,384] (solve_chunk=20)", (20, 384), None, False),
             ("[6,27,128,128] view of lug [6,3456,3456] (flagship seeds)",
              (6 * 27, 128), (6, 27), False))
    for label, (b, p), view, principal in cases:
        lu = blocks(b, p)
        if view is not None:
            lug = torch.zeros((view[0], view[1] * p, view[1] * p),
                              device=dev)
            lu_v = _diagonal_blocks(lug, p)
            lu_v.copy_(lu.reshape(lu_v.shape))
            lu = lu_v
        linv, uinv = tri_inverse(lu)
        ref = tri_inverse_plain(lu)
        torch.cuda.synchronize()
        err_k, err_p = inv_err(lu, linv, uinv), inv_err(lu, *ref)
        check(err_k <= 4 * err_p + 1e-6,
              f"K7 |T X - I| {err_k} > 4 x the plain's {err_p} at {label}")
        check(bool((torch.triu(linv, 1) == 0).all()
                   and (torch.tril(uinv, -1) == 0).all()),
              f"K7 not triangular at {label}")
        diff = max(float((k - r).abs().max()) for k, r in zip((linv, uinv),
                                                               ref))
        ms = cuda_ms(lambda: tri_inverse(lu), 20)
        dev_ms = device_ms(lambda: tri_inverse(lu))
        plain_ms = cuda_ms(lambda: tri_inverse_plain(lu), 5)
        eye = torch.eye(p, device=dev)
        lo = torch.tril(lu, -1) + eye
        up = torch.triu(lu)
        rhs = eye.expand_as(lo)

        def pair():
            torch.linalg.solve_triangular(lo, rhs, upper=False,
                                          unitriangular=True)
            torch.linalg.solve_triangular(up, rhs, upper=True)

        lib_ms = cuda_ms(pair, 5)
        lib_dev_ms = device_ms(pair, 5)
        # both triangles: P³/3 operations (P³/6 FMA) each; the blocks
        # read once, both inverses written once
        b_ms, b_by = bound(4 * 3 * b * p * p, b * 2 * (p**3 / 3))
        share = None if dev_ms is None else b_ms / dev_ms
        print(f"  K7 tri_inverse {label}: strides={list(lu.stride())} "
              f"max|X - X_plain|={diff:.3e} |TX-I| kernel={err_k:.3e} "
              f"plain={err_p:.3e} kernel_ms={ms:.4f} (device "
              f"{_fmt(dev_ms)}) plain_ms={plain_ms:.4f} library_ms="
              f"{lib_ms:.4f} (two solve_triangular; device "
              f"{_fmt(lib_dev_ms)}) bound_ms={b_ms:.5f} ({b_by}) share="
              f"{'not measured' if share is None else f'{100 * share:.1f} %'}",
              flush=True)
        keep("tri_inverse", principal, max_abs_err=diff, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=list(lu.shape), device_ms=dev_ms,
             library_device_ms=lib_dev_ms)
        del lu, linv, uinv, ref, lo, up


def _kernels_past_grid_limit(dev, gen, g=GRID_LIMIT + 1):
    """K1 (with C̃), K2 (with t) and K3 at a batch one past a grid
    dimension's limit, at small shapes: one wrapper call each, one count
    each, and the plain version's result bit for bit (K2 on small
    integers, whose word products and sums are exact in any order)."""
    import torch

    from morfem_tpu_torch.ops.kernels import (
        gather_rows, gather_rows_plain, launch_counts, mm_words,
        mm_words_plain, panel_factor, panel_factor_plain,
        reset_launch_counts,
    )

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device=dev).float()

    reset_launch_counts()
    panel = torch.randn((g, 8, 16), generator=gen, device=dev)
    av = torch.ones((g, 16), device=dev)
    got = panel_factor(panel, av, want_ct=True)
    ref = panel_factor_plain(panel, av, want_ct=True)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"K1 differs from its plain version at G={g}")
    del panel, av, got, ref
    c, r, t = ints(g, 64, 64), ints(g, 64, 64), ints(g, 64, 64)
    check(torch.equal(mm_words(c, r, t, sign=-1),
                      mm_words_plain(c, r, t, sign=-1)),
          f"K2 differs from its plain version at G={g}")
    del c, r, t
    src = torch.randn((g, 8, 128), generator=gen, device=dev)
    idx = torch.randint(0, 8, (g, 128), generator=gen, device=dev,
                        dtype=torch.int32)
    check(torch.equal(gather_rows(src, idx), gather_rows_plain(src, idx)),
          f"K3 differs from its plain version at G={g}")
    del src, idx
    counts = launch_counts()
    check(all(counts[k] == 1 for k in ("panel_factor", "mm_words",
                                       "gather_rows")),
          f"K1-K3 at G={g}: launch counts {counts}")
    print(f"  K1 [{g},8,16] with C~, K2 [{g},64,64]@[{g},64,64] + t, K3 "
          f"[{g},8,128] P=128 (past the grid's {GRID_LIMIT}): bit for bit "
          f"with their plain versions, one launch each", flush=True)


def launch_floor_ms(dev, reps: int = 50):
    """Device time of one tiny PyTorch launch (``t.add_(1)`` on a
    one-element tensor), queued as `device_ms` queues it: the least that
    one launch costs on this card, the floor of every device time here."""
    import torch

    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.add_(1), reps)


def k3_inputs(dev, gen):
    """K3's inputs as the panel LU passes them: (label, src, idx,
    principal), idx int32 (the panel factor's pivots), distinct rows.

    The block-pivot LU (the waveguide's path) gathers the diagonal block
    (contiguous, `ops/panel_lu.py:205`), the factored L21 rows
    (``out[:, lo:hi, :lo]``, :211) and the A12 rows (``rest[:, :P, P:]``,
    :214) of [8, 3456, 3456] blocks; the full-pivot LU (escalation, and
    every solve under factorization="panel") gathers 128 pivot rows of a
    trailing block and the final permutation.
    The last view starts one column off a 16-byte boundary, so K3 copies
    it with 4-byte loads and stores instead of float4 ones. A sweep at
    solve_chunk=20 gathers the A12 rows of 20 blocks at a time."""
    import torch

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rows(g, n, p):
        return torch.stack([torch.randperm(n, generator=gen, device=dev)[:p]
                            for _ in range(g)]).to(torch.int32)

    g = 8
    yield "A12 rows [8,384,3072]", rand(g, 384, 3072), rows(g, 384, 384), True
    yield ("A12 rows [20,384,3072] (solve_chunk=20)", rand(20, 384, 3072),
           rows(20, 384, 384), False)
    yield ("full-pivot rows [8,3456,3328]", rand(g, 3456, 3328),
           rows(g, 3456, 128), False)
    yield ("final permutation [8,3456,3456]", rand(g, 3456, 3456),
           rows(g, 3456, 3456), False)
    # the entry phase's 6 seeds under factorization="panel": 128 pivot
    # rows of the trailing view ``rest[:, :, 128:]``, the final permutation
    yield ("full-pivot rows rest[:, :, 128:] of [6,3456,3456]",
           rand(6, 3456, 3456)[:, :, 128:], rows(6, 3456, 128), False)
    yield ("final permutation [6,3456,3456]", rand(6, 3456, 3456),
           rows(6, 3456, 3456), False)
    yield ("diagonal block [8,384,384]", rand(g, 384, 384),
           rows(g, 384, 384), False)
    big = rand(g, 3456, 3456)
    yield ("L21 rows out[:, 1536:1920, :1536]", big[:, 1536:1920, :1536],
           rows(g, 384, 384), False)
    yield ("A12 rows rest[:, :384, 384:]", big[:, :384, 384:],
           rows(g, 384, 384), False)
    del big
    yield ("misaligned view [:, :, 1:3073] of [8,384,3076]",
           rand(g, 384, 3076)[:, :, 1:3073], rows(g, 384, 384), False)


def _kernels_k4(dev, gen, keep):
    """K4 at the waveguide's reduced size (K=40, M=2) for the I=100 build
    grid and the 10,000-point serving grid (warp variant), at K=32, M=2
    (an I=10,000 re-sweep and an I=4,000 three-term sweep, the warp
    kernel's KP=32 instance), and at K=84, I=100 (block variant)."""
    import torch

    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve, gauss_jordan_sweep_solve_plain,
    )
    from morfem_tpu_torch.ops.kernels.reduced_sweep import sweep_variant

    m = 2
    for k, i_pts, principal in ((40, 100, False), (40, 10000, True),
                                (32, 10000, False), (32, 4000, False),
                                (84, 100, False)):
        rs = [torch.randn((k, k), generator=gen, device=dev,
                          dtype=torch.float64) for _ in range(3)]
        rs[0] = rs[0] + 4 * k * torch.eye(k, device=dev, dtype=torch.float64)
        inactive = torch.zeros(k, device=dev, dtype=torch.float64)
        inactive[k - 2:] = 1.0  # two inactive (identity-padded) columns
        c = torch.rand((i_pts, 3), generator=gen, device=dev,
                       dtype=torch.float64) + 0.5
        rhs = torch.randn((i_pts, k, m), generator=gen, device=dev,
                          dtype=torch.float64)
        args = (*rs, c, rhs, inactive)
        variant = sweep_variant(k, m)
        out_k = gauss_jordan_sweep_solve(*args)
        out_p = gauss_jordan_sweep_solve_plain(*args)
        err = float((out_k - out_p).abs().max())
        # the same pivots and roundings step for step: bit for bit
        check(torch.equal(out_k, out_p),
              f"K4 ({variant}) differs from its plain version by {err} at "
              f"K={k} I={i_pts}")
        ms = cuda_ms(lambda: gauss_jordan_sweep_solve(*args))
        # the kernel alone: operands already f32 and symmetrized, as
        # fused_reduced_sweep passes them
        r32 = [((r.float() + r.float().T) * 0.5).contiguous() for r in rs]
        args32 = (*r32, c.float(), rhs.float(), inactive.float())
        dev_ms = device_ms(
            lambda: gauss_jordan_sweep_solve(*args32, symmetrize=False))
        plain_ms = cuda_ms(lambda: gauss_jordan_sweep_solve_plain(*args), 2)
        # library: the same function in PyTorch calls, assembly of the
        # f32 systems included, then a batched LU solve; the solve alone
        # (assembly excluded) beside it
        c32, d32, b32 = c.float(), torch.diag(inactive.float()), rhs.float()

        def assemble():
            return (c32[:, 0, None, None] * r32[0]
                    + c32[:, 1, None, None] * r32[1]
                    + c32[:, 2, None, None] * r32[2] + d32)

        lib_ms = cuda_ms(lambda: torch.linalg.solve(assemble(), b32))
        lib_dev_ms = device_ms(lambda: torch.linalg.solve(assemble(), b32))
        a32 = assemble()
        solve_ms = cuda_ms(lambda: torch.linalg.solve(a32, b32))
        flops = i_pts * (5 * k * k + k * k * (k - 1) + 2 * k * k * m)
        nbytes = 4 * (3 * k * k + k + 3 * i_pts + 2 * i_pts * k * m)
        b_ms, b_by = bound(nbytes, flops)
        print(f"  K4 gauss_jordan_sweep_solve ({variant} variant) K={k} "
              f"I={i_pts} M={m}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
              f"(device, kernel alone {_fmt(dev_ms)}) plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} (assembly "
              f"+ linalg.solve; device {_fmt(lib_dev_ms)}; solve alone "
              f"{solve_ms:.4f}) "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        keep("gauss_jordan_sweep_solve", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[i_pts, k, m], variant=variant,
             device_ms=dev_ms, library_device_ms=lib_dev_ms)


def _band_csr(band, half):
    """torch CSR of the banded matrix held in diagonal storage."""
    import torch

    n, bw = band.shape
    rows = torch.arange(n, device=band.device)[:, None].expand(n, bw)
    cols = rows + torch.arange(bw, device=band.device)[None, :] - half
    ok = (cols >= 0) & (cols < n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # beta-state notices
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[ok], cols[ok]]), band[ok], (n, n),
            check_invariants=True)
        return coo.coalesce().to_sparse_csr()


def _kernels_k5(dev, gen, keep):
    """K5 at the Krylov phases' shapes: N=34,225, bw=13, M=2 (the real
    pencil, the principal shape) and N=68,450, bw=23, M=2 (the interleaved
    embedding of the complex phase's pencil), with float32 x and with
    float64 x read in the kernel (bit for bit against the plain version
    either way); then through `BandedAffineOperator.bind` on each Krylov
    pencil with float64 x, as the BiCGSTAB loop calls it, beside CSR SpMM
    with float64 values and x (the library's call for the same work)."""
    import torch

    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.complex_split import embed_sparse_interleaved
    from morfem_tpu_torch.ops.kernels import (
        banded_matvec_padded, banded_matvec_padded_plain,
    )

    def real_pencil(n):  # symmetrized, as the Krylov phase runs it
        return krylov_pencil(n), True

    def embedded_pencil(n):  # the embedding is not symmetric
        mats, _ = complex_krylov_pencil(n // 2)
        return [embed_sparse_interleaved(m) for m in mats], False

    m = 2
    for label, n, half, pencil, principal in (
            ("real", P_34K ** 2, 6, real_pencil, True),
            ("embedded", 2 * P_34K ** 2, 11, embedded_pencil, False)):
        bw = 2 * half + 1
        band = torch.randn((n, bw), generator=gen, device=dev)
        x = torch.randn((n, m), generator=gen, device=dev)
        x64 = torch.randn((n, m), generator=gen, device=dev,
                          dtype=torch.float64)
        out_k = banded_matvec_padded(band, n, bw, half, x)
        out_p = banded_matvec_padded_plain(band, n, bw, half, x)
        err = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p),
              f"K5 differs from its plain version at {label}: {err}")
        f64 = dict(out_dtype=torch.float64)
        out_k64 = banded_matvec_padded(band, n, bw, half, x64, **f64)
        check(out_k64.dtype == torch.float64 and torch.equal(
            out_k64, banded_matvec_padded_plain(band, n, bw, half, x64,
                                                **f64)),
            f"K5 with float64 x differs from its plain version at {label}")
        ms = cuda_ms(lambda: banded_matvec_padded(band, n, bw, half, x), 50)
        dev_ms = device_ms(lambda: banded_matvec_padded(band, n, bw, half,
                                                        x), 50)
        plain_ms = cuda_ms(lambda: banded_matvec_padded_plain(
            band, n, bw, half, x))
        csr = _band_csr(band, half)
        lib_ms = cuda_ms(lambda: csr @ x, 50)
        lib_dev_ms = device_ms(lambda: csr @ x, 50)
        b_ms, b_by = bound(4 * (n * bw + 2 * n * m), 2 * n * bw * m)
        # as the Krylov loop calls it: float64 x in, float64 y out
        mats, symmetrize = pencil(n)
        op = BandedAffineOperator(*mats, symmetrize=symmetrize, device=dev)
        check((op.n, op.bw) == (n, bw),
              f"K5 {label}: operator is N={op.n}, bw={op.bw}")
        c = torch.tensor([1.0, 0.0, 2.25], dtype=torch.float64, device=dev)
        mv = op.bind(c)
        check(mv(x64).dtype == torch.float64, "bind's matvec is not float64")
        bind_ms = cuda_ms(lambda: mv(x64), 50)
        bind_dev_ms = device_ms(lambda: mv(x64), 50)
        b64_ms, _ = bound(4 * n * bw + 8 * 2 * n * m, 2 * n * bw * m)
        csr64 = _band_csr(torch.tensordot(c, op.bands_w, dims=1), op.half)
        lib64_ms = cuda_ms(lambda: csr64 @ x64, 50)
        lib64_dev_ms = device_ms(lambda: csr64 @ x64, 50)
        print(f"  K5 banded_matvec_padded {label} N={n} bw={bw} M={m}: "
              f"max_abs_err={err} (float64 x: bit for bit) kernel_ms="
              f"{ms:.4f} (device {_fmt(dev_ms)}) plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (CSR @ dense; device "
              f"{_fmt(lib_dev_ms)}) bound_ms={b_ms:.5f} ({b_by}); through "
              f"bind with float64 x: {bind_ms:.4f} per call (device "
              f"{_fmt(bind_dev_ms)}, bound {b64_ms:.5f}; float64 CSR @ "
              f"dense {lib64_ms:.4f}, device {_fmt(lib64_dev_ms)})",
              flush=True)
        keep("banded_matvec_padded", principal, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib_ms, shape=[n, bw, m], device_ms=dev_ms,
             library_device_ms=lib_dev_ms, bind_f64_ms=bind_ms,
             bind_f64_device_ms=bind_dev_ms,
             bind_f64_library_ms=lib64_ms,
             bind_f64_library_device_ms=lib64_dev_ms)
        del band, x, x64, out_k, out_p, out_k64, csr, csr64, op, mv


def _kernels_k6(dev, gen, keep):
    """K6 on the Krylov phase's block-sparse operator (N=34,225, M=2)."""
    import torch

    from morfem_tpu_torch.ops.block_sparse import (
        BlockSparseAffineOperator, bsr_from_scipy,
    )
    from morfem_tpu_torch.ops.kernels import (
        bsr_matmul_f32, bsr_matmul_f32_plain,
    )
    from morfem_tpu_torch.ops.kernels.block_sparse import (
        SECTOR_WIDTH, bsr_pack_sectors, sector_matmul_plain,
    )
    from morfem_tpu_torch.ops.sparse import to_csr

    mats = krylov_pencil(P_34K ** 2, scattered=True)
    op = BlockSparseAffineOperator(*mats, device=dev)
    cs = (1.0, 0.0, 2.25)
    c = torch.tensor(cs, dtype=torch.float64, device=dev)
    n, m = op.n, 2
    # the operator's dense blocks, combined: what the first K6 read
    sym = [(mp + mp.T) * 0.5 for mp in mats]
    vals, brows, bcols, nbr, nbc = bsr_from_scipy(sym, n)
    vals2d = torch.tensordot(torch.tensor(cs, dtype=torch.float64),
                             torch.from_numpy(vals), dims=1).float()
    nb = vals2d.shape[0]
    vals2d = vals2d.reshape(nb * op.br, op.bc).to(dev)
    del vals
    brows, bcols = torch.as_tensor(brows, device=dev), torch.as_tensor(
        bcols, device=dev)
    x = torch.randn((n, m), generator=gen, device=dev)
    args = (vals2d, brows, bcols, nbr, nbc, n, op.br, op.bc, x)
    out_p = bsr_matmul_f32_plain(*args)
    scale = float(bsr_matmul_f32_plain(vals2d.abs(), *args[1:8],
                                       x.abs()).max())
    # packed on the fly, and through the operator's own packing (bind);
    # f32 sums over each row in another order than bmm + index_add_
    out_k = bsr_matmul_f32(*args)
    err = float((out_k - out_p).abs().max())
    err_bind = float((op.bind(c)(x) - out_p).abs().max())
    check(max(err, err_bind) <= 1e-5 * scale,
          f"K6 error {err} (through bind {err_bind}, scale {scale})")
    packing = op._combined(c)
    nnz = int((op.sectors.vals != 0).any(0).sum())  # the union nonzeros
    nsec = packing.cols.numel()
    # the packing on the fly runs on the card: its time, and its sectors
    # are the operator's
    blocks = vals2d.reshape(nb, op.br, op.bc)
    pack_ms = cuda_ms(lambda: bsr_pack_sectors(blocks, brows, bcols, n), 3)
    check(torch.equal(bsr_pack_sectors(blocks, brows, bcols, n).cols,
                      packing.cols), "K6 packing on the card differs from "
          "the operator's")
    p32 = packing._replace(vals=packing.vals.float().contiguous())
    def kernel():
        return bsr_matmul_f32(None, None, None, nbr, nbc, n, op.br, op.bc, x,
                              packing=p32)

    ms = cuda_ms(kernel, 50)
    dev_ms = device_ms(kernel, 50)
    plain_ms = cuda_ms(lambda: bsr_matmul_f32_plain(*args))
    sector_plain_ms = cuda_ms(lambda: sector_matmul_plain(p32, x))
    a = sum(cp * mp for cp, mp in zip(cs, sym))
    csr = to_csr(a, dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: csr @ x, 50)
    lib_dev_ms = device_ms(lambda: csr @ x, 50)
    # the work itself: the nonzeros once, x read and y written once, and
    # the packing's indices; the first K6's bound counted the blocks
    nbytes = 4 * nnz + 4 * 2 * n * m + 4 * (nsec + n + 1)
    b_ms, b_by = bound(nbytes, 2 * nnz * m)
    dense_ms, _ = bound(4 * nb * op.br * op.bc + 4 * nb + 4 * (nbr + 1)
                        + 4 * 2 * n * m, 2 * nb * op.br * op.bc * m)
    print(f"  K6 bsr_matmul_f32 N={n} M={m} blocks={nb} ({op.br}x{op.bc}) "
          f"nnz={nnz} (csr_nnz={a.nnz}, fill "
          f"{nnz / (nb * op.br * op.bc):.4f}) sectors={nsec} of width "
          f"{SECTOR_WIDTH} ({4 * nsec * SECTOR_WIDTH / 1e6:.3f} MB): "
          f"max_abs_err={err:.3e} (through bind {err_bind:.3e}) "
          f"kernel_ms={ms:.4f} (device {_fmt(dev_ms)}) plain_ms="
          f"{plain_ms:.4f} (blocks; over the packing {sector_plain_ms:.4f}) "
          f"library_ms={lib_ms:.4f} (CSR @ dense; device "
          f"{_fmt(lib_dev_ms)}) bound_ms={b_ms:.5f} ({b_by}) [dense blocks "
          f"{dense_ms:.5f}]", flush=True)
    print(f"  K6 packing on the fly (bsr_pack_sectors on the card): "
          f"{pack_ms:.3f} ms", flush=True)
    keep("bsr_matmul_f32", True, max_abs_err=max(err, err_bind), ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
         shape=[nnz, n, m], device_ms=dev_ms, library_device_ms=lib_dev_ms)


def krylov_pencil(n, scattered=False, half=6, seed=0):
    """A diagonally dominant banded pencil (a0, 0, a2) as SciPy CSR, as the
    JAX package's matrix-free greedy tests build it; with ``scattered``, a0
    also carries a weak scattered off-band remainder (as its block-sparse
    tests add), so the block-sparse operator holds far blocks."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)

    def band(scale, shift):
        diags = [rng.normal(size=n - abs(d)) * scale / (1 + abs(d))
                 for d in range(-half, half + 1)]
        a = sp.diags(diags, offsets=range(-half, half + 1)).tocsr()
        return ((a + a.T) * 0.5 + sp.eye(n) * shift).tocsr()

    a0 = band(1.0, 12.0)
    a2 = band(0.3, 0.0)
    if scattered:
        nfar = n // 16
        far = sp.coo_matrix(
            (0.05 * rng.standard_normal(nfar),
             (rng.integers(0, n, nfar), rng.integers(0, n, nfar))),
            shape=(n, n))
        a0 = (a0 + far + far.T).tocsr()
    return a0, sp.csr_matrix((n, n)), a2


def tiled_waveguide_chunk(dev, points=8, n=3411, band=3456):
    """The 10× tiled waveguide (N=34,110 from the bundled N=3411 data; blocks
    of ``band``) prepared for the banded full-order sweep at the first
    ``points`` of the ``waveguide_34110.full_sparse`` cell's 100 points of
    3–5 GHz: one chunk of that sweep."""
    import numpy as np

    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.apps import waveguide as wg

    data = wg.load_waveguide_data(n_fallback=n)
    return wg.tiled_waveguide_system(
        np.linspace(3e9, 5e9, 100)[:points], data, 10,
        MorfemConfig(band_max_half=band), device=dev)


def schur_complements(sys_, steps):
    """{step: S [G, b, b]}: the Schur complements that the block-Thomas
    factor of the G points of ``sys_`` inverts at the block ``steps``,
    recomputed from that factor's h as the factor forms them."""
    from morfem_tpu_torch.ops import block_tridiag as bt

    c, _ = sys_.coefficients(sys_.domain)
    l, d, u = sys_.op.blocks(c.to(sys_.b.dtype),
                             bt._block_size(sys_.op.half))
    fac = bt.block_tridiag_factor(l, d, u, sys_.op.n)
    _, cols = bt._coupling_sets(l, u)
    return {i: bt._schur_complement(l, d, fac.h, cols, i).clone()
            for i in steps}


def inverse_quality(s, xs, panel=128):
    """For each x of ``xs``, inverses of the matrices of s [G, b, b], a dict
    of [G] float64 tensors, all against the float64 inverse (`inv_ex` of
    each matrix in float64): ``err`` ‖X − S⁻¹‖_F/‖S⁻¹‖_F; ``kappa``
    κ_F(S) = ‖S‖_F·‖S⁻¹‖_F; ``right`` the largest residual of a column
    panel, ‖(S·X − I)[:, J]‖_F/√P, and ``left`` of a row panel,
    ‖(X·S − I)[J, :]‖_F/√P, over the panels J of ``panel`` columns or
    rows. A panel of X left wrong reads about 1 in one of them."""
    import torch

    s64 = s.double()
    g, b, _ = s.shape
    ref = torch.stack([torch.linalg.inv_ex(m)[0] for m in s64])
    eye = torch.eye(b, dtype=torch.float64, device=s.device)

    def norm(a, dims=(-2, -1)):
        return torch.linalg.norm(a, dim=dims)

    kappa = norm(s64) * norm(ref)
    out = []
    for x in xs:
        x64 = x.double()
        right = (s64 @ x64 - eye).reshape(g, b, b // panel, panel)
        left = (x64 @ s64 - eye).reshape(g, b // panel, panel, b)
        out.append({
            "err": norm(x64 - ref) / norm(ref), "kappa": kappa,
            "right": (norm(right, (1, 3)) / panel ** 0.5).amax(dim=1),
            "left": (norm(left, (2, 3)) / panel ** 0.5).amax(dim=1),
        })
        del right, left
    return out


def _banded_k2(dev, gen, g=8, b=3456, p=128):
    """K2 at the shapes and views of `_invert_points`' substitutions: the
    top-level update of each (K up to b/2, operands strided sub-blocks of
    one [G, b, b] LU and of x, the addend a view of x written back) and a
    leaf (a K7 block of [G, nb, P, P] against P rows of x), each timed
    beside the FP32 product."""
    import torch

    from morfem_tpu_torch.ops.kernels import mm_words, mm_words_plain

    nb = b // p
    m = nb // 2 * p
    lug = torch.randn((g, b, b), generator=gen, device=dev)
    inv = torch.randn((g, nb, p, p), generator=gen, device=dev)
    x = torch.randn((g, b, b), generator=gen, device=dev)
    for label, c, r, t in (
            ("lower update", lug[:, m:, :m], x[:, :m, :m], x[:, m:, :m]),
            ("upper update", lug[:, :m, m:], x[:, m:, :], x[:, :m, :]),
            ("leaf", inv[:, nb // 2], x[:, m:m + p, :m + p], None)):
        sign = 1 if t is None else -1
        out, err, err_split, mean_k, mean_p = check_k2(c, r, t, sign)
        ms = cuda_ms(lambda: mm_words(c, r, t, sign=sign), 5)
        plain_ms = cuda_ms(lambda: mm_words_plain(c, r, t, sign=sign), 5)
        if t is not None:
            t.copy_(out)
        print(f"  K2 {label} {list(c.shape)}@{list(r.shape)} strides "
              f"{list(c.stride())}, {list(r.stride())} t={t is not None}: "
              f"max_abs_err={err:.3e} err_vs_word_split={err_split:.3e} "
              f"mean_err_vs_f64={mean_k:.3e} (FP32 product: {mean_p:.3e}) "
              f"kernel_ms={ms:.4f} fp32_ms={plain_ms:.4f}", flush=True)
    del lug, inv, x


def banded_phase(dev, points=8, steps=(0, 5), n=3411, band=3456):
    """The banded full-order sweep's batched Schur-complement inverses
    (`ops/block_tridiag.py::_invert_points`) on the cell's pencil: K2 at
    the substitutions' shapes (`_banded_k2`); both routes timed at G = 1,
    2, 4, 8 on step 0's [G, 3,456, 3,456] complements (the sweep that
    fixes ``POINTS_TO_BATCH``) and the LU's share at G = 8; each step's
    S⁻¹ against `inv_ex`'s and the float64 inverse (`inverse_quality`:
    error within 0.02·κ_F·ε, each panel's residual within 4× `inv_ex`'s);
    then one chunk's sweep (`solve_sweep_banded`) with its launches and
    ``batched_inverses`` counted, its GSM against the sweep of one point a
    chunk (`inv_ex`). Returns the chunk's launch counts."""
    import torch

    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.apps.waveguide import full_order_gsm
    from morfem_tpu_torch.ops import block_tridiag as bt
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from morfem_tpu_torch.ops.panel_lu import panel_lu_factor

    gen = torch.Generator(device=dev).manual_seed(1)
    _banded_k2(dev, gen, b=band)
    sys_ = tiled_waveguide_chunk(dev, points, n, band)
    kept = schur_complements(sys_, steps)
    s8 = kept[steps[0]]
    wins = []
    for g in (1, 2, 4, 8):
        s = s8[:g].contiguous()
        each_ms = cuda_ms(lambda: bt._inverse_each(s), 5)
        together_ms = cuda_ms(lambda: bt._invert_points(s), 5)
        if together_ms < each_ms:
            wins.append(g)
        print(f"  invert [{g},{s.shape[1]},{s.shape[2]}]: inv_ex each "
              f"{each_ms:.3f} ms, together {together_ms:.3f} ms", flush=True)
    lu_ms = cuda_ms(lambda: panel_lu_factor(s8), 5)
    print(f"  together at G=8: panel_lu_factor {lu_ms:.3f} ms; together "
          f"from G={wins[0] if wins else None} on this card "
          f"(POINTS_TO_BATCH={bt.POINTS_TO_BATCH})", flush=True)
    eps = torch.finfo(torch.float32).eps
    for step, s in kept.items():
        got, each = inverse_quality(
            s, (bt._invert_points(s), bt._inverse_each(s)))
        print(f"  S⁻¹ of step {step}: kappa_F "
              f"{[f'{v:.3e}' for v in got['kappa'].tolist()]}", flush=True)
        for label, q in (("together", got), ("inv_ex", each)):
            print(f"    {label}: " + " ".join(
                f"{k}={[f'{v:.2e}' for v in q[k].tolist()]}"
                for k in ("err", "right", "left")), flush=True)
        check(bool((got["err"] <= 0.02 * got["kappa"] * eps).all()),
              f"S⁻¹ of step {step} off the f64 inverse past 0.02·κ·ε")
        for side in ("right", "left"):
            check(bool((got[side] <= 4 * each[side]).all()),
                  f"S⁻¹ of step {step}: a panel's {side} residual past 4× "
                  f"inv_ex's")
    del kept, s8
    cfg = MorfemConfig(band_max_half=band)
    bt.reset_factor_counters()
    bt.reset_banded_sweep_counters()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gsm = full_order_gsm(sys_, cfg)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    counts = launch_counts()
    inverses = list(bt.block_tridiag_factor.batched_inverses)
    escalations = bt.solve_sweep_banded.escalations
    passes = list(bt.solve_sweep_banded.chunk_iterations)
    nb = -(-sys_.op.n // band)  # block steps a factor
    t0 = time.perf_counter()
    gsm_each = full_order_gsm(sys_, cfg.replace(solve_chunk=1))
    torch.cuda.synchronize()
    t_each = time.perf_counter() - t0
    diff = float((gsm - gsm_each).abs().max())
    print(f"  sweep of {points} points, N={sys_.op.n}: {t_sweep:.3f} s "
          f"(one point a chunk: {t_each:.3f} s), passes {passes}, "
          f"escalations {escalations}, batched_inverses {inverses}, "
          f"max|GSM - GSM one point a chunk| {diff:.3e}, kernels "
          f"{json.dumps(counts)}", flush=True)
    check(inverses == [points] * nb,
          f"batched_inverses {inverses}, not {nb} steps of {points}")
    check(bt.block_tridiag_factor.batched_inverses == inverses,
          "a chunk of one point inverted its complements together")
    check(escalations == 0, f"{escalations} points escalated")
    check(counts["panel_factor"] == nb * band // 128
          and counts["tri_inverse"] == nb
          and counts["gather_rows"] > 0 and counts["mm_words"] > 0,
          f"the chunk's launches {counts}")
    # both at 10·ε·‖b‖ in f64; the cell holds the GSM to 1e-7
    check(diff <= 1e-9, f"the two sweeps' GSMs differ by {diff}")
    return counts


def slice_phase(dev, n_expected=3411, points=100):
    """The waveguide end to end: MOR GSM vs full-order GSM, spot checks,
    and the kernels' launch counts over the MOR + full-order run."""
    import numpy as np
    import torch

    from morfem_tpu_torch import MorfemConfig, PhaseTimer
    from morfem_tpu_torch.apps.waveguide import (
        generalized_scattering_matrix, load_waveguide_data, mor_gsm,
        waveguide_system,
    )
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from morfem_tpu_torch.ops.panel_lu import (
        reset_sweep_counters, solve_sweep_panel,
    )
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
    torch.cuda.synchronize()
    reset_sweep_counters()
    t0 = time.perf_counter()
    with timer.phase("full-order sweep"):
        x_full = solve_sweep(sys_, cfg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    _, cb = sys_.coefficients(sys_.domain)
    gsm_full = generalized_scattering_matrix(sys_.domain, x_full,
                                             cb[:, None, None] * sys_.b)
    counts = launch_counts()
    escalations = solve_sweep_panel.escalations
    chunk_its = list(solve_sweep_panel.chunk_iterations)
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
    print(f"  slice full-order sweep: full_s={t_full:.3f} (parent "
          f"{PARENT_FULL_ORDER_S} s, PERF.md) block_pivot_escalations="
          f"{escalations} refinement_iterations_per_chunk={chunk_its}",
          flush=True)
    check(err_max < 1e-8, f"max|S_mor - S_full| = {err_max} >= 1e-8")
    check(escalations == 0,
          f"{escalations} chunks escalated to the full-pivot factor")

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
    for name in ("panel_factor", "mm_words", "gather_rows",
                 "tri_inverse"):
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    return counts, sys_, rm, gsm_full, x_full, t_full


def _library_gsm(sys_, count, cfg):
    """The port's library route at the step's seeds: equally distributed
    basis, projection, batched-LU sweep, GSM (complex128 [I, M, M])."""
    from morfem_tpu_torch import equally_distributed_basis, project, sweep
    from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix

    rm = project(sys_, equally_distributed_basis(sys_, cfg, count=count))
    x = sweep(rm, cfg)
    _, cb = rm.coefficients(rm.domain)
    return generalized_scattering_matrix(rm.domain, x,
                                         cb[:, None, None] * rm.b_r)


def _step_run(label, step, args, smi, eager_reps=5, replay_reps=20):
    """Eager step, capture, replay: check the replay against the eager
    step, time all three, report segments and unitarity. Returns (GSM of
    the replay as complex128, launches during the eager step, launches
    during `capture`)."""
    import torch

    from morfem_tpu_torch.device import median_event_ms, median_wall_s
    from morfem_tpu_torch.entry import capture
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    eager = step(*args)
    torch.cuda.synchronize()
    eager_counts = launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    captured = capture(step, args)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    capture_counts = launch_counts()
    out = captured()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"entry {label}: non-finite output of the replay")
    diff = max(float((o - e).abs().max()) for o, e in zip(out, eager))
    same = all(torch.equal(o, e) for o, e in zip(out, eager))
    check(diff <= 1e-12, f"entry {label}: replay differs from the eager step "
          f"by {diff}")
    eager_s = median_wall_s(lambda: step(*args), eager_reps,
                            args[0].device)
    replay_ms = median_event_ms(captured, replay_reps)
    seg_ms = []
    for seg in captured.segments:
        if seg.graph is not None:
            seg_ms.append(median_event_ms(seg.graph.replay, replay_reps))
        else:
            seg_ms.append(median_event_ms(lambda: seg.fn(*seg.args),
                                           replay_reps))
    gsm = torch.complex(out[1], out[2])
    m = gsm.shape[-1]
    eye = torch.eye(m, dtype=gsm.dtype, device=gsm.device)
    unitarity = float(torch.linalg.norm(gsm.mH @ gsm - eye,
                                        dim=(-2, -1)).max())
    graphs = sum(seg.graph is not None for seg in captured.segments)
    segs = "; ".join(
        f"{seg.label} ({'graph' if seg.graph is not None else 'eager'}) "
        f"{ms:.4f} ms" for seg, ms in zip(captured.segments, seg_ms))
    kern = {k: v for k, v in eager_counts.items() if v}
    cap_kern = {k: v for k, v in capture_counts.items() if v}
    print(f"  entry {label}: shapes {[list(o.shape) for o in out]} "
          f"replay_vs_eager max_abs={diff:.3e} bit_for_bit={same} "
          f"eager_step_s={eager_s:.4f} (wall, median of {eager_reps}) "
          f"replay_ms={replay_ms:.4f} (CUDA events, median of "
          f"{replay_reps}) capture_s={t_capture:.3f} segments="
          f"{len(captured.segments)} ({graphs} graphs; split by the thin "
          f"SVD: torch.linalg.svd checks its info on the host) "
          f"max_point_fro|S^H S - I|={unitarity:.3e} ({smi})", flush=True)
    print(f"  entry {label} segments: {segs}", flush=True)
    print(f"  entry {label} launches: eager step {json.dumps(kern)}, "
          f"capture() (side-stream warm-up + graph record) "
          f"{json.dumps(cap_kern)}", flush=True)
    return gsm, eager_counts, capture_counts


def _seed_solve_breakdown(a0, a1, a2, b, domain, idx, smi):
    """Where the default seed-solve graph's time goes: one factorization of
    the seeds (one cuSOLVER call per seed, `lu_factor_each`), and one
    refinement pass's apply (`lu_solve` on the batch) and f64 residual
    product, each timed alone (CUDA events, median of 5)."""
    import torch

    from morfem_tpu_torch.apps.waveguide import b_coefficient
    from morfem_tpu_torch.device import median_event_ms
    from morfem_tpu_torch.ops.solve import lu_factor_each

    ts = domain[idx]
    a = a0 + (ts**2)[:, None, None] * a2 + ts[:, None, None] * a1
    a = (a + a.transpose(-1, -2)) * 0.5
    a32 = a.to(torch.float32)
    rhs = b_coefficient(ts)[:, None, None] * b
    lu, piv = lu_factor_each(a32)
    r32 = rhs.to(torch.float32)
    factor_ms = median_event_ms(lambda: lu_factor_each(a32), 5)
    apply_ms = median_event_ms(lambda: torch.linalg.lu_solve(lu, piv, r32),
                                5)
    resid_ms = median_event_ms(lambda: rhs - a @ rhs, 5)
    print(f"  entry seed solves, {idx.shape[0]} seeds at N={a0.shape[0]}: "
          f"factor (lu_factor_ex per seed) {factor_ms:.4f} ms; one "
          f"refinement pass: apply (lu_solve) {apply_ms:.4f} ms + f64 "
          f"residual {resid_ms:.4f} ms ({smi})", flush=True)


def entry_phase(dev, sys_, gsm_full, smi):
    """The flagship step (`morfem_tpu_torch/entry.py`) captured as CUDA
    graphs: (a) entry()'s example, (b) the slice's waveguide at 6 and 16
    seeds against the library route, (c) factorization="panel" at 6
    seeds. Returns the kernels' launches over (c)'s eager step and
    capture."""
    import numpy as np
    import torch

    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.device import median_wall_s
    from morfem_tpu_torch.entry import entry, flagship_step

    fn, args = entry(dev)
    _step_run("(a) entry() example N=256", fn, args, smi)

    a0, a1, a2 = sys_.operators()
    i_pts = sys_.num_points
    base = (a0, a1, a2, sys_.b, sys_.domain)
    gsm6 = None
    for seeds in (6, 16):
        idx = torch.as_tensor(np.linspace(0, i_pts - 1, seeds).astype(int),
                              device=dev)
        label = f"(b) N={sys_.n} I={i_pts} {seeds} seeds"
        gsm, _, _ = _step_run(label, flagship_step(), base + (idx,), smi)
        lib = _library_gsm(sys_, seeds, MorfemConfig())
        lib_s = median_wall_s(
            lambda: _library_gsm(sys_, seeds, MorfemConfig()), 3, dev)
        d_lib = float((gsm - lib).abs().max())
        d_full = float((gsm - gsm_full).abs().max())
        print(f"  entry {label}: max|S_step-S_library|={d_lib:.3e} "
              f"max|S_step-S_full|={d_full:.3e} (reported, not gated: "
              f"equally spaced seeds are not the greedy) library_route_s="
              f"{lib_s:.4f} (host refinement loops, wall, median of 3)",
              flush=True)
        check(d_lib < 1e-9, f"entry {label}: step vs library route {d_lib}")
        if seeds == 6:
            gsm6, idx6 = gsm, idx
        _seed_solve_breakdown(*base, idx, smi)

    label = f"(c) N={sys_.n} I={i_pts} 6 seeds factorization=panel"
    gsm_p, eager_counts, capture_counts = _step_run(
        label, flagship_step({"factorization": "panel"}), base + (idx6,),
        smi)
    d_p = float((gsm_p - gsm6).abs().max())
    print(f"  entry {label}: max|S_panel-S_default|={d_p:.3e}", flush=True)
    check(d_p < 1e-9, f"entry {label}: panel vs default step {d_p}")
    for name in ("panel_factor", "mm_words", "gather_rows",
                 "tri_inverse"):
        check(eager_counts[name] > 0,
              f"entry {label}: {name} not launched by the step")
        # the warm-up launches what the eager step launches, and the graph
        # records as many: the kernels are inside the captured program
        check(capture_counts[name] == 2 * eager_counts[name],
              f"entry {label}: {name} counted {capture_counts[name]} in "
              f"capture(), expected 2 x {eager_counts[name]}")
    return {k: eager_counts[k] + capture_counts[k] for k in eager_counts}


def panel_phase(dev, sys_, gsm_full, smi):
    """morfem(factorization="panel") on the slice's waveguide: every greedy
    snapshot solve (G=1) through the panel LU's full-pivot factor (K1 with
    C̃ at [1, 128, 3456], K2, K3), the GSM against the full-order GSM.
    Returns the kernels' launches over that run."""
    import torch

    from morfem_tpu_torch import MorfemConfig, PhaseTimer, morfem
    from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = MorfemConfig(factorization="panel", error_threshold=1e-10)
    timer = PhaseTimer(device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    x, q, *_, b_r = morfem(
        sys_.domain, sys_.a0, sys_.a1, sys_.a2, sys_.b, t_b=sys_.t_b,
        config=cfg, timer=timer, device=dev)
    torch.cuda.synchronize()
    t_panel = time.perf_counter() - t0
    counts = launch_counts()
    _, cb = sys_.coefficients(sys_.domain)
    gsm = generalized_scattering_matrix(sys_.domain, x,
                                        cb[:, None, None] * b_r)
    check(bool(torch.isfinite(gsm).all()), "panel morfem(): non-finite GSM")
    err = float((gsm - gsm_full).abs().max())
    print(f"  panel morfem(factorization='panel') N={sys_.n}: Nr={q.shape[1]} "
          f"total_s={t_panel:.3f} (wall, one call) greedy_s="
          f"{timer.times['projection base']:.3f} K1_launches="
          f"{counts['panel_factor']} K2={counts['mm_words']} "
          f"K3={counts['gather_rows']} max|S_mor-S_full|={err:.3e} ({smi})",
          flush=True)
    check(err < 1e-8, f"panel morfem(): max|S_mor - S_full| = {err} >= 1e-8")
    for name in ("panel_factor", "mm_words", "gather_rows",
                 "tri_inverse"):
        check(counts[name] > 0,
              f"panel morfem(): kernel {name} was not launched")
    return counts


def reduced_lu_phase(dev, sys_, gsm_full, serve_points=10000):
    """The waveguide through morfem() with the reduced LU sweep on K4, then
    the serving re-sweep of the trimmed model on a dense grid. Returns K4's
    launches and the re-sweep's seconds."""
    import torch

    from morfem_tpu_torch import MorfemConfig, PhaseTimer, morfem, sweep
    from morfem_tpu_torch.apps.waveguide import generalized_scattering_matrix
    from morfem_tpu_torch.mor.reduced import (
        ReducedModel, assemble_reduced, solve_reduced_batch,
    )
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = MorfemConfig(error_threshold=1e-10, sweep_method="lu",
                       use_pallas_reduced_sweep=True)
    timer = PhaseTimer(device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    x, q, r0, r1, r2, b_r = morfem(
        sys_.domain, sys_.a0, sys_.a1, sys_.a2, sys_.b, t_b=sys_.t_b,
        config=cfg, timer=timer, device=dev)
    _, cb = sys_.coefficients(sys_.domain)
    gsm = generalized_scattering_matrix(sys_.domain, x,
                                        cb[:, None, None] * b_r)
    torch.cuda.synchronize()
    t_mor = time.perf_counter() - t0
    k4_build = launch_counts()["gauss_jordan_sweep_solve"]
    err = float((gsm - gsm_full).abs().max())
    print(f"  reduced_lu N={sys_.n} Nr={q.shape[1]} mor_s={t_mor:.3f} "
          f"max|S_mor(K4 LU)-S_full|={err:.3e} K4_launches={k4_build}",
          flush=True)
    for name, t in timer.times.items():
        print(f"  reduced_lu phase '{name}': {t:.3f} s", flush=True)
    check(bool(torch.isfinite(gsm).all()), "non-finite GSM (K4 LU sweep)")
    check(err < 1e-8, f"max|S_mor(K4 LU) - S_full| = {err} >= 1e-8")
    check(k4_build > 0, "K4 was not launched by the reduced LU sweep")

    rm = ReducedModel(domain=sys_.domain, q=q, r0=r0, r1=r1, r2=r2, b_r=b_r,
                      ncols=q.shape[1], t_a0=sys_.t_a0, t_a1=sys_.t_a1,
                      t_a2=sys_.t_a2, t_b=sys_.t_b)
    ts = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                        device=dev)
    sweep(rm, cfg, ts)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xs = sweep(rm, cfg, ts)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    k4_serve = launch_counts()["gauss_jordan_sweep_solve"]
    a, rhs = assemble_reduced(rm, ts, cfg)
    xl = solve_reduced_batch(a, rhs, cfg)
    rel = float(torch.linalg.norm(xs - xl) / torch.linalg.norm(xl))
    print(f"  reduced_lu serve I={serve_points}: sweep_s={t_serve:.4f} "
          f"points_per_s={serve_points / t_serve:.1f} "
          f"rel_vs_batched_lu={rel:.3e} K4_launches={k4_serve}", flush=True)
    check(rel < 1e-9, f"10k re-sweep rel error {rel} >= 1e-9")
    check(k4_serve > 0, "K4 was not launched by the serving re-sweep")
    return k4_build + k4_serve, t_serve


def serve_phase(dev, sys_, rm, gsm_full, x_full, t_full, serve_points=10000,
                cr_p=P_34K, study_sizes=range(3, 30), recheck=(6, 12)):
    """The rest of the single-GPU surface on the slice's waveguide:
    (1) checkpointed serving — the trimmed model saved, loaded with the
    port coefficient (and with the default t_b, which must warn), and
    re-swept through K4 on 10,000 points, bit for bit as the in-memory
    model; (2) the full-order spectral oracle (prepare on the card in f64,
    the 100-point sweep against the slice phase's panel-LU sweep `x_full`
    (`t_full` seconds) and f64 solves, its GSM against the full-order GSM,
    then a 10,000-point sweep); (3) the Gauss–Jordan inverse, solve and
    morfem(factorization="gj"); (4) cyclic reduction against block Thomas
    on the N=cr_p² pencil at 3 points; (5) the basis-size study on
    `x_full` against an independent recompute. Returns K4's launches in
    part 1."""
    import os
    import tempfile

    import numpy as np
    import torch

    from morfem_tpu_torch import (
        MorfemConfig, PhaseTimer, equally_distributed_basis, gj_inverse_f32,
        gj_solve_refined, load_reduced_model, morfem, prepare_spectral,
        prepare_spectral_full, project, save_reduced_model,
        spectral_full_sweep, spectral_sweep, sweep,
    )
    from morfem_tpu_torch.apps.studies import basis_size_study
    from morfem_tpu_torch.apps.waveguide import (
        b_coefficient, generalized_scattering_matrix,
    )
    from morfem_tpu_torch.mor.reduced import assemble_reduced
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = MorfemConfig(error_threshold=1e-10)
    cfg_k4 = cfg.replace(sweep_method="lu", use_pallas_reduced_sweep=True)
    points = sys_.num_points
    _, cb = sys_.coefficients(sys_.domain)
    b_full = cb[:, None, None] * sys_.b

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (1) checkpointed serving through K4
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "waveguide_model")
        save_reduced_model(path, rm, metadata={"n_dof": sys_.n})
        size = os.path.getsize(path + ".npz")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            load_reduced_model(path, device=dev)
        warned = any("t_b" in str(w.message) for w in caught)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            loaded = load_reduced_model(path, t_b=b_coefficient, device=dev)
    check(warned, "load with the default t_b did not warn")
    check(loaded.q.device.type == "cuda" and loaded.ncols == rm.ncols,
          "the loaded model is not on the card")
    ts = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                        device=dev)
    x_mem = sweep(rm, cfg_k4, ts)
    x_loaded, t_k4 = timed(lambda: sweep(loaded, cfg_k4, ts))
    same = bool(torch.equal(x_loaded, x_mem))
    sm = prepare_spectral(loaded, cfg)
    spectral_sweep(sm, ts)  # warm-up
    _, t_spec = timed(lambda: spectral_sweep(sm, ts))
    counts = launch_counts()
    print(f"  serve checkpoint: {size} bytes, Nr={loaded.ncols}, default "
          f"t_b warned={warned}; K4 re-sweep of the loaded model I="
          f"{serve_points}: sweep_s={t_k4:.4f} points_per_s="
          f"{serve_points / t_k4:.1f} equal_to_in_memory={same}; "
          f"spectral_sweep_s={t_spec:.4f} points_per_s="
          f"{serve_points / t_spec:.1f} K4_launches="
          f"{counts['gauss_jordan_sweep_solve']}", flush=True)
    check(same, "K4 on the loaded model differs from the in-memory model")
    k4_launches = counts["gauss_jordan_sweep_solve"]
    check(k4_launches > 0, "K4 was not launched by the checkpointed re-sweep")
    del x_mem, x_loaded

    # (2) the full-order spectral oracle beside the panel-LU sweep
    fs, t_prep = timed(lambda: prepare_spectral_full(sys_, cfg))
    print(f"  serve spectral_full prepare (f64 on the card): "
          f"prepare_s={t_prep:.3f} sigma={fs.sigma:.6e} "
          f"swapped={fs.swapped}", flush=True)
    x_spec, t_spec100 = timed(lambda: spectral_full_sweep(fs))
    worst = float((torch.linalg.norm(x_spec - x_full, dim=(1, 2))
                   / torch.linalg.norm(x_full, dim=(1, 2))).max())
    spot = 0.0
    for i in (0, points // 2, points - 1):
        a, b = assemble_at(sys_, sys_.domain[i], symmetrize=cfg.symmetrize)
        xr = torch.linalg.solve(a, b)
        spot = max(spot, float(torch.linalg.norm(x_spec[i] - xr)
                               / torch.linalg.norm(xr)))
    gsm_spec = generalized_scattering_matrix(sys_.domain, x_spec, b_full)
    gsm_err = float((gsm_spec - gsm_full).abs().max())
    ts_big = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                            device=dev)
    spectral_full_sweep(fs, ts_big)  # warm-up
    x_big, t_big = timed(lambda: spectral_full_sweep(fs, ts_big))
    out_gb = x_big.numel() * x_big.element_size() / 1e9
    big_ms = cuda_ms(lambda: spectral_full_sweep(fs, ts_big), reps=3)
    big_flop = 2.0 * sys_.n * sys_.n * serve_points * sys_.m  # back @ p2
    print(f"  serve spectral_full I={points}: sweep_s={t_spec100:.4f} "
          f"(the slice phase's panel-LU sweep_s={t_full:.3f}) "
          f"max_point_rel_vs_panel_lu={worst:.3e} "
          f"rel_vs_torch_solve(3 points)={spot:.3e} "
          f"max|S_spectral-S_full|={gsm_err:.3e}; I={serve_points}: "
          f"sweep_s={t_big:.4f} device_ms={big_ms:.3f} output_GB="
          f"{out_gb:.3f} points_per_s={serve_points / t_big:.1f} "
          f"f64_product_GFLOP={big_flop / 1e9:.1f} achieved_TFLOP_s="
          f"{big_flop / big_ms / 1e9:.1f}", flush=True)
    check(worst < 1e-9, f"spectral_full vs panel LU: {worst} >= 1e-9")
    check(spot < 1e-9, f"spectral_full vs torch.linalg.solve: {spot}")
    check(gsm_err < 1e-8, f"spectral_full GSM error {gsm_err} >= 1e-8")
    del x_big, x_spec, fs

    # (3) the Gauss-Jordan factorization
    a, _ = assemble_at(sys_, sys_.domain[points // 2],
                       symmetrize=cfg.symmetrize)
    gj_inverse_f32(a[:256, :256])  # warm-up
    ainv, t_inv = timed(lambda: gj_inverse_f32(a))
    eye = torch.eye(sys_.n, dtype=torch.float64, device=dev)
    inv_res = float(torch.linalg.norm(a @ ainv.double() - eye)
                    / torch.linalg.norm(eye))
    del ainv
    gj_worst = 0.0
    for i in (0, points // 2, points - 1):
        a, b = assemble_at(sys_, sys_.domain[i], symmetrize=cfg.symmetrize)
        x = gj_solve_refined(a, b, refine_iterations=cfg.refine_iterations)
        xr = torch.linalg.solve(a, b)
        gj_worst = max(gj_worst, float(torch.linalg.norm(x - xr)
                                       / torch.linalg.norm(xr)))
    cfg_gj = MorfemConfig(factorization="gj", error_threshold=1e-10)
    timer = PhaseTimer(device=dev)
    (x, q, *_, b_r), t_gj = timed(lambda: morfem(
        sys_.domain, sys_.a0, sys_.a1, sys_.a2, sys_.b, t_b=sys_.t_b,
        config=cfg_gj, timer=timer, device=dev))
    gsm_gj = generalized_scattering_matrix(sys_.domain, x,
                                           cb[:, None, None] * b_r)
    gj_gsm_err = float((gsm_gj - gsm_full).abs().max())
    print(f"  serve gj N={sys_.n}: gj_inverse_f32_s={t_inv:.3f} "
          f"rel_residual={inv_res:.3e}; gj_solve_refined "
          f"rel_vs_torch_solve(3 points)={gj_worst:.3e}; "
          f"morfem(factorization='gj') Nr={q.shape[1]} total_s={t_gj:.3f} "
          f"greedy_s={timer.times['projection base']:.3f} "
          f"max|S_gj-S_full|={gj_gsm_err:.3e}", flush=True)
    check(gj_worst < 1e-9, f"gj_solve_refined vs torch solve: {gj_worst}")
    check(gj_gsm_err < 1e-8, f"gj route GSM error {gj_gsm_err} >= 1e-8")

    # (4) cyclic reduction against block Thomas on the matrix-free pencil
    c_sp, zero, gamma, wp = _waveguide_2d(cr_p)
    op, perm = banded_via_rcm(c_sp, zero, gamma, symmetrize=cfg.symmetrize,
                              device=dev)
    rhs = torch.as_tensor(wp, device=dev)[perm]
    freq = np.linspace(3e9, 5e9, points)
    idx = (0, points // 2, points - 1)
    for i in idx[:1]:  # warm-up of both
        f = float(freq[i])
        cf = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        for fac in ("scan", "cr"):
            banded_direct_solve(op, cf, f * rhs, cfg, factorization=fac)
    cr_worst = 0.0
    for i in idx:
        f = float(freq[i])
        cf = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        res = {}
        for fac in ("scan", "cr"):
            res[fac], t = timed(lambda: banded_direct_solve(
                op, cf, f * rhs, cfg, factorization=fac))
            res[fac] = res[fac] + (t,)
        (xs, rs, its, ts_), (xc, rc, itc, tc) = res["scan"], res["cr"]
        rel = float(torch.linalg.norm(xc - xs) / torch.linalg.norm(xs))
        cr_worst = max(cr_worst, rel)
        print(f"  serve cr N={op.n} (half-bandwidth {op.half}) "
              f"f={f:.6e}: scan solve_s={ts_:.4f} iterations={its} "
              f"relres={float(rs.max()):.3e}; cr solve_s={tc:.4f} "
              f"iterations={itc} relres={float(rc.max()):.3e}; "
              f"rel_cr_vs_scan={rel:.3e}", flush=True)
    check(cr_worst < 1e-10, f"cr vs scan: {cr_worst} >= 1e-10")
    del op, rhs

    # (5) the basis-size study against an independent recompute. Both
    # sides project with `project` and solve by the batched LU (`sweep`
    # without K4's flag); only their bases differ: the study orthonormalizes
    # each size's columns of the padded snapshot bank (masked SVD), the
    # recompute its own snapshots (SVD). The spans agree to roundoff (the
    # subspace gap); the reduced systems' condition number carries that
    # into the reconstructions, and exact f64 reduced solves on both bases
    # show that the LU adds nothing to it.
    study, t_study = timed(lambda: basis_size_study(
        sys_, study_sizes, cfg, x_full=x_full))
    denom = torch.linalg.norm(x_full)

    def frac(y, z):  # |y - z| in units of |x_full|
        return float(torch.linalg.norm(y - z) / denom)

    def exact_reconstruction(q):  # and the reduced systems' worst cond
        a, rhs = assemble_reduced(project(sys_, q), sys_.domain, cfg)
        return (torch.einsum("nk,ikm->inm", q, torch.linalg.solve(a, rhs)),
                float(torch.linalg.cond(a).max()))

    recheck_worst = 0.0
    for s in recheck:
        si = int(np.flatnonzero(study.sizes == s)[0])
        q_s = study.q[si][:, :int(study.ncols[si])]
        q = equally_distributed_basis(sys_, cfg, count=s)
        rec = torch.einsum("nk,ikm->inm", q, sweep(project(sys_, q), cfg))
        rec_study = torch.einsum("nk,ikm->inm", study.q[si], study.x[si])
        rel, rel_study = frac(rec, x_full), float(study.rel_error[si])
        gap = abs(rel - rel_study)
        recheck_worst = max(recheck_worst, gap)
        exact_study, _ = exact_reconstruction(q_s)
        exact_re, cond = exact_reconstruction(q)
        print(f"  serve study recompute seeds={s}: rel_error={rel!r} "
              f"(study {rel_study!r}) |difference|={gap:.3e} "
              f"(relative {gap / rel:.3e}); in units of |x_full|: "
              f"reconstruction difference {frac(rec, rec_study):.3e}, "
              f"with exact f64 reduced solves "
              f"{frac(exact_re, exact_study):.3e}, LU vs exact "
              f"{frac(rec_study, exact_study):.3e} (study) "
              f"{frac(rec, exact_re):.3e} (recompute); "
              f"subspace gap |Q_r - Q_s Q_s^T Q_r|="
              f"{float(torch.linalg.norm(q - q_s @ (q_s.T @ q))):.3e}; "
              f"max cond(reduced)={cond:.3e}",
              flush=True)
    print(f"  serve basis_size_study sizes={study.sizes[0]}..."
          f"{study.sizes[-1]}: study_s={t_study:.3f} rel_error="
          + json.dumps([float(f"{e:.3e}") for e in study.rel_error])
          + f" max_rel_error_difference_vs_recompute={recheck_worst:.3e}",
          flush=True)
    check(bool(np.isfinite(study.rel_error).all()),
          "non-finite rel_error in the study")
    check(recheck_worst < 1e-10,
          f"study rel_error vs independent recompute: {recheck_worst} "
          ">= 1e-10")
    return k4_launches


def _waveguide_2d(p):
    """The reference's ~34k-DOF stress pencil (p=185): SciPy CSR slots
    (C, 0, Γ = scaled T) and the two ports, as tools/bench_banded.py
    builds them."""
    from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
    from morfem_tpu_torch.utils.synthetic import banded_waveguide_system_2d

    c_sp, t_sp, wp = banded_waveguide_system_2d(p, m=2, seed=1)
    return c_sp, 0.0 * c_sp, (t_sp * GAMMA_SCALE).tocsr(), wp


def _oracle(dev, mats, wp, freq, cfg, count=7):
    """Banded direct full-order solves at `count` grid points, in RCM order:
    (indices, perm, x [count, N, M])."""
    import numpy as np
    import torch

    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )

    op, perm = banded_via_rcm(*mats, symmetrize=cfg.symmetrize, device=dev)
    b = torch.as_tensor(wp, device=dev)[perm]
    idx = np.linspace(0, len(freq) - 1, count, dtype=int)
    xs = []
    for i in idx:
        f = float(freq[i])
        c = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        xs.append(banded_direct_solve(op, c, f * b, cfg)[0])
    return idx, perm, torch.stack(xs)


def _rel_vs_oracle(x, q, oracle):
    import torch

    idx, perm, x_or = oracle
    rec = torch.einsum("nk,ikm->inm", q[perm], x[torch.as_tensor(idx)])
    return float(torch.linalg.norm(rec - x_or) / torch.linalg.norm(x_or))


def _morfem_run(dev, label, mats, wp, freq, cfg):
    import torch

    from morfem_tpu_torch import PhaseTimer, morfem
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    timer = PhaseTimer(device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    x, q, *_ = morfem(freq, *mats, wp, config=cfg, timer=timer, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = launch_counts()
    nr, m = q.shape[1], wp.shape[1]
    check(bool(torch.isfinite(x).all() and torch.isfinite(q).all()),
          f"{label}: non-finite result")
    check(tuple(x.shape) == (len(freq), nr, m) and q.shape[0] == wp.shape[0],
          f"{label}: shapes {tuple(x.shape)}, {tuple(q.shape)}")
    print(f"  {label} N={q.shape[0]} I={len(freq)}: Nr={nr} "
          f"greedy_iterations={(nr - 2 * m) // m + 1} (derived: seeds + one "
          f"snapshot per iteration) total_s={total:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in timer.times.items())
          + " launches=" + json.dumps(counts), flush=True)
    return x, q, counts


def matfree_phase(dev, p=P_34K, points=100):
    """morfem() on the N=p² SciPy-sparse pencil: the RCM-banded matrix-free
    route, default sweep and then the K4 LU sweep, against banded direct
    oracle solves at 7 grid points."""
    import numpy as np

    from morfem_tpu_torch import MorfemConfig

    c_sp, zero, gamma, wp = _waveguide_2d(p)
    mats = (c_sp, zero, gamma)
    freq = np.linspace(3e9, 5e9, points)
    cfg = MorfemConfig(error_threshold=1e-8)
    oracle = _oracle(dev, mats, wp, freq, cfg)
    k4 = 0
    for label, c in (("matfree", cfg),
                     ("matfree_k4_lu", cfg.replace(
                         sweep_method="lu", use_pallas_reduced_sweep=True))):
        x, q, counts = _morfem_run(dev, label, mats, wp, freq, c)
        rel = _rel_vs_oracle(x, q, oracle)
        print(f"  {label}: rel_err_vs_banded_oracle(7 points)={rel:.3e}",
              flush=True)
        check(rel < 1e-7, f"{label}: rel error vs oracle {rel} >= 1e-7")
        if c.use_pallas_reduced_sweep:
            k4 = counts["gauss_jordan_sweep_solve"]
            check(k4 > 0, "K4 was not launched by the matrix-free LU sweep")
    return k4


def general_phase(dev, p=GENERAL_P, points=100):
    """The 2-D waveguide pencil at N=p² forced onto the general-sparsity
    route (band_max_half=128 < the RCM half-bandwidth: BandwidthError →
    truncated band + exact-operator GMRES), same oracle check; then with a
    scattered remainder outside the band (dropped mass > 0)."""
    import numpy as np

    import torch

    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.ops.block_tridiag import (
        BandwidthError, banded_via_rcm, truncated_band_via_rcm,
    )

    cfg = MorfemConfig(error_threshold=1e-8, band_max_half=128)
    c_sp, zero, gamma, wp = _waveguide_2d(p)
    mats = (c_sp, zero, gamma)
    freq = np.linspace(3e9, 5e9, points)
    oracle = _oracle(dev, mats, wp, freq, cfg)
    try:
        banded_via_rcm(*mats, max_half=cfg.band_max_half, device=dev)
        raise CheckFailed("the general phase's pencil is band-recoverable")
    except BandwidthError as e:
        print(f"  general: {e}", flush=True)
    exact, _, perm, dropped = truncated_band_via_rcm(
        *mats, band_half=cfg.band_max_half, device="cpu")
    natural = bool((perm == torch.arange(perm.numel())).all())
    print(f"  general: exact operator {type(exact).__name__}, "
          f"{'natural' if natural else 'RCM'} ordering, out-of-band mass "
          f"dropped by the preconditioner {dropped:.3e}", flush=True)
    x, q, _ = _morfem_run(dev, "general", mats, wp, freq, cfg)
    rel = _rel_vs_oracle(x, q, oracle)
    print(f"  general: rel_err_vs_banded_oracle(7 points)={rel:.3e}",
          flush=True)
    check(rel < 1e-7, f"general: rel error vs oracle {rel} >= 1e-7")

    # With mass outside the band. On the bare pencil a band below the
    # natural half-bandwidth (p+1) drops >= 12 % of the mass and GMRES
    # stalls, in the JAX package exactly as here (tools/general_route_
    # stall.py, PERF.md). The route is for patterns that leave only a
    # small scattered remainder outside the band, so: the same pencil plus
    # weak scattered couplings, against SciPy's spsolve at 3 points.
    import scipy.sparse.linalg as spla

    mats, wp = scattered_waveguide_2d(p)
    _, _, _, dropped = truncated_band_via_rcm(
        *mats, band_half=cfg.band_max_half, device="cpu")
    print(f"  general_scattered: out-of-band mass dropped by the "
          f"preconditioner {dropped:.3e}", flush=True)
    check(dropped > 0, "general_scattered: nothing lies outside the band")
    x, q, _ = _morfem_run(dev, "general_scattered", mats, wp, freq, cfg)
    worst = 0.0
    for i in (0, points // 2, points - 1):
        f = float(freq[i])
        a = sum(cp * (mp + mp.T) * 0.5
                for cp, mp in zip((1.0, f, f * f), mats)).tocsc()
        ref = spla.spsolve(a, f * wp)
        rec = (q @ x[i]).cpu().numpy()
        worst = max(worst, float(np.linalg.norm(rec - ref)
                                 / np.linalg.norm(ref)))
    print(f"  general_scattered: rel_err_vs_spsolve(3 points)={worst:.3e}",
          flush=True)
    check(worst < 1e-7, f"general_scattered: rel error {worst} >= 1e-7")


def scattered_waveguide_2d(p, nfar_frac=0.01, amp=0.05, seed=5):
    """The 2-D waveguide pencil (C, 0, Γ) plus weak scattered symmetric
    couplings in C: RCM cannot band it, the natural ordering keeps the grid
    within p+1 of the diagonal, and only the scattered remainder falls
    outside the truncated band."""
    import numpy as np
    import scipy.sparse as sp

    c, _, gamma, wp = _waveguide_2d(p)
    n = p * p
    rng = np.random.default_rng(seed)
    nfar = int(n * nfar_frac)
    far = sp.coo_matrix(
        (amp * abs(c).max() * rng.standard_normal(nfar),
         (rng.integers(0, n, nfar), rng.integers(0, n, nfar))), shape=(n, n))
    c = (c + far + far.T).tocsr()
    return (c, 0.0 * c, gamma), np.asarray(wp)


def krylov_phase(dev, points=100):
    """greedy_basis_matfree(method="bicgstab") on a banded operator (K5)
    and a block-sparse operator (K6) at N=34,225, checked against
    scipy.sparse.linalg.spsolve at 3 points."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from morfem_tpu_torch import MorfemConfig, sweep
    from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.block_sparse import BlockSparseAffineOperator
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    n = P_34K ** 2
    domain = np.linspace(1.0, 2.0, points)
    b = np.random.default_rng(1).normal(size=(n, 2))
    cfg = MorfemConfig(error_threshold=1e-9)
    launches = {}
    for kind, kernel in (("banded", "banded_matvec_padded"),
                         ("block_sparse", "bsr_matmul_f32")):
        mats = krylov_pencil(n, scattered=kind == "block_sparse")
        t0 = time.perf_counter()
        op = (BandedAffineOperator(*mats, device=dev) if kind == "banded"
              else BlockSparseAffineOperator(*mats, device=dev))
        t_setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res, rm = greedy_basis_matfree(op, b, domain, config=cfg,
                                       method="bicgstab")
        torch.cuda.synchronize()
        t_greedy = time.perf_counter() - t0
        counts = launch_counts()
        launches[kernel] = counts[kernel]
        x = sweep(rm, cfg).cpu().numpy()
        q = rm.q.cpu().numpy()
        worst = 0.0
        for i in (0, points // 2, points - 1):
            t = domain[i]
            a = sum(cp * (m + m.T) * 0.5
                    for cp, m in zip((1.0, t, t * t), mats)).tocsc()
            ref = spla.spsolve(a, t * b)
            worst = max(worst, float(np.linalg.norm(q @ x[i] - ref)
                                     / np.linalg.norm(ref)))
        print(f"  krylov {kind} N={n} I={points}: setup_s={t_setup:.3f} "
              f"greedy_s={t_greedy:.3f} Nr={rm.ncols} "
              f"iterations={res.iterations} converged={res.converged} "
              f"rel_err_vs_spsolve(3 points)={worst:.3e} "
              f"launches={json.dumps(counts)}", flush=True)
        check(res.converged and not res.failed_snapshot,
              f"krylov {kind}: greedy did not converge")
        check(worst < 1e-6, f"krylov {kind}: rel error {worst} >= 1e-6")
        check(counts[kernel] > 0,
              f"{kernel} was not launched by the {kind} Krylov path")
    return launches


LOSS = 1 - 0.02j  # a dielectric fill with an FR-4-like loss tangent


def complex_krylov_pencil(n, half=5, seed=7):
    """The JAX package's complex-symmetric banded test pencil (absorbing
    Helmholtz-like): a0 with complex diagonal and bands, a1 = 0,
    a2 = −I, complex b [N, 2]; SciPy CSR."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    diags = [(8.0 + rng.random(n)) + 1j * 0.4] + [
        (-0.3 + 0.05j) * np.ones(n - d) for d in range(1, half + 1)]
    a0 = sp.diags(diags, list(range(half + 1))).tocsr()
    a0 = ((a0 + a0.T) * 0.5).tocsr()
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return (a0, sp.csr_matrix((n, n)), (sp.eye(n) * -1.0).tocsr()), b


def _spsolve_refs(mats, b, coeffs, grid, idx):
    """{i: SciPy spsolve of (Σ c_p(t_i)·A_p)·x = c_b(t_i)·b} (complex
    where the pencil is); coeffs are numpy callables."""
    import numpy as np
    import scipy.sparse.linalg as spla

    refs = {}
    for i in idx:
        t = float(grid[i])
        a = sum(f(t) * m for f, m in zip(coeffs[:3], mats)).tocsc()
        refs[i] = spla.spsolve(a, coeffs[3](t) * np.asarray(b))
    return refs


def _worst_vs(q, x, refs):
    """Largest relative error of q·x[i] against refs[i]."""
    import numpy as np

    qh = q.cpu().numpy()
    return max(float(np.linalg.norm(qh @ x[i].cpu().numpy() - r)
                     / np.linalg.norm(r)) for i, r in refs.items())


def complex_phase(dev, sys_, k4_serve_s, p=P_34K, points=100,
                  krylov_n=P_34K ** 2, serve_points=10000):
    """Complex systems: (a) the lossy waveguide through the native
    complex128 dense route, against the full-order complex sweep (no panel
    LU), then its serving re-sweep beside K4's real one (``k4_serve_s``,
    the reduced_lu phase's); (b) the lossy 2-D pencil through the
    matrix-free route on the interleaved embedding, default sweep and K4's
    flag, against complex spsolve; (c) the same physics as real operators
    with a complex t_a2 (the extra-addend path); (d) the Krylov greedy on
    the embedding of a complex banded pencil (K5). Returns K5's
    launches."""
    import numpy as np
    import torch

    from morfem_tpu_torch import (
        AffineSystem, MorfemConfig, PhaseTimer, morfem, solve_sweep, sweep,
        sweep_complex_reduced,
    )
    from morfem_tpu_torch.mor.complex_model import finish_complex_model
    from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
    from morfem_tpu_torch.mor.reduced import ReducedModel
    from morfem_tpu_torch.ops.assembly import assemble_at
    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )
    from morfem_tpu_torch.ops.complex_split import (
        deinterleave, embed_rhs_interleaved, embed_sparse_interleaved,
    )
    from morfem_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    # (a) the dense lossy waveguide, native complex128
    a2c = sys_.a2 * LOSS
    cfg = MorfemConfig(error_threshold=1e-10)
    timer = PhaseTimer(device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    x, q, r0, r1, r2, b_r = morfem(sys_.domain, sys_.a0, sys_.a1, a2c,
                                   sys_.b, t_b=sys_.t_b, config=cfg,
                                   timer=timer, device=dev)
    torch.cuda.synchronize()
    t_mor = time.perf_counter() - t0
    sys_c = AffineSystem.create(sys_.domain, sys_.a0, sys_.a1, a2c, sys_.b,
                                t_b=sys_.t_b, device=dev)
    t0 = time.perf_counter()
    x_full = solve_sweep(sys_c, cfg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    counts = launch_counts()
    check(x.is_complex() and bool(torch.isfinite(torch.view_as_real(x))
                                  .all()), "complex dense: bad x")
    rec = torch.einsum("nk,ikm->inm", q, x)
    rel_pts = (torch.linalg.norm(rec - x_full, dim=(1, 2))
               / torch.linalg.norm(x_full, dim=(1, 2)))
    rel = float(rel_pts.max())
    spots = []
    for i in (0, sys_.num_points // 2, sys_.num_points - 1):
        a, b = assemble_at(sys_c, sys_c.domain[i], symmetrize=cfg.symmetrize)
        xr = torch.linalg.solve(a, b)
        spots.append(float(torch.linalg.norm(x_full[i] - xr)
                           / torch.linalg.norm(xr)))
    panel = {k: counts[k] for k in ("panel_factor", "mm_words",
                                    "gather_rows")}
    print(f"  complex dense N={sys_.n} I={sys_.num_points}: Nr={q.shape[1]} "
          f"mor_s={t_mor:.3f} full_s={t_full:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in timer.times.items())
          + f" max_point_rel_err_vs_full={rel:.3e} full_vs_torch_solve(3 "
          f"points)={max(spots):.3e} launches={json.dumps(counts)}",
          flush=True)
    check(rel < 1e-7, f"complex dense: rel error vs full {rel} >= 1e-7")
    check(max(spots) < 1e-9, f"complex dense: full-order spot {spots}")
    check(sum(panel.values()) == 0,
          f"complex dense reached the real panel LU: {panel}")
    del x_full, rec, sys_c, a2c

    # the complex model's serving re-sweep: K4's flag takes the batched LU
    # (K4 is real f32), and sweep_complex_reduced solves the same batch
    rm = ReducedModel(domain=sys_.domain, q=q, r0=r0, r1=r1, r2=r2, b_r=b_r,
                      ncols=q.shape[1], t_a0=sys_.t_a0, t_a1=sys_.t_a1,
                      t_a2=sys_.t_a2, t_b=sys_.t_b)
    ts = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                        device=dev)
    k4_cfg = cfg.replace(sweep_method="lu", use_pallas_reduced_sweep=True)
    fns = (sys_.t_a0, sys_.t_a1, sys_.t_a2, sys_.t_b)
    serve = {}
    for label, fn in (
        ("sweep", lambda: sweep(rm, k4_cfg, ts)),
        ("sweep_complex_reduced", lambda: sweep_complex_reduced(
            r0, r1, r2, b_r, ts, *fns, device=dev)),
    ):
        fn()  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        serve[label] = fn()
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        k4 = launch_counts()["gauss_jordan_sweep_solve"]
        print(f"  complex dense serve I={serve_points} Nr={q.shape[1]} "
              f"({label}): sweep_s={t_serve:.4f} K4_launches={k4} "
              f"(K4's real re-sweep: {k4_serve_s:.4f} s, ratio "
              f"{t_serve / k4_serve_s:.2f})", flush=True)
        check(k4 == 0, f"K4 was handed a complex model ({label})")
    rel = float(torch.linalg.norm(serve["sweep"]
                                  - serve["sweep_complex_reduced"])
                / torch.linalg.norm(serve["sweep_complex_reduced"]))
    print(f"  complex dense serve: sweep vs sweep_complex_reduced rel "
          f"{rel:.3e}", flush=True)
    check(rel < 1e-9, f"complex re-sweeps disagree: {rel}")
    del rm, serve, r0, r1, r2, b_r

    # (b) and (c): the lossy 2-D pencil at N=p², matrix-free
    c_sp, zero, gamma, wp = _waveguide_2d(p)
    freq = np.linspace(3e9, 5e9, points)
    idx = (0, points // 2, points - 1)
    wave = (lambda t: 1.0, lambda t: t, lambda t: t * t, lambda t: t)
    lossy = (c_sp, zero, (gamma * LOSS).tocsr())
    cfg = MorfemConfig(error_threshold=1e-8, symmetrize=False)
    recs, refs, t_ref = {}, None, 0.0
    runs = (
        ("complex_matfree", lossy, {}, cfg),
        ("complex_matfree_k4_flag", lossy, {}, cfg.replace(
            sweep_method="lu", use_pallas_reduced_sweep=True)),
        ("complex_matfree_t_a2", (c_sp, zero, gamma),
         dict(t_a2=lambda t: t ** 2 * LOSS), cfg),
    )
    for label, mats, fns, c in runs:
        timer = PhaseTimer(device=dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        x, q, *_ = morfem(freq, *mats, wp, config=c, timer=timer,
                          device=dev, **fns)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
        check(x.is_complex() and bool(torch.isfinite(torch.view_as_real(x))
                                      .all()), f"{label}: bad x")
        if refs is None:
            t0 = time.perf_counter()
            refs = _spsolve_refs(lossy, wp, wave, freq, idx)
            t_ref = time.perf_counter() - t0
        worst = _worst_vs(q, x, refs)
        recs[label] = torch.einsum("nk,ikm->inm", q, x)
        print(f"  {label} N={q.shape[0]} (embedded {2 * q.shape[0]}) "
              f"I={points}: Nr={q.shape[1]} total_s={total:.3f} "
              + " ".join(f"{k}_s={v:.3f}" for k, v in timer.times.items())
              + f" rel_err_vs_spsolve(3 points)={worst:.3e} "
              f"launches={json.dumps(counts)}", flush=True)
        check(worst < 1e-7, f"{label}: rel error vs spsolve {worst}")
        if c.use_pallas_reduced_sweep:
            # the embedded real model is built and not swept (the
            # reference sweeps it and discards the result)
            k4 = counts["gauss_jordan_sweep_solve"]
            print(f"  {label}: K4 launches {k4}", flush=True)
            check(k4 == 0, f"{label}: the embedded model was swept on K4")
    print(f"  complex_matfree spsolve oracle (3 points, host): "
          f"{t_ref:.3f} s", flush=True)
    ref_rec = recs["complex_matfree"]
    agree = float((torch.linalg.norm(recs["complex_matfree_t_a2"] - ref_rec,
                                     dim=(1, 2))
                   / torch.linalg.norm(ref_rec, dim=(1, 2))).max())
    print(f"  complex_matfree vs complex_matfree_t_a2: max point rel "
          f"{agree:.3e}", flush=True)
    check(agree < 1e-7, f"complex operators vs complex t_a2: {agree}")
    del recs, ref_rec
    # one snapshot solve on the embedded pencil, timed alone
    emb = [embed_sparse_interleaved(m) for m in lossy]
    t0 = time.perf_counter()
    op, perm = banded_via_rcm(*emb, symmetrize=False, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    f = float(freq[points // 2])
    be = torch.as_tensor(embed_rhs_interleaved(wp), device=dev)[perm]
    cf = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
    banded_direct_solve(op, cf, f * be)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, relres, its = banded_direct_solve(op, cf, f * be)
    torch.cuda.synchronize()
    print(f"  complex_matfree embedded snapshot solve: RCM half-bandwidth "
          f"{op.half} (N={op.n}), setup_s={t_setup:.3f} solve_s="
          f"{time.perf_counter() - t0:.3f} refinement_iterations={its} "
          f"relres={float(relres.max()):.3e}", flush=True)
    del op, emb, be

    # (d) the Krylov greedy on the embedding of a complex banded pencil
    mats, b = complex_krylov_pencil(krylov_n)
    domain = np.linspace(0.8, 2.0, points)
    t0 = time.perf_counter()
    emb = [embed_sparse_interleaved(m) for m in mats]
    op = BandedAffineOperator(*emb, symmetrize=False, device=dev)
    be = torch.as_tensor(embed_rhs_interleaved(b), device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    cfg = MorfemConfig(error_threshold=1e-9, symmetrize=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    res, rm = greedy_basis_matfree(op, be, domain, config=cfg,
                                   method="bicgstab")
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    counts = launch_counts()
    t0 = time.perf_counter()
    x, q, *_ = finish_complex_model(
        deinterleave(rm.q), *mats, b, domain, lambda t: torch.ones_like(t),
        lambda t: t, lambda t: t ** 2, lambda t: t)
    torch.cuda.synchronize()
    t_finish = time.perf_counter() - t0
    worst = _worst_vs(q, x, _spsolve_refs(mats, b, wave, domain, idx))
    print(f"  complex_krylov N={krylov_n} (embedded {op.n}, half-bandwidth "
          f"{op.half}, bw {op.bw}) I={points}: setup_s={t_setup:.3f} "
          f"greedy_s={t_greedy:.3f} finish_s={t_finish:.3f} "
          f"Nr_embedded={rm.ncols} Nr={q.shape[1]} iterations="
          f"{res.iterations} converged={res.converged} "
          f"rel_err_vs_spsolve(3 points)={worst:.3e} "
          f"launches={json.dumps(counts)}", flush=True)
    check(res.converged and not res.failed_snapshot,
          "complex_krylov: greedy did not converge")
    check(worst < 1e-6, f"complex_krylov: rel error {worst} >= 1e-6")
    check(counts["banded_matvec_padded"] > 0,
          "banded_matvec_padded was not launched by the embedded Krylov "
          "greedy")
    return counts["banded_matvec_padded"]


# -- the parallel layer (torch.distributed) ---------------------------------

GAMMA_SCALES = (1.00, 1.05, 1.10, 1.15)  # the dp phase's four waveguides


def _rel(x, ref) -> float:
    import torch

    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def _scaled_rel(x, ref) -> float:
    """max |x − ref| over max |ref| (Galerkin projections: entries near
    zero carry the roundoff of the large ones)."""
    return float((x - ref).abs().max() / ref.abs().max())


def _mid_system(sys_):
    """A(f) and b(f) of the waveguide at its middle grid point (f64)."""
    from morfem_tpu_torch.ops.assembly import assemble_at

    return assemble_at(sys_, sys_.domain[sys_.num_points // 2])


def _dense_dd(n, dev, seed=3):
    """A diagonally dominant symmetric f64 matrix and two right-hand sides."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n)
    a = (a + a.T) / 2 + 3 * np.eye(n)
    return (torch.from_numpy(a).to(dev),
            torch.from_numpy(rng.standard_normal((n, 2))).to(dev))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _parallel_rank(n_wave, q_trim, points, serve_points, p2d):
    """Body of each of the two ranks of phase (b), on cuda:0 over gloo.

    Every check that needs no reference from the parent runs here and
    raises `CheckFailed`; returns (rank 0's outputs, the seconds of each
    step, every rank's kernel launch counts)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from morfem_tpu_torch import (
        MorfemConfig, equally_distributed_basis, project, sweep,
    )
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, waveguide_system,
    )
    from morfem_tpu_torch.mor.equally import seed_indices
    from morfem_tpu_torch.ops.banded_matvec import combine_addends
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )
    from morfem_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )
    from morfem_tpu_torch.parallel import (
        batch_systems, make_mesh, multi_geometry_mor,
        sharded_full_order_sweep, sharded_sweep,
        tp_operator_images_and_project, tp_solve, tp_solve_dense,
    )
    from morfem_tpu_torch.parallel.tp_banded import spike_solve

    dev = torch.device("cuda", torch.cuda.current_device())
    sp2, tp2, dp2 = make_mesh(sp=2), make_mesh(tp=2), make_mesh(dp=2)
    cfg = MorfemConfig(error_threshold=1e-10)
    data = load_waveguide_data(n_fallback=n_wave)
    freq = np.linspace(3e9, 5e9, points)
    sys_ = waveguide_system(freq, data, device=dev)
    rm = project(sys_, q_trim.to(dev))
    secs, out = {}, {}
    reset_launch_counts()

    out["full"], secs["sp2_full_order_sweep"] = _timed(
        lambda: sharded_full_order_sweep(sys_, sp2, cfg))
    ts = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                        device=dev)
    xs, secs["sp2_sweep"] = _timed(lambda: sharded_sweep(rm, sp2, cfg, ts=ts))
    out["sweep_rel"] = _rel(xs, sweep(rm, cfg, ts))
    check(out["sweep_rel"] < 1e-10,
          f"sp=2 sharded_sweep: {out['sweep_rel']} >= 1e-10")

    (u, r, b_r), secs["tp2_project"] = _timed(
        lambda: tp_operator_images_and_project(sys_.operators(), sys_.b,
                                               rm.q, tp2))
    ref = (rm.r0, rm.r1, rm.r2)
    out["project_err"] = max(
        [_scaled_rel(u[k], a @ rm.q) for k, a in enumerate(sys_.operators())]
        + [_scaled_rel(r[k], ref[k]) for k in range(3)]
        + [_scaled_rel(b_r, rm.b_r)])
    check(out["project_err"] < 1e-11,
          f"tp=2 projection: {out['project_err']} >= 1e-11")

    a_mid, b_mid = _mid_system(sys_)
    x_gj, secs["tp2_solve_dense"] = _timed(
        lambda: tp_solve_dense(a_mid, b_mid, tp2))
    out["dense_rel"] = _rel(x_gj, torch.linalg.solve(a_mid, b_mid))
    check(out["dense_rel"] < 1e-12,
          f"tp=2 tp_solve_dense: {out['dense_rel']} >= 1e-12")

    c_sp, zero, gamma, wp = _waveguide_2d(p2d)
    op, perm = banded_via_rcm(c_sp, zero, gamma, device=dev)
    b2d = torch.as_tensor(wp, device=dev)[perm]
    spike = []
    for i in np.linspace(0, len(freq) - 1, 3, dtype=int):
        f = float(freq[i])
        c = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        (x_s, relres, iters), t_s = _timed(lambda: spike_solve(
            combine_addends(c, op.bands_w), op.half, f * b2d, tp2,
            tol=1e-12))
        x_d = banded_direct_solve(op, c, f * b2d)[0]
        spike.append((f, float(relres.max()), iters, _rel(x_s, x_d), t_s))
        check(float(relres.max()) < 1e-10,
              f"tp=2 spike_solve at f={f}: relres {relres.tolist()}")
        check(_rel(x_s, x_d) < 1e-8,
              f"tp=2 spike_solve at f={f}: {_rel(x_s, x_d)} from the "
              "single-card banded direct solve")
    out["spike"] = spike
    secs["tp2_spike_3_points"] = sum(s[4] for s in spike)

    a_dd, b_dd = _dense_dd(4096, dev)
    (x_k, relres_k), secs["tp2_tp_solve"] = _timed(
        lambda: tp_solve(a_dd, b_dd, tp2, tol=1e-12))
    out["krylov"] = (float(relres_k.max()),
                     _rel(x_k, torch.linalg.solve(a_dd, b_dd)))
    check(out["krylov"][0] < 1e-10,
          f"tp=2 tp_solve relres {out['krylov'][0]} >= 1e-10")

    systems = [waveguide_system(freq, data._replace(
        t_mat=data.t_mat * s), device=dev) for s in GAMMA_SCALES]
    sidx = seed_indices(points, cfg, count=20)
    s0 = systems[0]
    (x_g, q_g), secs["dp2_multi_geometry_mor"] = _timed(
        lambda: multi_geometry_mor(*batch_systems(systems), sidx,
                                   (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b), cfg,
                                   mesh=dp2))
    worst = 0.0
    for k, sg in enumerate(systems):
        qs = equally_distributed_basis(sg, cfg, count=20)
        rec_s = torch.einsum("nk,ikm->inm", qs, sweep(project(sg, qs), cfg))
        worst = max(worst, _rel(torch.einsum("nk,ikm->inm", q_g[k], x_g[k]),
                                rec_s))
    out["multi_geometry_rel"] = worst
    check(worst < 1e-9, f"dp=2 multi_geometry_mor: {worst} >= 1e-9")
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, launch_counts())
    return out, secs, counts


def parallel_phase(dev, sys_, rm, x_full, smi, serve_points=10000,
                   p2d=P_34K):
    """The parallel layer on the card: (a) one NCCL rank in this process
    on a (1, 1, 1) mesh — the sharded full-order sweep against the slice
    phase's `x_full`, the sharded reduced and spectral sweeps at 10,000
    points, the tp projection and the tp Gauss–Jordan solve; (b) two ranks
    spawned on the one card over gloo with CUDA tensors (`_parallel_rank`).
    Also the singular-Schur-block check of the banded direct solve.
    Returns the kernels' launches of (a) and of every rank of (b)."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from morfem_tpu_torch import MorfemConfig, prepare_spectral, sweep
    from morfem_tpu_torch.ops.block_tridiag import block_tridiag_factor
    from morfem_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )
    from morfem_tpu_torch.parallel import (
        make_mesh, sharded_full_order_sweep, sharded_spectral_sweep,
        sharded_sweep, tp_operator_images_and_project, tp_solve_dense,
    )
    from morfem_tpu_torch.parallel.launch import run_spmd

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"  parallel: {smi}, compute mode {mode}; two ranks on one card "
          "share its SMs and memory: the times show correctness and "
          "overhead, not a speed-up", flush=True)

    # a singular Schur complement factors to non-finite values, no raise
    d = torch.eye(128, device=dev).repeat(2, 1, 1)
    d[0, 127, 127] = 0.0
    fac = block_tridiag_factor(torch.zeros_like(d), d, torch.zeros_like(d),
                               256)
    check(not bool(torch.isfinite(fac.g[0]).all()),
          "a singular Schur block factored to finite values")
    print("  parallel: singular Schur block -> non-finite factor "
          "(no exception)", flush=True)

    cfg = MorfemConfig(error_threshold=1e-10)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
            rank=0, world_size=1)
        try:
            mesh = make_mesh(1, 1, 1)
            reset_launch_counts()
            x, secs["a_full_order_sweep"] = _timed(
                lambda: sharded_full_order_sweep(sys_, mesh, cfg))
            counts_a = launch_counts()
            rel_full = _rel(x, x_full)
            ts = torch.linspace(3e9, 5e9, serve_points, dtype=torch.float64,
                                device=dev)
            xs, secs["a_sweep"] = _timed(
                lambda: sharded_sweep(rm, mesh, cfg, ts=ts))
            rel_sweep = _rel(xs, sweep(rm, cfg, ts))
            sm = prepare_spectral(rm, cfg)
            xq, secs["a_spectral_sweep"] = _timed(
                lambda: sharded_spectral_sweep(sm, mesh, ts=ts))
            rel_spec = _rel(xq, sm.sweep(ts))
            (u, r, b_r), secs["a_project"] = _timed(
                lambda: tp_operator_images_and_project(
                    sys_.operators(), sys_.b, rm.q, mesh))
            ref = (rm.q.T @ (a @ rm.q) for a in sys_.operators())
            err_proj = max([_scaled_rel(r[k], rk) for k, rk in
                            enumerate(ref)] + [_scaled_rel(b_r, rm.q.T @
                                                           sys_.b)])
            a_mid, b_mid = _mid_system(sys_)
            x_gj, secs["a_tp_solve_dense"] = _timed(
                lambda: tp_solve_dense(a_mid, b_mid, mesh))
            rel_gj = _rel(x_gj, torch.linalg.solve(a_mid, b_mid))
        finally:
            dist.destroy_process_group()
    print(f"  parallel (a) one NCCL rank, mesh (1,1,1): full-order sweep "
          f"rel_vs_x_full={rel_full:.3e}; sweep I={serve_points} "
          f"rel={rel_sweep:.3e}; spectral rel={rel_spec:.3e}; projection "
          f"err={err_proj:.3e}; tp_solve_dense N={sys_.n} "
          f"rel_vs_linalg_solve={rel_gj:.3e}; launches "
          f"{json.dumps(counts_a)}", flush=True)
    check(rel_full < 1e-12, f"(a) sharded full-order sweep: {rel_full}")
    check(rel_sweep < 1e-12 and rel_spec < 1e-12,
          f"(a) sharded sweeps: {rel_sweep}, {rel_spec}")
    check(err_proj < 1e-11, f"(a) tp projection: {err_proj} >= 1e-11")
    check(rel_gj < 1e-12, f"(a) tp_solve_dense: {rel_gj} >= 1e-12")
    for k in ("panel_factor", "mm_words", "gather_rows"):
        check(counts_a[k] > 0, f"(a) {k} was not launched")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, secs_b, counts_b = run_spmd(
        _parallel_rank, 2, "gloo", "cuda", sys_.n, rm.q.cpu(),
        sys_.num_points, serve_points, p2d, timeout=BUDGET["parallel"])
    secs["b_two_ranks_whole"] = time.perf_counter() - t0
    secs.update({f"b_{k}": v for k, v in secs_b.items()})
    rel_full_b = _rel(out["full"].to(dev), x_full)
    print(f"  parallel (b) two gloo ranks on {smi}: sp=2 full-order sweep "
          f"rel_vs_x_full={rel_full_b:.3e}; sp=2 sweep I={serve_points} "
          f"rel={out['sweep_rel']:.3e}; tp=2 projection "
          f"err={out['project_err']:.3e}; tp=2 tp_solve_dense "
          f"rel={out['dense_rel']:.3e}; tp=2 spike N={p2d ** 2} "
          + "; ".join(f"f={f:.4e} relres={rr:.2e} iterations={it} "
                      f"rel_vs_banded_direct={d:.2e} s={t:.3f}"
                      for f, rr, it, d, t in out["spike"])
          + f"; tp=2 tp_solve N=4096 relres={out['krylov'][0]:.2e} "
          f"rel_vs_linalg_solve={out['krylov'][1]:.2e}; dp=2 "
          f"multi_geometry_mor G={len(GAMMA_SCALES)} worst_rel_vs_serial="
          f"{out['multi_geometry_rel']:.3e}; launches per rank "
          f"{json.dumps(counts_b)}", flush=True)
    check(rel_full_b < 1e-10, f"(b) sp=2 full-order sweep: {rel_full_b}")
    for rank, c in enumerate(counts_b):
        for k in ("panel_factor", "mm_words", "gather_rows"):
            check(c[k] > 0, f"(b) rank {rank}: {k} was not launched")
    for k, v in secs.items():
        print(f"  parallel step '{k}': {v:.3f} s ({smi})", flush=True)
    total = {k: counts_a[k] + sum(c[k] for c in counts_b) for k in counts_a}
    return total


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
        counts, sys_, rm, gsm_full, x_full, t_full = slice_phase(dev)
    with phase("banded"):
        for kname, n in banded_phase(dev).items():
            counts[kname] += n
    with phase("entry"):
        for kname, n in entry_phase(dev, sys_, gsm_full, smi).items():
            counts[kname] += n
    with phase("panel"):
        for kname, n in panel_phase(dev, sys_, gsm_full, smi).items():
            counts[kname] += n
    with phase("reduced_lu"):
        k4, k4_serve_s = reduced_lu_phase(dev, sys_, gsm_full)
    with phase("serve"):
        k4_checkpoint = serve_phase(dev, sys_, rm, gsm_full, x_full, t_full)
    with phase("matfree"):
        k4_matfree = matfree_phase(dev)
    with phase("general"):
        general_phase(dev)
    with phase("krylov"):
        counts.update(krylov_phase(dev))
    with phase("complex"):
        k5_complex = complex_phase(dev, sys_, k4_serve_s)
    with phase("parallel"):
        for kname, n in parallel_phase(dev, sys_, rm, x_full, smi).items():
            counts[kname] += n
    counts["gauss_jordan_sweep_solve"] = k4 + k4_matfree + k4_checkpoint
    counts["banded_matvec_padded"] += k5_complex

    kernels = []
    for kname in SOURCES:
        r = rec[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in ("variants",) if key in r},
            **{key: r[key] for key in ("device_ms", "library_device_ms",
                                       "bind_f64_ms", "bind_f64_device_ms",
                                       "bind_f64_library_ms",
                                       "bind_f64_library_device_ms")
               if key in r},
        })
    print(smi, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
