"""Run some of chip_smoke.py's phases in several checkouts, one after
another, on one card, so that their times compare within one machine.

    python3 chip_smoke_ab.py [--phases P,P,...] DIR [DIR ...]

Each DIR is the root of a checkout (e.g. the parent commit unpacked with
`git archive`, then this tree, this tree, the parent). For each, in the
order given, a fresh process imports that checkout's `chip_smoke.py` and
`morfem_tpu_torch`, builds the kernels and runs the phases named, in
this order, each with its usual checks:

  kernels     the checkout's own kernels phase (its shapes, all kernels);
  k1          K1 (`panel_factor`) timed at the full-pivot shapes with C̃
              ([G, 128, 3456] for G = 1, 6, 8, 16, 20; [1, 384, 1536];
              [1, 128, 8192]) and at the block-pivot [8, 384, 384] and
              [20, 384, 384] without, through the API that every tree of
              the port has, each call's pivots held to the plain version;
              then K2 and K3 at the block-pivot path's shapes
              ([8,3072,384]@[8,384,3072] + t and [8,384,384]@[8,384,3072];
              the A12 rows [8,384,3072]), per call and on the device alone
              (K2's split passes and GEMM apart, from a torch.profiler
              trace);
  banded      the banded sweep's Schur-complement inverses (alone: it
              prepares its own N=34,110 pencil);
  slice       the waveguide end to end (the later phases need it; it runs
              whenever one of them is named);
  entry       the flagship step, where the checkout has it;
  panel       morfem(factorization="panel") on the waveguide;
  reduced_lu, serve, matfree, krylov, parallel.

A phase that the checkout's `chip_smoke.py` lacks (`panel` before it was
added) runs from the `chip_smoke.py` beside this script, on that
checkout's package. The default is `slice,entry,krylov,parallel`. The
phases' lines go to stdout, each run opened by a line naming its index
and DIR. Exits non-zero if any run failed. Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

PHASES = ("kernels", "k1", "banded", "slice", "entry", "panel", "reduced_lu",
          "serve", "matfree", "krylov", "parallel")
DEFAULT = "slice,entry,krylov,parallel"
K1_SHAPES = (((1, 128, 3456), True), ((6, 128, 3456), True),
             ((8, 128, 3456), True), ((16, 128, 3456), True),
             ((20, 128, 3456), True), ((1, 384, 1536), True),
             ((1, 128, 8192), True), ((8, 384, 384), False),
             ((20, 384, 384), False))


def _own_chip_smoke():
    """The chip_smoke.py beside this script, under another module name."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_device_ms(fn, names, reps=20):
    """Device time of each kernel whose name contains one of `names`, per
    call of `fn`, from a torch.profiler trace of `reps` calls."""
    import json
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    us = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for n in names:
                if n in e["name"]:
                    us[n] += float(e["dur"])
    return {n: t / 1e3 / reps for n, t in us.items()}


def k1_times(cs, dev, smi):
    """K1 per call (CUDA events, mean of 5 after a warm-up) at K1_SHAPES,
    then K2 and K3 at the block-pivot path's shapes (mean of 50 and 20)."""
    import torch

    from morfem_tpu_torch.ops.kernels import (
        gather_rows, mm_words, panel_factor, panel_factor_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    for (g, p, npl), want_ct in K1_SHAPES:
        pt = torch.randn((g, p, npl), generator=gen, device=dev)
        av = torch.ones((g, npl), device=dev)
        got = panel_factor(pt, av, want_ct=want_ct)
        ref = panel_factor_plain(pt, av, want_ct=want_ct)
        cs.check(torch.equal(got[2], ref[2]),
                 f"K1 pivots differ at {[g, p, npl]}")
        ms = cs.cuda_ms(lambda: panel_factor(pt, av, want_ct=want_ct), 5)
        print(f"  k1 [{g},{p},{npl}] want_ct={want_ct} kernel_ms={ms:.4f} "
              f"({smi})", flush=True)
    for g, m, k, n, with_t in ((8, 3072, 384, 3072, True),
                               (8, 384, 384, 3072, False)):
        c = torch.randn((g, m, k), generator=gen, device=dev)
        r = torch.randn((g, k, n), generator=gen, device=dev)
        t = (torch.randn((g, m, n), generator=gen, device=dev) if with_t
             else None)
        ms = cs.cuda_ms(lambda: mm_words(c, r, t, sign=-1), 50)
        dev_ms = kernel_device_ms(lambda: mm_words(c, r, t, sign=-1),
                                  ("split_words_kernel", "mm_words_kernel"))
        print(f"  k2 [{g},{m},{k}]@[{g},{k},{n}] t={with_t} "
              f"kernel_ms={ms:.4f} split_device_ms="
              f"{dev_ms['split_words_kernel']:.4f} gemm_device_ms="
              f"{dev_ms['mm_words_kernel']:.4f} ({smi})", flush=True)
    src = torch.randn((8, 384, 3072), generator=gen, device=dev)
    idx = torch.stack([torch.randperm(384, generator=gen, device=dev)
                       for _ in range(8)]).to(torch.int32)
    ms = cs.cuda_ms(lambda: gather_rows(src, idx), 20)
    dev_ms = cs.device_ms(lambda: gather_rows(src, idx))
    print(f"  k3 [8,384,3072] P=384 kernel_ms={ms:.4f} device_ms="
          f"{cs._fmt(dev_ms)} ({smi})", flush=True)


def run_one(root: str, phases) -> None:
    """The phases of the checkout at `root`, in this process."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from morfem_tpu_torch.ops.kernels import _lib

    def runner(name):
        if hasattr(cs, f"{name}_phase"):
            return getattr(cs, f"{name}_phase")
        return getattr(_own_chip_smoke(), f"{name}_phase")

    cs.BUDGET.setdefault("k1", 300)
    cs.BUDGET.setdefault("panel", 300)  # before the phase was added
    cs.BUDGET.setdefault("banded", 600)
    dev = torch.device("cuda")
    smi = _own_chip_smoke().nvidia_smi_line()
    print(f"  {smi}", flush=True)
    with cs.phase("build"):
        _lib.load()
    if "kernels" in phases:
        with cs.phase("kernels"):
            cs.kernel_phase(dev)
    if "k1" in phases:
        with cs.phase("k1"):
            k1_times(cs, dev, smi)
    if "banded" in phases:
        with cs.phase("banded"):
            runner("banded")(dev)
    if not set(phases) & set(PHASES[3:]):
        return
    with cs.phase("slice"):
        _, sys_, rm, gsm_full, x_full, t_full = cs.slice_phase(dev)
    if "entry" in phases and hasattr(cs, "entry_phase"):
        with cs.phase("entry"):
            cs.entry_phase(dev, sys_, gsm_full, smi)
    if "panel" in phases:
        with cs.phase("panel"):
            runner("panel")(dev, sys_, gsm_full, smi)
    if "reduced_lu" in phases:
        with cs.phase("reduced_lu"):
            cs.reduced_lu_phase(dev, sys_, gsm_full)
    if "serve" in phases:
        with cs.phase("serve"):
            cs.serve_phase(dev, sys_, rm, gsm_full, x_full, t_full)
    if "matfree" in phases:
        with cs.phase("matfree"):
            cs.matfree_phase(dev)
    if "krylov" in phases:
        with cs.phase("krylov"):
            cs.krylov_phase(dev)
    if "parallel" in phases:
        with cs.phase("parallel"):
            cs.parallel_phase(dev, sys_, rm, x_full, smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=DEFAULT,
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--run-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="+")
    opts = ap.parse_args(argv)
    phases = [p for p in opts.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    if opts.run_one:
        run_one(os.path.abspath(opts.dirs[0]), phases)
        return 0
    failed = []
    for i, d in enumerate(opts.dirs):
        root = os.path.abspath(d)
        print(f"=== run {i}: {root}", flush=True)
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run-one",
             "--phases", ",".join(phases), root],
            cwd=root).returncode
        print(f"=== run {i} rc={rc}", flush=True)
        if rc:
            failed.append(i)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
