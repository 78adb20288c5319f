"""Full-order sweep and MOR times of the port on the dense waveguide.

    python3 tools/sweep_refinement.py [PACKAGE_ROOT] [--cache DIR] [--reps N]

Runs `morfem_tpu_torch.ops.panel_lu.solve_sweep_panel` on the bundled
N=3411 waveguide (M=2, I=100 over 3-5 GHz, error_threshold=1e-10: the
slice phase of chip_smoke.py) on the card N times (default 2; the first
run pays warm-up), each followed by `apps.waveguide.mor_gsm` (greedy
basis, projection, spectral sweep, GSM), and prints one JSON line per run:
the sweep's seconds, the number of full-pivot factors (block-pivot
escalations), the refinement iterations of every refinement loop in order
(one per chunk, two for an escalated chunk), the relative error against
`torch.linalg.solve` (f64) at three points, and mor_gsm's seconds and Nr.
Times are host clock around work that ends in a synchronise. The last line
is the card's name and power limit from nvidia-smi.

PACKAGE_ROOT (default: this checkout) is put first on the import path, so
the same script measures an older tree of the port, e.g. one unpacked with
`git archive <commit> morfem_tpu_torch` (run parent, change, change,
parent in one call to compare two trees on one card); it counts through wrappers around
module functions and needs no counters in the tree it measures. --cache
names the directory of `synthetic_wg_3411.npz` (default: the bundled
cache of the tree measured).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--cache", default=None)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import numpy as np
    import torch

    import morfem_tpu_torch
    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, mor_gsm, waveguide_system,
    )
    from morfem_tpu_torch.ops import panel_lu
    from morfem_tpu_torch.ops.assembly import assemble_at

    if not torch.cuda.is_available():
        print("sweep_refinement: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    data = load_waveguide_data(n_fallback=3411, cache_dir=args.cache)
    sys_ = waveguide_system(np.linspace(3e9, 5e9, 100), data, device=dev)
    cfg = MorfemConfig(error_threshold=1e-10)

    loops, full = [], [0]
    refine, factor = panel_lu._refine, panel_lu.panel_lu_factor

    def counting_refine(x, residual, apply, tol, cap):
        n = [0]

        def counted(r):
            n[0] += 1
            return apply(r)

        out = refine(x, residual, counted, tol, cap)
        loops.append(n[0])
        return out

    def counting_factor(*a, **k):
        full[0] += 1
        return factor(*a, **k)

    # the tree's own counter, where it has one, reads this attribute
    counting_refine.iterations = 0
    panel_lu._refine = counting_refine
    panel_lu.panel_lu_factor = counting_factor
    for rep in range(args.reps):
        loops.clear()
        full[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = panel_lu.solve_sweep_panel(sys_, cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        errs = []
        for i in (0, 50, 99):
            a, b = assemble_at(sys_, sys_.domain[i], symmetrize=cfg.symmetrize)
            xr = torch.linalg.solve(a, b)
            errs.append(float(torch.linalg.norm(x[i] - xr)
                              / torch.linalg.norm(xr)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rm, _ = mor_gsm(sys_, cfg)
        torch.cuda.synchronize()
        mor_seconds = time.perf_counter() - t0
        print(json.dumps({
            "package": str(Path(morfem_tpu_torch.__file__).parent),
            "device": torch.cuda.get_device_name(0), "run": rep,
            "sweep_s": seconds, "full_pivot_factors": full[0],
            "refinement_iterations": loops,
            "total_iterations": sum(loops),
            "spot_rel_err_vs_solve": errs,
            "mor_s": mor_seconds, "nr": int(rm.ncols),
        }), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
