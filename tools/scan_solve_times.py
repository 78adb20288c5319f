"""The banded direct solve (block Thomas, "scan") timed on the card for one
tree of the port, on the N=34,225 2-D waveguide pencil.

    python3 tools/scan_solve_times.py [PACKAGE_ROOT] [--reps N]

Builds `banded_waveguide_system_2d(185)` (C, 0, Γ = scaled T; RCM
half-bandwidth 369, blocks of 384) through `banded_via_rcm` and times
`banded_direct_solve(op, c, f·b)` at 3, 4 and 5 GHz: one warm-up, then
``--reps`` solves each, host clock around a synchronised call. Prints one
JSON line: the tree, the card's name and power limit, and per frequency
the seconds of each solve, the refinement iterations and the worst
relative residual.

Only API that every tree of the port has is used, so PACKAGE_ROOT
(default: this checkout; put first on the import path) may be an older
tree unpacked with `git archive <commit> morfem_tpu_torch`: run trees in
turns in one call (parent, change, change, parent) to compare them on one
card.
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
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("scan_solve_times: no CUDA device", file=sys.stderr)
        return 1
    import morfem_tpu_torch
    from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )
    from morfem_tpu_torch.utils.synthetic import banded_waveguide_system_2d

    dev = torch.device("cuda")
    c_sp, t_sp, wp = banded_waveguide_system_2d(185, m=2, seed=1)
    op, perm = banded_via_rcm(c_sp, 0.0 * c_sp, (t_sp * GAMMA_SCALE).tocsr(),
                              device=dev)
    b = torch.as_tensor(wp, device=dev)[perm]
    rows = []
    for f in (3e9, 4e9, 5e9):
        c = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        banded_direct_solve(op, c, f * b)  # warm-up
        secs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, relres, iters = banded_direct_solve(op, c, f * b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rows.append({"f": f, "seconds": secs, "iterations": iters,
                     "relres": float(relres.max())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"tree": str(Path(morfem_tpu_torch.__file__).parent),
                      "card": smi, "n": op.n, "half": op.half,
                      "solves": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
