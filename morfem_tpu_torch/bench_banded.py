"""Large-N banded-direct MOR benchmark (the reference's config 3).

Counterpart of `tools/bench_banded.py`. The reference's ~34k-DOF stress
case is a 2-D waveguide cross-section; the port runs `morfem()` on the
SciPy-sparse 2-D P1-FEM pencil ``banded_waveguide_system_2d(p, m=2,
seed=1)`` with slots (C, 0, Γ·GAMMA_SCALE): above ``dense_cutoff`` that is
the matrix-free route (RCM-banded block-Thomas snapshot solves and the
matvec-only greedy estimator). The oracle is the banded full-order direct
solve at 7 grid points, in RCM order.

    python -m morfem_tpu_torch.bench_banded [--cpu]

prints one JSON line of ``banded_*`` keys on stdout (or one with
``"error"``, and exit code 1, if the run raised), progress on stderr.
`morfem_tpu_torch.bench` calls `run` in its own process.

Knobs (environment):
  BENCH_BANDED_P       cross-section side p; N = p² (default 97 → N=9,409)
  BENCH_BANDED_POINTS  frequency grid size (default 100)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from morfem_tpu_torch.device import sync

ORACLE_POINTS = 7


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(device="cuda", config=None) -> dict:
    """The banded extra on `device` → its six ``banded_*`` keys.

    `config` defaults to ``MorfemConfig(error_threshold=1e-8)``, the
    reference bench's (a smaller ``dense_cutoff`` keeps a small pencil on
    the matrix-free route)."""
    from morfem_tpu_torch import MorfemConfig, morfem
    from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
    from morfem_tpu_torch.device import resolve_device
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve,
        banded_via_rcm,
    )
    from morfem_tpu_torch.utils.synthetic import banded_waveguide_system_2d

    dev = resolve_device(device)
    n_points = int(os.environ.get("BENCH_BANDED_POINTS", 100))
    bp = int(os.environ.get("BENCH_BANDED_P", 97))
    freq = np.linspace(3e9, 5e9, n_points)
    c_sp, tt_sp, wp = banded_waveguide_system_2d(bp, m=2, seed=1)
    bn = c_sp.shape[0]
    log(f"banded bench: p={bp} N={bn} on {dev}")
    gamma_sp = (tt_sp * GAMMA_SCALE).tocsr()
    zero_sp = 0.0 * c_sp
    cfg = config or MorfemConfig(error_threshold=1e-8)
    t0 = time.perf_counter()
    xb, qb, *_ = morfem(freq, c_sp, zero_sp, gamma_sp, wp, config=cfg,
                        device=dev)
    sync(dev)
    t_banded = time.perf_counter() - t0
    nr = qb.shape[1]
    log(f"morfem() build+sweep: {t_banded:.1f} s (Nr={nr})")

    op, perm = banded_via_rcm(c_sp, zero_sp, gamma_sp,
                              symmetrize=cfg.symmetrize, device=dev)
    b_perm = torch.as_tensor(wp, device=dev)[perm]
    idx = np.linspace(0, n_points - 1, ORACLE_POINTS, dtype=int)
    t0 = time.perf_counter()
    x_oracle = []
    for f in freq[idx]:
        c = torch.tensor([1.0, f, f * f], dtype=torch.float64, device=dev)
        x_oracle.append(banded_direct_solve(op, c, f * b_perm, cfg)[0])
    x_oracle = torch.stack(x_oracle)
    sync(dev)
    t_oracle = (time.perf_counter() - t0) / len(idx)
    # the oracle lives in RCM order
    rec = torch.einsum("nk,ikm->inm", qb[perm], xb[torch.as_tensor(idx)])
    rel = float(torch.linalg.norm(rec - x_oracle)
                / torch.linalg.norm(x_oracle))
    log(f"banded-direct MOR N={bn}: build+sweep {t_banded:.1f} s (Nr={nr}), "
        f"rel err vs banded oracle {rel:.2e}, oracle full-order solve "
        f"{t_oracle * 1e3:.0f} ms/pt")
    return {
        "banded_n_dof": bn,
        "banded_mor_total_s": round(t_banded, 2),
        "banded_basis_size": int(nr),
        "banded_rel_error_vs_oracle": rel,
        "banded_full_order_ms_per_point": round(t_oracle * 1e3, 1),
        "banded_points_per_s": round(n_points / t_banded, 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    try:
        result, rc = run("cpu" if args.cpu else "cuda"), 0
    except Exception as e:  # reported in the line and by the exit code
        log(f"BANDED BENCH FAILED: {type(e).__name__}: {e}")
        result, rc = {"error": f"{type(e).__name__}: {e}"}, 1
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
