"""The two paths K4 and K6 carry, timed on the card for one tree of the port.

    python3 tools/serve_and_krylov.py [PACKAGE_ROOT] [--cache DIR] [--reps N]

1. Serving: the reduced model of the bundled N=3411 waveguide (built once
   by `morfem()` with the K4 LU sweep, as chip_smoke.py's reduced_lu
   phase does), re-swept on a 10,000-point grid by `sweep(rm, config,
   ts)`: four K4 launches and three f64 refinement passes.
2. Krylov: `greedy_basis_matfree(method="bicgstab")` on chip_smoke.py's
   Krylov pencil at N=34,225 (`krylov_pencil`), through the block-sparse
   operator (K6) and, as a yardstick on the same host, the banded one
   (K5).

Each is run --reps times after one warm-up run; the script prints one JSON
line per path with every time (host clock around work that ends in
`torch.cuda.synchronize()`), and the card's name. The re-sweep is also
timed on the device alone (chip_smoke.py's `device_ms`: the calls queued
behind a sleeping kernel), since its host time per call varies from run
to run.

PACKAGE_ROOT (default: this checkout) is put first on the import path, so
the same script measures an older tree of the port, e.g. one unpacked with
`git archive <commit> morfem_tpu_torch`: run trees in turns in one call
(parent, change, change, parent) to compare them on one card. The pencil
comes from this checkout's chip_smoke.py; --cache names the directory of
`synthetic_wg_3411.npz` (default: the bundled cache of the tree measured).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _timed(fn, reps):
    import torch

    fn()  # warm-up
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--cache", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import numpy as np
    import torch

    import morfem_tpu_torch
    from morfem_tpu_torch import MorfemConfig, morfem, sweep
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, waveguide_system,
    )
    from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
    from morfem_tpu_torch.mor.reduced import ReducedModel
    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.block_sparse import BlockSparseAffineOperator

    if not torch.cuda.is_available():
        print("serve_and_krylov: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    head = {"package": str(Path(morfem_tpu_torch.__file__).parent),
            "device": torch.cuda.get_device_name(0)}

    data = load_waveguide_data(n_fallback=3411, cache_dir=args.cache)
    sys_ = waveguide_system(np.linspace(3e9, 5e9, 100), data, device=dev)
    cfg = MorfemConfig(error_threshold=1e-10, sweep_method="lu",
                       use_pallas_reduced_sweep=True)
    _, q, r0, r1, r2, b_r = morfem(
        sys_.domain, sys_.a0, sys_.a1, sys_.a2, sys_.b, t_b=sys_.t_b,
        config=cfg, device=dev)
    rm = ReducedModel(domain=sys_.domain, q=q, r0=r0, r1=r1, r2=r2, b_r=b_r,
                      ncols=q.shape[1], t_a0=sys_.t_a0, t_a1=sys_.t_a1,
                      t_a2=sys_.t_a2, t_b=sys_.t_b)
    ts = torch.linspace(3e9, 5e9, 10000, dtype=torch.float64, device=dev)
    t = _timed(lambda: sweep(rm, cfg, ts), args.reps)
    dev_ms = smoke.device_ms(lambda: sweep(rm, cfg, ts), 2)
    print(json.dumps(dict(head, path="serve", points=10000, nr=q.shape[1],
                          seconds=t, points_per_s=10000 / min(t),
                          device_ms=dev_ms)), flush=True)

    n = smoke.P_34K ** 2
    domain = np.linspace(1.0, 2.0, 100)
    b = np.random.default_rng(1).normal(size=(n, 2))
    kcfg = MorfemConfig(error_threshold=1e-9)
    for kind in ("block_sparse", "banded"):
        mats = smoke.krylov_pencil(n, scattered=kind == "block_sparse")
        op = (BlockSparseAffineOperator(*mats, device=dev)
              if kind == "block_sparse"
              else BandedAffineOperator(*mats, device=dev))
        t = _timed(lambda: greedy_basis_matfree(op, b, domain, config=kcfg,
                                                method="bicgstab"),
                   args.reps)
        print(json.dumps(dict(head, path=f"krylov_{kind}", n=n,
                              greedy_s=t)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
