"""Large-N stress test — BASELINE config 3 (upscaled system).

Builds a `rate`×-larger waveguide system with the reference's
block-diagonal upscaler (`upscale_block_diag`) and runs the
equally-distributed MOR pipeline on it, reporting timings and the
reduced-vs-full-order error at a few check points. With ``--sparse`` the
snapshot solves go through the CSR / BiCGStab matrix-free path
(`ops/sparse.py`) instead of dense LU.

Usage:
    python -m morfem_tpu_torch.examples.large_n_sweep [--base-n 3411]
        [--rate 4] [--sparse] [--cpu]
"""

import argparse
import time

import numpy as np
import torch

from morfem_tpu_torch import (
    AffineSystem,
    MorfemConfig,
    equally_distributed_basis,
    project,
    solve_point,
    sweep,
)
from morfem_tpu_torch.apps.studies import upscale_block_diag
from morfem_tpu_torch.apps.waveguide import load_waveguide_data, waveguide_system
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.equally import seed_indices
from morfem_tpu_torch.mor.reduced import ReducedModel


def _sync(x, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return x


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base-n", type=int, default=3411)
    p.add_argument("--rate", type=int, default=4)
    p.add_argument("--points", type=int, default=40)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--sparse", action="store_true",
                   help="CSR + BiCGStab snapshot solves")
    p.add_argument("--check-points", type=int, default=3,
                   help="full-order points to verify against (0 disables)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    data = load_waveguide_data(n_fallback=args.base_n)
    base = waveguide_system(np.linspace(3e9, 5e9, args.points), data,
                            device=dev)
    (a0, a1, a2), b = upscale_block_diag(
        [x.cpu().numpy() for x in base.operators()], base.b.cpu().numpy(),
        rate=args.rate)
    n = a0.shape[0]
    print(f"upscaled system: N = {n} (= {base.n} × {args.rate})")
    sys_ = AffineSystem.create(base.domain, a0, a1, a2, b, t_b=base.t_b,
                               device=dev)
    cfg = MorfemConfig()

    t0 = time.perf_counter()
    if args.sparse:
        import scipy.sparse as sp

        from morfem_tpu_torch.ops.sparse import (
            sparse_project,
            sparse_snapshot_basis,
        )

        mats = tuple(sp.csr_array(a) for a in (a0, a1, a2))
        sidx = seed_indices(args.points, cfg, count=args.seeds)
        coeffs = (sys_.t_a0, sys_.t_a1, sys_.t_a2, sys_.t_b)
        q = sparse_snapshot_basis(mats, sys_.b, sys_.domain, sidx, coeffs,
                                  cfg, tol=1e-10)
        (r0, r1, r2), b_r = sparse_project(mats, sys_.b, q)
        rm = ReducedModel(
            domain=sys_.domain, q=q, r0=r0, r1=r1, r2=r2, b_r=b_r,
            ncols=q.shape[1], t_a0=sys_.t_a0, t_a1=sys_.t_a1,
            t_a2=sys_.t_a2, t_b=sys_.t_b)
    else:
        q = equally_distributed_basis(sys_, cfg, count=args.seeds)
        rm = project(sys_, q)
    _sync(rm, dev)
    t_basis = time.perf_counter() - t0
    print(f"basis + projection ({args.seeds} seeds): {t_basis:.2f} s "
          f"(Nr = {rm.q.shape[1]})")

    t0 = time.perf_counter()
    x = _sync(sweep(rm, cfg), dev)
    print(f"reduced sweep ({args.points} pts): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    if args.check_points:
        idx = np.linspace(1, args.points - 2, args.check_points).astype(int)
        errs = []
        for i in idx:
            xf = solve_point(sys_, sys_.domain[int(i)], cfg)
            rec = rm.q @ x[int(i)]
            errs.append(float(torch.linalg.norm(rec - xf)
                              / torch.linalg.norm(xf)))
        print(f"rel error vs full-order at {args.check_points} check "
              f"points: max {max(errs):.2e}")
    print("Done")


if __name__ == "__main__":
    main()
