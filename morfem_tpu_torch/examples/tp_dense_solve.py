"""Tensor-parallel dense direct solve — N×N systems across ranks.

Demonstrates `parallel/tp_dense.py`: the column-sharded blocked
Gauss–Jordan factorization, whose only per-panel communication is one
masked all_reduce, and the two solve shapes built on it:

  * factor once → many right-hand sides (`tp_gj_factor` + the f64-refined
    `tp_solve_dense`) — the serving shape;
  * one call end to end (`tp_solve_dense_compiled`) — the one-shot shape.

Without ``--cpu`` the ranks run on the CUDA cards over NCCL (default: one
rank per card); with ``--cpu`` on gloo CPU ranks:

    python -m morfem_tpu_torch.examples.tp_dense_solve --cpu --ranks 4
"""

import argparse
import time

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.parallel.launch import run_spmd


def _problem(n, rhs):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, n)) + n * np.eye(n),
            rng.standard_normal((n, rhs)))


def _rank(n, rhs, panel, device):
    """Every rank: factor, refined solve and one-shot solve on a tp mesh of
    all ranks; returns the times and both solutions."""
    import torch.distributed as dist

    from morfem_tpu_torch.parallel import (
        make_mesh,
        tp_gj_factor,
        tp_solve_dense,
        tp_solve_dense_compiled,
    )

    mesh = make_mesh(tp=dist.get_world_size())
    a_np, b_np = _problem(n, rhs)
    a = torch.from_numpy(a_np).to(device)
    b = torch.from_numpy(b_np).to(device)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        x = out.c if hasattr(out, "c") else out
        float(x.sum())  # waits for the device
        return out, time.perf_counter() - t0

    fac, t_fac = timed(lambda: tp_gj_factor(a, mesh, panel=panel))
    x, t_solve = timed(lambda: tp_solve_dense(a, b, mesh, fac=fac,
                                              panel=panel))
    x2, t_one = timed(lambda: tp_solve_dense_compiled(a, b, mesh,
                                                      panel=panel))
    return {"times": (t_fac, t_solve, t_one), "refined": x,
            "compiled": x2}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--rhs", type=int, default=4)
    p.add_argument("--panel", type=int, default=128)
    p.add_argument("--cpu", action="store_true", help="gloo CPU ranks")
    p.add_argument("--ranks", type=int, default=0,
                   help="ranks (default: one per card; 2 with --cpu)")
    args = p.parse_args(argv)
    if args.cpu:
        device, backend, ranks = "cpu", "gloo", args.ranks or 2
    else:
        resolve_device("cuda")  # raises without a card
        device, backend = "cuda", "nccl"
        ranks = args.ranks or torch.cuda.device_count()
    print(f"ranks: {ranks} ({backend}, {device})  mesh: tp={ranks}  "
          f"N={args.n}")

    out = run_spmd(_rank, ranks, backend, device, args.n, args.rhs,
                   args.panel, device)
    t_fac, t_solve, t_one = out["times"]
    print(f"factor {t_fac:.2f} s, refined solve {t_solve:.2f} s")
    print(f"one-shot solve: {t_one:.2f} s")
    a, b = _problem(args.n, args.rhs)
    ref = np.linalg.solve(a, b)
    worst = 0.0
    for name in ("refined", "compiled"):
        rel = float(np.linalg.norm(out[name].numpy() - ref)
                    / np.linalg.norm(ref))
        worst = max(worst, rel)
        print(f"  {name}: rel error vs numpy {rel:.2e}")
    if not worst < 1e-10:
        raise RuntimeError(f"rel error {worst:.2e} >= 1e-10")
    print("OK")


if __name__ == "__main__":
    main()
