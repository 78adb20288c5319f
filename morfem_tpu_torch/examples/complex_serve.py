"""Complex serving demo: checkpoint a complex reduced model, re-sweep any
grid.

Builds an absorbing-Helmholtz-like complex pencil with a complex t_b, runs
`morfem()` (the interleaved-embedding matrix-free route), saves the
returned complex model with `save_reduced_model`, reloads it, serves an
off-grid sweep in complex128 (`sweep_complex_reduced`) and checks three
points against SciPy's complex solve.

Usage:
    python -m morfem_tpu_torch.examples.complex_serve [--n 600] [--cpu]
"""

import argparse
import os
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from morfem_tpu_torch import (
    MorfemConfig,
    ReducedModel,
    load_reduced_model,
    morfem,
    save_reduced_model,
    sweep_complex_reduced,
)


def build_pencil(n, seed=7, half=6):
    rng = np.random.default_rng(seed)
    offs = list(range(0, half + 1))
    diags = [(8.0 + rng.random(n)) + 1j * 0.4] + [
        (-0.3 + 0.05j) * np.ones(n - d) for d in offs[1:]
    ]
    a0 = sp.diags(diags, offs).tocsr()
    a0 = (a0 + a0.T) * 0.5  # complex symmetric (not Hermitian)
    a1 = sp.csr_matrix((n, n))
    a2 = (sp.eye(n) * -1.0).tocsr()
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return a0, a1, a2, b


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=600)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--checkpoint", default="output/complex_model.npz")
    args = p.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    n = args.n
    a0, a1, a2, b = build_pencil(n)
    domain = np.linspace(0.8, 2.0, 24)
    fns = dict(
        t_a0=lambda t: torch.ones_like(t),
        t_a1=lambda t: torch.zeros_like(t),
        t_a2=lambda t: t**2,
        t_b=lambda t: t * torch.exp(1j * 0.7 * t),  # complex drive
    )
    cfg = MorfemConfig(symmetrize=False, dense_cutoff=256,
                       error_threshold=1e-18)
    t0 = time.time()
    x, q, r0, r1, r2, b_r = morfem(domain, a0, a1, a2, b, config=cfg,
                                   device=dev, **fns)
    print(f"offline build: {time.time()-t0:.1f} s  (N={n}, Nr={q.shape[1]})")

    rm = ReducedModel(domain=torch.as_tensor(domain, device=dev), q=q, r0=r0,
                      r1=r1, r2=r2, b_r=b_r, ncols=q.shape[1], **fns)
    os.makedirs(os.path.dirname(args.checkpoint) or ".", exist_ok=True)
    save_reduced_model(args.checkpoint, rm)
    rm2 = load_reduced_model(args.checkpoint, device=dev, **fns)
    print(f"checkpoint round-trip: {args.checkpoint}")

    grid2 = np.linspace(0.85, 1.95, 501)  # an off-grid request
    t0 = time.time()
    x2 = sweep_complex_reduced(rm2.r0, rm2.r1, rm2.r2, rm2.b_r, grid2,
                               device=dev, **fns)
    x2 = x2.cpu().numpy()
    dt = time.time() - t0
    print(f"served {len(grid2)}-pt off-grid sweep in {dt*1e3:.1f} ms "
          f"({len(grid2)/dt:,.0f} points/s, complex128)")
    qn = rm2.q.cpu().numpy()
    worst = 0.0
    for i in (0, 250, 500):
        t = grid2[i]
        ref = spla.spsolve((a0 + t**2 * a2).tocsc(),
                           (t * np.exp(1j * 0.7 * t)) * b)
        rec = qn @ x2[i]
        worst = max(worst,
                    float(np.linalg.norm(rec - ref) / np.linalg.norm(ref)))
    print(f"worst rel error vs SciPy complex solve (off-grid): {worst:.2e}")
    assert worst < 1e-8, worst
    print("OK")


if __name__ == "__main__":
    main()
