"""General-sparsity MOR — the arbitrary-`splu` route, end to end.

Builds an indefinite Helmholtz-like pencil whose sparsity no ordering can
band-recover (a FEM band PLUS random long-range couplings), hands the
SciPy matrices straight to `morfem()`, and checks the reduced sweep
against dense full-order oracles. Routing (all automatic):

  N > config.dense_cutoff with SciPy-sparse inputs
    → matrix-free (`mor/api.py`), RCM tried first
    → bandwidth rejection → truncated-band route:
        exact applies   : dense-block BSR (`ops/block_sparse.py`, kernel
                          K6), ELL or CSR, by how well the pattern blocks;
        snapshot solves : exact-operator GMRES preconditioned by the
                          shifted block-direct factorization of the
                          in-band part (`ops/block_tridiag.py`).

Usage:
    python -m morfem_tpu_torch.examples.general_sparse_mor [--n 9000]
        [--points 40] [--cpu]
"""

import argparse
import time

import numpy as np
import scipy.sparse as sp
import torch

import morfem_tpu_torch as mt
from morfem_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=9000)
    p.add_argument("--points", type=int, default=40)
    p.add_argument("--half", type=int, default=14,
                   help="FEM band half-width of the synthetic pencil")
    p.add_argument("--far", type=int, default=400,
                   help="number of long-range couplings")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--check-points", type=int, default=3)
    p.add_argument("--dense-cutoff", type=int, default=4000,
                   help="N above which the matrix-free route is taken")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    rng = np.random.default_rng(11)
    n = args.n
    offs = list(range(0, args.half + 1))
    diags = [6.0 + rng.random(n)] + [-0.15 * np.ones(n - d)
                                     for d in offs[1:]]
    a0 = sp.diags(diags, offs).tocsr()
    a0 = (a0 + a0.T) * 0.5
    far = sp.coo_matrix(
        (0.03 * rng.standard_normal(args.far),
         (rng.integers(0, n, args.far), rng.integers(0, n, args.far))),
        shape=(n, n),
    )
    a0 = (a0 + far + far.T).tocsr()  # long-range: not band-recoverable
    a1 = sp.csr_matrix((n, n))
    a2 = (sp.eye(n) * -1.0).tocsr()  # A(t) = A0 − t²·I: indefinite in-band
    b = rng.standard_normal((n, 2))
    domain = np.linspace(0.5, 2.2, args.points)

    cfg = mt.MorfemConfig(
        band_max_half=64,  # preconditioner band (keeps dropped mass tiny)
        dense_cutoff=args.dense_cutoff,
        use_equally_distributed=True,
        equally_distributed_reduction_rate=0.75,
    )
    print(f"N={n} nnz={a0.nnz + a2.nnz} I={args.points} device={dev}")

    t0 = time.perf_counter()
    x_r, q, *_ = mt.morfem(domain, a0, a1, a2, b, config=cfg, device=dev)
    x = torch.einsum("nk,ikm->inm", q, x_r)
    print(f"morfem (matrix-free, general sparsity): "
          f"{time.perf_counter() - t0:.1f} s, basis Nr={q.shape[1]}")

    if args.check_points:
        idx = np.linspace(0, args.points - 1, args.check_points, dtype=int)
        worst = 0.0
        for i in idx:
            t = domain[i]
            ref = np.linalg.solve(a0.toarray() - t**2 * np.eye(n), t * b)
            rel = float(np.linalg.norm(x[i].cpu().numpy() - ref)
                        / np.linalg.norm(ref))
            worst = max(worst, rel)
            print(f"  t={t:.3f}: rel error vs dense oracle {rel:.2e}")
        if not worst < 1e-6:
            raise RuntimeError(f"worst rel error {worst:.2e} >= 1e-6")
        print(f"OK — worst rel error {worst:.2e}")


if __name__ == "__main__":
    main()
