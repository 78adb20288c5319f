"""Multi-geometry parameter batch — BASELINE config 5, on several ranks.

Runs G independent MOR problems (a parameter scan of random affine
systems) through the equally-distributed pipeline with
`multi_geometry_mor` on a ('dp','sp','tp') mesh of spawned ranks: the
geometries are split over dp (`parallel/sharded.py`). Without ``--cpu``
the ranks run on the CUDA cards over NCCL (default: one rank per card);
with ``--cpu`` on gloo CPU ranks:

    python -m morfem_tpu_torch.examples.multi_geometry --cpu --ranks 4
"""

import argparse
import time

import torch

from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.parallel.launch import run_spmd


def _rank(n, g, points, seeds, device):
    """Every rank: build the same G systems, run the batch twice (first
    and steady), and check geometry 0 against the single-system pipeline."""
    import torch.distributed as dist

    from morfem_tpu_torch import (
        AffineSystem,
        MorfemConfig,
        equally_distributed_basis,
        project,
        sweep,
    )
    from morfem_tpu_torch.mor.equally import seed_indices
    from morfem_tpu_torch.parallel import (
        batch_systems,
        factorize_mesh,
        make_mesh,
        multi_geometry_mor,
    )
    from morfem_tpu_torch.utils.synthetic import random_affine_system

    dims = factorize_mesh(dist.get_world_size())
    mesh = make_mesh(*dims)
    cfg = MorfemConfig()
    systems = [
        AffineSystem.create(*random_affine_system(
            k, n=n, m=2, num_points=points, device=device), device=device)
        for k in range(g)
    ]
    batch = batch_systems(systems)
    sidx = seed_indices(points, cfg, count=seeds)
    s0 = systems[0]
    coeffs = (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b)
    times = []
    for _ in range(2):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, q = multi_geometry_mor(*batch, sidx, coeffs, cfg, mesh=mesh)
        float(x.sum())  # waits for the device
        times.append(time.perf_counter() - t0)
    qg = equally_distributed_basis(s0, cfg, count=seeds)
    rec_s = torch.einsum("nk,ikm->inm", qg, sweep(project(s0, qg), cfg))
    rec_b = torch.einsum("nk,ikm->inm", q[0], x[0])
    rel = float(torch.linalg.norm(rec_b - rec_s) / torch.linalg.norm(rec_s))
    return {"dims": dims, "times": times, "rel": rel,
            "device": str(x.device)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--geometries", type=int, default=8)
    p.add_argument("--points", type=int, default=64)
    p.add_argument("--seeds", type=int, default=6)
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

    out = run_spmd(_rank, ranks, backend, device, args.n, args.geometries,
                   args.points, args.seeds, device)
    dp, sp, tp = out["dims"]
    print(f"ranks: {ranks} ({backend}, {out['device']})  "
          f"mesh: dp={dp} sp={sp} tp={tp}")
    print(f"{args.geometries} geometries × {args.points} points, "
          f"N={args.n}: first {out['times'][0]:.2f} s, "
          f"steady {out['times'][1]:.2f} s")
    print(f"geometry 0 batched-vs-single rel diff: {out['rel']:.2e}")
    print("Done")


if __name__ == "__main__":
    main()
