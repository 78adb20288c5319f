"""Random-matrix MOR prototype — the reference's experiments.py on the
port (a random diagonally heavy system, snapshot solves at 5 seed points,
QR orthonormalization, projection, sparsity spy plots; experiments.py:
45-95), with the frequency sweep the reference left unfinished completed
by the reduced sweep and checked against the full-order sweep.

Usage:
    python -m morfem_tpu_torch.examples.random_matrix_experiment
        [--n 1000] [--cpu] [--no-plots]
"""

import argparse
import os

import torch

from morfem_tpu_torch import AffineSystem, MorfemConfig, project, sweep
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.ops.solve import solve_batch, solve_sweep
from morfem_tpu_torch.utils.synthetic import diagonal_heavy_matrix


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--m", type=int, default=2)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--no-plots", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    n, m = args.n, args.m
    g = torch.Generator().manual_seed(0)
    # the reference's Γ + s·G + s²·C with impulse s·B; the diagonal shifts
    # keep A(s) well conditioned across the band (the reference's raw
    # random matrices made A(s) near-singular at its high end)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    gamma = diagonal_heavy_matrix(g, n, 10.0, 0.02, device=dev) + 30.0 * eye
    g_mat = diagonal_heavy_matrix(g, n, 10.0, 0.02, device=dev)
    c_mat = diagonal_heavy_matrix(g, n, 10.0, 0.02, device=dev) + 15.0 * eye
    b = (torch.rand((n, m), generator=g, dtype=torch.float64) * 20.0
         - 10.0).to(dev)

    seed_points = torch.tensor([3.0, 3.5, 4.0, 4.5, 5.0],
                               dtype=torch.float64, device=dev)
    sys_ = AffineSystem.create(torch.linspace(3.0, 5.0, 21,
                                              dtype=torch.float64),
                               gamma, g_mat, c_mat, b, device=dev)
    cfg = MorfemConfig()

    snaps = solve_batch(sys_, seed_points, cfg)  # [5, N, M]
    q = torch.linalg.qr(snaps.transpose(0, 1).reshape(n, -1))[0]
    rm = project(sys_, q)
    x = sweep(rm, cfg)
    print(f"reduced model: {rm.q.shape[1]} columns; sweep "
          f"x{tuple(x.shape)}")

    rec = torch.einsum("nk,ikm->inm", rm.q, x)
    x_full = solve_sweep(sys_, cfg)
    rel = float(torch.linalg.norm(rec - x_full) / torch.linalg.norm(x_full))
    print(f"relative error vs full-order sweep: {rel:.3e}")

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs("output", exist_ok=True)
        fig, plots = plt.subplots(1, 2, figsize=(10, 5))
        plots[0].spy(gamma.abs().cpu().numpy() > 1e-12, markersize=0.2)
        plots[0].set_title("Original Gamma")
        plots[1].spy(rm.r0.abs().cpu().numpy() > 1e-12, markersize=2)
        plots[1].set_title("Reduced Gamma")
        plt.savefig("output/random_matrix_spy.png", bbox_inches="tight")
        plt.close(fig)
        print("plot saved to output/random_matrix_spy.png")
    print("Done")


if __name__ == "__main__":
    main()
