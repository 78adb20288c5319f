"""Basis-size tradeoff study — the reference's
speed_and_error_of_no_points_in_q.py on the port.

Evaluates the MOR error for every seed-point count (each unique seed solved
once) and, with matplotlib, saves the plot to output/.

Usage:
    python -m morfem_tpu_torch.examples.basis_size_study [--n 512]
        [--points 101] [--cpu] [--no-plots]
"""

import argparse
import os
import time

import numpy as np
import torch

from morfem_tpu_torch import MorfemConfig
from morfem_tpu_torch.apps.studies import basis_size_study
from morfem_tpu_torch.apps.waveguide import load_waveguide_data, waveguide_system
from morfem_tpu_torch.ops.solve import solve_sweep


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--points", type=int, default=101)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--min-size", type=int, default=3)
    p.add_argument("--max-size", type=int, default=29)
    args = p.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    data = load_waveguide_data(n_fallback=args.n)
    freq = np.linspace(3e9, 5e9, args.points)  # reference study: 101 points
    sys_ = waveguide_system(freq, data, device=dev)
    cfg = MorfemConfig()
    sizes = list(range(args.min_size, args.max_size + 1))
    x_full = solve_sweep(sys_, cfg)
    t0 = time.perf_counter()
    study = basis_size_study(sys_, sizes, cfg, x_full=x_full)
    print(f"all {len(sizes)} sizes evaluated: {time.perf_counter()-t0:.3f} s")
    for s, e in zip(study.sizes, study.rel_error):
        print(f"  seeds={s:3d}  rel_error={e:.3e}")

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs("output", exist_ok=True)
        fig, ax1 = plt.subplots(figsize=(8, 5))
        ax1.semilogy(study.sizes, np.maximum(study.rel_error, 1e-300),
                     marker="o")
        ax1.set_xlabel("number of reduction points")
        ax1.set_ylabel("relative solution error")
        ax1.grid()
        ax1.set_title("Error vs number of equally-distributed seed points")
        plt.savefig("output/basis_size_study.png", bbox_inches="tight")
        plt.close()
        print("plot saved to output/basis_size_study.png")
    print("Done")


if __name__ == "__main__":
    main()
