"""Serving demo: checkpointed reduced model → spectral sweeps on demand.

The offline phase (the greedy basis build on the full-order system) runs
once, and its product, the ReducedModel, is saved (`save_reduced_model`).
A serving process loads it, diagonalizes the two-term pencil once
(`prepare_spectral`) and answers frequency-sweep requests over any grid in
O(K·M) per point, independent of the full-order size N.

Usage:
    python -m morfem_tpu_torch.examples.serve [--n 3411] [--build] [--cpu]

--build (re)builds and saves the model; otherwise an existing checkpoint
is loaded. Then a few sweep requests of various grid sizes are served and
timed; each reports the S21 peak of the GSM (complex128).
"""

import argparse
import os
import time

import numpy as np
import torch

from morfem_tpu_torch import (
    MorfemConfig,
    build_reduced_model,
    load_reduced_model,
    prepare_spectral,
    save_reduced_model,
    spectral_sweep,
)
from morfem_tpu_torch.apps.waveguide import (
    b_coefficient,
    generalized_scattering_matrix,
    load_waveguide_data,
    waveguide_system,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=3411)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--build", action="store_true")
    p.add_argument("--checkpoint", default="output/waveguide_model.npz")
    args = p.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = MorfemConfig(
        solve_chunk=16, error_threshold=1e-8, orthonormalization="mgs"
    )

    if args.build or not os.path.exists(args.checkpoint):
        print("offline phase: building + checkpointing the reduced model…")
        data = load_waveguide_data(n_fallback=args.n)
        sys_ = waveguide_system(np.linspace(3e9, 5e9, 100), data, device=dev)
        t0 = time.perf_counter()
        rm, _ = build_reduced_model(sys_, cfg)
        rm = rm.trim()
        save_reduced_model(args.checkpoint, rm,
                           metadata={"n_dof": int(sys_.n)})
        print(f"  built Nr={rm.q.shape[1]} in {time.perf_counter()-t0:.1f} s "
              f"→ {args.checkpoint}")

    print(f"serving phase: loading {args.checkpoint}")
    rm = load_reduced_model(args.checkpoint, t_b=b_coefficient, device=dev)
    sm = prepare_spectral(rm, cfg)
    print(f"  model: N={rm.q.shape[0]}, Nr={rm.q.shape[1]}")

    def answer(lo, hi, points):
        t0 = time.perf_counter()
        grid = torch.linspace(lo, hi, points, dtype=torch.float64,
                              device=dev)
        x = spectral_sweep(sm, grid)
        gsm = generalized_scattering_matrix(
            grid, x, b_coefficient(grid)[:, None, None] * rm.b_r)
        s21_db = 20.0 * torch.log10(gsm[:, 1, 0].abs())
        peak = float(grid[torch.argmax(s21_db)])  # readback = sync
        return time.perf_counter() - t0, peak

    for pts in (256, 4096, 100000):  # warm-up, once per grid size
        answer(3e9, 5e9, pts)
    for lo, hi, pts in (
        (3e9, 5e9, 256),
        (3.2e9, 3.4e9, 4096),
        (3e9, 5e9, 100000),
        (4.0e9, 4.3e9, 256),
    ):
        dt, peak = answer(lo, hi, pts)
        print(f"  request {lo/1e9:.1f}–{hi/1e9:.1f} GHz × {pts:>6d} pts: "
              f"{dt*1e3:7.1f} ms ({pts/dt:,.0f} pts/s) "
              f"| S21 peak at {peak/1e9:.4f} GHz")
    print("Done")


if __name__ == "__main__":
    main()
