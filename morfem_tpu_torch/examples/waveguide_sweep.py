"""End-to-end waveguide example — the reference's main.py on the port.

Runs the full-order ("No MOR") GSM sweep and the MOR sweep on the bundled
2-port waveguide (N = 3,411 DOF by default; the synthetic stand-in when
the Ct/Tt blobs are absent), reports the per-frequency GSM error (mean and
max) and, with matplotlib, saves the S-parameter and error plots to
output/.

Usage:
    python -m morfem_tpu_torch.examples.waveguide_sweep [--n 3411]
        [--points 100] [--cpu] [--no-plots] [--spans PATH]

``--spans PATH`` runs both sweeps with a trace-mode `PhaseTimer` and
writes their spans (greedy iterations, snapshot solves, refinement steps,
panel chunks, host syncs; `PhaseTimer.export`) to PATH as chrome-trace
JSON.
"""

import argparse
import os
import time

import numpy as np
import torch

from morfem_tpu_torch import MorfemConfig, PhaseTimer
from morfem_tpu_torch.apps.waveguide import (
    full_order_gsm,
    load_waveguide_data,
    mor_gsm,
    waveguide_system,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=3411, help="FEM DOF count")
    p.add_argument("--points", type=int, default=100, help="frequency points")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--data-dir", default=None,
                   help="directory with Ct.npy/Tt.npy/WP.npy/kTE1.npy")
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="write the run's spans as chrome-trace JSON")
    args = p.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    data = load_waveguide_data(data_dir=args.data_dir, n_fallback=args.n)
    if data.synthetic:
        print(f"(Ct/Tt blobs unavailable — using synthetic stand-ins, "
              f"N={data.c_mat.shape[0]})")
    freq = np.linspace(3e9, 5e9, args.points)
    sys_ = waveguide_system(freq, data, device=dev)
    cfg = MorfemConfig(error_threshold=args.threshold)

    traced = args.spans is not None
    full_timer = PhaseTimer(trace=True, device=dev) if traced else None
    t0 = time.perf_counter()
    gsm_ref = full_order_gsm(sys_, cfg, full_timer).cpu().numpy()
    print(f"No MOR: {time.perf_counter() - t0:.3f} s")
    timer = full_timer or PhaseTimer(device=dev)
    t0 = time.perf_counter()
    gsm_mor, rm, greedy = mor_gsm(sys_, cfg, timer)
    gsm_mor = gsm_mor.cpu().numpy()
    print(f"MOR: {time.perf_counter() - t0:.3f} s")
    print(timer.report())
    if traced:
        timer.export(args.spans)
        print(f"{len(timer.spans)} spans written to {args.spans}")
    print(f"basis size Nr = {rm.q.shape[1]}")
    err = np.linalg.norm(gsm_mor - gsm_ref, axis=(1, 2))
    print("GSM error mean:", err.mean())
    print("GSM error max: ", err.max())

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs("output", exist_ok=True)
        plt.figure(figsize=(12, 6))
        for g, style, lab in ((gsm_ref, "-", ""), (gsm_mor, "--", ",red")):
            plt.plot(freq, 20 * np.log10(np.abs(g[:, 0, 0])), style,
                     label=rf"$S_{{11{lab}}}$")
            plt.plot(freq, 20 * np.log10(np.abs(g[:, 1, 0])), style,
                     label=rf"$S_{{21{lab}}}$")
        plt.xlabel("f [Hz]")
        plt.ylabel(r"$|S_{11}|, |S_{21}|$ [dB]")
        plt.legend()
        plt.grid()
        plt.savefig("output/result.png", bbox_inches="tight")
        plt.close()
        plt.figure(figsize=(12, 6))
        plt.semilogy(freq, np.maximum(err, 1e-300))
        plt.xlabel("f [Hz]")
        plt.ylabel(r"$\Delta S$")
        plt.grid()
        plt.savefig("output/error.png", bbox_inches="tight")
        plt.close()
        print("plots saved to output/")
    print("Done")


if __name__ == "__main__":
    main()
