"""Large-N indefinite Helmholtz: banded DIRECT solves + matrix-free greedy.

Drives the banded large-N route end to end:

  * `banded_waveguide_system` — a 1-D FEM Helmholtz pencil whose in-band
    systems C − k²T are strongly INDEFINITE (where Jacobi-Krylov
    stagnates);
  * `BandedAffineOperator` — diagonal storage (kernel K5 for its f32
    matvecs);
  * `greedy_basis_matfree` — the greedy with block-tridiagonal direct
    snapshot solves (`ops/block_tridiag.py`), escalating to shifted GMRES
    at near-resonance points;
  * the reduced sweep and a dense-oracle check at a few points (when N
    permits).

Usage:
    python -m morfem_tpu_torch.examples.banded_direct_greedy [--n 8192]
        [--points 60] [--length-m 1.0] [--cpu] [--check-points 3]
"""

import argparse
import time

import numpy as np
import torch

from morfem_tpu_torch.apps.waveguide import GAMMA_SCALE
from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree
from morfem_tpu_torch.mor.reduced import sweep
from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
from morfem_tpu_torch.utils.synthetic import banded_waveguide_system


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--points", type=int, default=60)
    p.add_argument("--length-m", type=float, default=1.0,
                   help="domain length; in-band resonance count ≈ 13·L")
    p.add_argument("--half", type=int, default=6)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--check-points", type=int, default=3,
                   help="dense-oracle check points (0 disables; needs "
                        "n small enough to densify)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    print(f"building banded system: N={args.n}, half={args.half}, "
          f"L={args.length_m} m")
    c, t, wp = banded_waveguide_system(args.n, m=2, half=args.half, seed=5,
                                       length_m=args.length_m)
    gamma = (t * GAMMA_SCALE).tocsr()
    op = BandedAffineOperator(c, 0.0 * c, gamma, symmetrize=True,
                              device=dev)
    domain = torch.linspace(3e9, 5e9, args.points, dtype=torch.float64,
                            device=dev)
    # threshold is the reference's ABSOLUTE squared residual: 1e3 ≈ a
    # 4e-9 relative residual at ‖rhs‖ ≈ f·‖wp‖ ≈ 8e9
    config = MorfemConfig(error_threshold=1e3, max_greedy_iterations=40)

    t0 = time.perf_counter()
    result, rm = greedy_basis_matfree(op, torch.from_numpy(wp), domain,
                                      config=config)
    print(f"greedy: converged={bool(result.converged)} "
          f"iterations={int(result.iterations)} basis={int(result.ncols)} "
          f"build {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    x_r = sweep(rm)
    float(x_r.sum())  # waits for the device
    print(f"reduced sweep ({args.points} pts): "
          f"{time.perf_counter() - t0:.3f} s")

    if args.check_points and args.n <= 16384:
        cd, gd = c.toarray(), gamma.toarray()
        idx = np.linspace(0, args.points - 1, args.check_points, dtype=int)
        worst = 0.0
        for i in idx:
            f = float(domain[i])
            a_f = cd + gd * f * f
            a_f = (a_f + a_f.T) / 2
            ref = np.linalg.solve(a_f, wp * f)
            rec = (rm.q @ x_r[i]).cpu().numpy()
            err = np.linalg.norm(rec - ref) / np.linalg.norm(ref)
            worst = max(worst, err)
            print(f"  point {i}: rel err vs dense oracle {err:.3e}")
        print("PASS" if worst < 1e-7 else "FAIL (expected < 1e-7)")


if __name__ == "__main__":
    main()
