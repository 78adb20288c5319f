"""Does the general-sparsity route stall in both packages, or only in the port?

    JAX_PLATFORMS=cpu python tools/general_route_stall.py [--p 128] [--bands 128,256]

Builds `banded_waveguide_system_2d(p, m=2, seed=1)` (C, 0, Γ scaled as in
`tools/bench_banded.py`), truncates it to each band half-width with
`truncated_band_via_rcm` in both packages, and calls `general_sparse_solve`
in both at the first grid point (3 GHz, where morfem()'s first seed solve
runs) for an increasing number of GMRES restarts (32 Arnoldi steps each).
Restarted GMRES is deterministic, so relres after k restarts is the
residual history at restart granularity. Prints one JSON line per
(band, package, restarts) with the dropped mass and the relative residual
per right-hand side, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from morfem_tpu.apps.waveguide import GAMMA_SCALE  # noqa: E402
from morfem_tpu.ops import block_tridiag as jbt  # noqa: E402
from morfem_tpu.utils.synthetic import banded_waveguide_system_2d  # noqa: E402
from morfem_tpu_torch.ops import block_tridiag as tbt  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--bands", default="128")
    ap.add_argument("--restarts", default="1,2,4,8,16")
    ap.add_argument("--freq", type=float, default=3e9)
    args = ap.parse_args()

    c_sp, t_sp, wp = banded_waveguide_system_2d(args.p, m=2, seed=1)
    mats = (c_sp, 0.0 * c_sp, (t_sp * GAMMA_SCALE).tocsr())
    f = args.freq
    coef = [1.0, f, f * f]
    for band in (int(b) for b in args.bands.split(",")):
        ex_j, bd_j, perm_j, dropped_j = jbt.truncated_band_via_rcm(
            *mats, band_half=band)
        ex_t, bd_t, perm_t, dropped_t = tbt.truncated_band_via_rcm(
            *mats, band_half=band, device="cpu")
        same_perm = bool(np.array_equal(np.asarray(perm_j),
                                        perm_t.numpy()))
        rhs = f * np.asarray(wp)[perm_t.numpy()]
        for k in (int(r) for r in args.restarts.split(",")):
            for pkg in ("jax", "torch"):
                t0 = time.perf_counter()
                if pkg == "jax":
                    _, rel = jbt.general_sparse_solve(
                        ex_j, bd_j, jnp.asarray(coef), jnp.asarray(rhs),
                        maxiter=k)
                    rel = np.asarray(rel)
                else:
                    _, rel = tbt.general_sparse_solve(
                        ex_t, bd_t, torch.tensor(coef, dtype=torch.float64),
                        torch.from_numpy(rhs), maxiter=k)
                    rel = rel.numpy()
                print(json.dumps({
                    "p": args.p, "n": args.p ** 2, "band_half": band,
                    "package": pkg, "restarts": k,
                    "relres": [float(x) for x in rel],
                    "dropped": float(dropped_j if pkg == "jax"
                                     else dropped_t),
                    "same_perm": same_perm,
                    "exact_op": type(ex_j if pkg == "jax" else ex_t).__name__,
                    "seconds": round(time.perf_counter() - t0, 3),
                }), flush=True)


if __name__ == "__main__":
    main()
