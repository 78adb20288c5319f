"""How far equivalent computations of one basis-size study row spread.

    python3 tools/study_projection_spread.py [--cpu] [--n N] [--sizes 6 12 20]

Runs `basis_size_study` (3..29 seeds) on the bundled waveguide (N=3411,
M=2, I=100 over 3-5 GHz; `--n` for another size of the synthetic
fallback), then, for each size given, rebuilds that row's reconstruction
in several ways that are equal in exact arithmetic:

- ``study``: the study's own reduced solutions;
- ``batched``: the study's padded basis, all sizes projected at once by
  3-D products (``Q^T (A Q)`` broadcast over the sizes), batched LU;
- ``padded``: the same basis projected by `project`, batched LU;
- ``unpadded``: its active columns projected by `project`, batched LU;
- ``recompute``: `equally_distributed_basis` -> `project` -> `sweep`;
- each of the last three also with exact f64 reduced solves
  (``torch.linalg.solve``), suffixed ``_exact``.

Prints, per size, the worst condition number of the reduced systems, the
subspace gap between the recompute's basis and the study's, each way's
rel_error, and every pairwise reconstruction difference in units of
‖x_full‖. Runs on the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from morfem_tpu_torch import (  # noqa: E402
    MorfemConfig, equally_distributed_basis, project, solve_sweep, sweep,
)
from morfem_tpu_torch.apps.studies import basis_size_study  # noqa: E402
from morfem_tpu_torch.apps.waveguide import (  # noqa: E402
    load_waveguide_data, waveguide_system,
)
from morfem_tpu_torch.mor.reduced import (  # noqa: E402
    ReducedModel, assemble_reduced, solve_reduced_batch,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=3411)
    ap.add_argument("--sizes", type=int, nargs="+", default=[6, 12, 20])
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    sys_ = waveguide_system(np.linspace(3e9, 5e9, 100),
                            load_waveguide_data(n_fallback=args.n),
                            device=dev)
    cfg = MorfemConfig(error_threshold=1e-10)
    x_full = solve_sweep(sys_, cfg)
    denom = torch.linalg.norm(x_full)
    study = basis_size_study(sys_, range(3, 30), cfg, x_full=x_full)
    qt = study.q.transpose(-1, -2)
    batched = [qt @ (op @ study.q) for op in sys_.operators()]
    batched_b = qt @ sys_.b

    def reconstruct(q, x):
        return torch.einsum("nk,ikm->inm", q, x)

    def lu_and_exact(rm):
        a, rhs = assemble_reduced(rm, sys_.domain, cfg)
        return (reconstruct(rm.q, solve_reduced_batch(a, rhs, cfg)),
                reconstruct(rm.q, torch.linalg.solve(a, rhs)),
                float(torch.linalg.cond(a).max()))

    for s in args.sizes:
        si = int(np.flatnonzero(study.sizes == s)[0])
        nc = int(study.ncols[si])
        q_pad = study.q[si]
        q_s = q_pad[:, :nc]
        q_r = equally_distributed_basis(sys_, cfg, count=s)
        rm_batched = ReducedModel(
            domain=sys_.domain, q=q_pad, r0=batched[0][si],
            r1=batched[1][si], r2=batched[2][si], b_r=batched_b[si],
            ncols=nc, t_a0=sys_.t_a0, t_a1=sys_.t_a1, t_a2=sys_.t_a2,
            t_b=sys_.t_b)
        ways = {"study": reconstruct(q_pad, study.x[si]),
                "batched": lu_and_exact(rm_batched)[0]}
        for name, rm in (("padded", project(sys_, q_pad, ncols=nc)),
                         ("unpadded", project(sys_, q_s)),
                         ("recompute", project(sys_, q_r))):
            ways[name], ways[name + "_exact"], cond = lu_and_exact(rm)
        ways["recompute"] = reconstruct(q_r, sweep(project(sys_, q_r), cfg))
        names = list(ways)
        print(json.dumps({
            "seeds": s, "ncols": nc, "max_cond_reduced": cond,
            "subspace_gap": float(torch.linalg.norm(q_r - q_s @ (q_s.T @ q_r))),
            "rel_error": {k: float(torch.linalg.norm(v - x_full) / denom)
                          for k, v in ways.items()},
            "difference": {
                f"{a}-{b}": float(torch.linalg.norm(ways[a] - ways[b])
                                  / denom)
                for i, a in enumerate(names) for b in names[i + 1:]},
        }), flush=True)


if __name__ == "__main__":
    main()
