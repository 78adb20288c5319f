"""Drives the MOR entry point with the equally-distributed basis:
`apps/waveguide.py::mor_gsm` on the tiled waveguide, prepared once as in
``ops/mor_sparse.py`` (SciPy-sparse pencil, RCM, the banded operator on
the card) and re-gridded per call by ``with_domain``; the configuration's
``use_equally_distributed`` makes the basis of the call's seed points,
then the projection, the reduced sweep and the GSM [I, M, M]. The entry
point returns no greedy result on this route.

Counters: the banded sweep's refinement passes over the seeds
(``refine_steps``, the sum of `solve_sweep_banded.chunk_iterations`) and
the seeds solved (``seeds``, the sum of `matfree_seed_basis.seeds`),
zeroed before the window. A program without them gives none.
"""

from __future__ import annotations

import torch

from benchmark.harness import answers
from benchmark.ops.mor_sparse import setup  # noqa: F401 (the same set-up)


def call(bench, state, req, timer):
    from morfem_tpu_torch.apps.waveguide import mor_gsm

    sys_ = state["sys"].with_domain(
        torch.as_tensor(req.freqs(), device=bench.device))
    gsm, _, _ = mor_gsm(sys_, bench.morfem_config(), timer)
    return answers.Gsm(gsm)


def reset_counters(bench):
    from morfem_tpu_torch.mor import equally
    from morfem_tpu_torch.ops import block_tridiag

    for mod, name in ((block_tridiag, "reset_banded_sweep_counters"),
                      (equally, "reset_matfree_seed_counters")):
        reset = getattr(mod, name, None)
        if reset is not None:
            reset()


def counters(bench):
    from morfem_tpu_torch.mor import equally
    from morfem_tpu_torch.ops import block_tridiag

    steps = getattr(getattr(block_tridiag, "solve_sweep_banded", None),
                    "chunk_iterations", None)
    seeds = getattr(getattr(equally, "matfree_seed_basis", None), "seeds",
                    None)
    out = {}
    if steps:  # the banded sweep ran
        out["refine_steps"] = float(sum(steps))
    if seeds:
        out["seeds"] = float(sum(seeds))
    return out
