"""Drives the full-order entry point on the large-N route:
`apps/waveguide.py::full_order_gsm` on the tiled waveguide, prepared once
as in ``ops/mor_sparse.py`` (SciPy-sparse pencil, RCM, the banded operator
on the card) and re-gridded per call by ``with_domain``: every point
solved at full order by the banded sweep, then the GSM [I, M, M].

Counters: the banded sweep's refinement passes (``refine_steps``, the sum
of `solve_sweep_banded.chunk_iterations`) and the points it escalated
(``escalations``), zeroed before the window. A program without the
banded sweep gives none.
"""

from __future__ import annotations

import torch

from benchmark.harness import answers
from benchmark.ops.mor_sparse import setup  # noqa: F401 (the same set-up)


def call(bench, state, req, timer):
    from morfem_tpu_torch.apps.waveguide import full_order_gsm

    sys_ = state["sys"].with_domain(
        torch.as_tensor(req.freqs(), device=bench.device))
    return answers.Gsm(full_order_gsm(sys_, bench.morfem_config(), timer))


def _sweep():
    from morfem_tpu_torch.ops import block_tridiag

    return getattr(block_tridiag, "solve_sweep_banded", None)


def reset_counters(bench):
    from morfem_tpu_torch.ops import block_tridiag

    reset = getattr(block_tridiag, "reset_banded_sweep_counters", None)
    if reset is not None:
        reset()


def counters(bench):
    sweep = _sweep()
    steps = getattr(sweep, "chunk_iterations", None)
    if not steps:  # no banded sweep ran
        return {}
    return {"refine_steps": float(sum(steps)),
            "escalations": float(sweep.escalations)}
