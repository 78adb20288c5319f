"""Drives the MOR entry point on the matrix-free route:
`apps/waveguide.py::mor_gsm` on the tiled waveguide, prepared once by
`tiled_waveguide_system` (SciPy-sparse pencil, RCM, the banded operator
on the card) and re-gridded per call by ``with_domain``, a reduced model
built and swept per call → the GSM [I, M, M].

A call whose greedy stops short of its error threshold is logged with
the reason it stopped; its answer is still checked like any other.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import answers


def setup(bench):
    from morfem_tpu_torch.apps.waveguide import (
        WaveguideData,
        tiled_waveguide_system,
    )

    cfg, inp = bench.config, bench.inputs
    if cfg["system"] != "tiled_waveguide":
        raise ValueError(f"not a tiled waveguide: {cfg['system']!r}")
    grid = np.linspace(cfg["lo_hz"], cfg["hi_hz"], int(cfg["points"]))
    data = WaveguideData(inp["c"], inp["t"], inp["wp"], inp["kte"], True)
    return {"sys": tiled_waveguide_system(grid, data, inp["rate"],
                                          bench.morfem_config(),
                                          device=bench.device)}


def call(bench, state, req, timer):
    from morfem_tpu_torch.apps.waveguide import mor_gsm

    sys_ = state["sys"].with_domain(
        torch.as_tensor(req.freqs(), device=bench.device))
    gsm, _, res = mor_gsm(sys_, bench.morfem_config(), timer)
    if not res.converged:
        why = ("a failed snapshot" if res.failed_snapshot else
               "the dependency guard or the column budget")
        bench.log(f"request {req.index}: the greedy stopped on {why} "
                  f"after {res.iterations} estimates, {res.ncols} columns")
    return answers.Gsm(gsm)
