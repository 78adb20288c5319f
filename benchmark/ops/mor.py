"""Drives the MOR entry point: `apps/waveguide.py::mor_gsm` on
``waveguide_system(...).with_domain(grid)``, a reduced model built and
swept per call → the GSM [I, M, M].

In a traced run the program's `PhaseTimer` records its phases
("projection base", "reduced sweep", "gsm", ...).
"""

from __future__ import annotations

import torch

from benchmark.harness import answers, program


def setup(bench):
    return {"sys": program.waveguide_system(bench)}


def call(bench, state, req, timer):
    from morfem_tpu_torch.apps.waveguide import mor_gsm

    sys_ = state["sys"].with_domain(
        torch.as_tensor(req.freqs(), device=bench.device))
    gsm, _, _ = mor_gsm(sys_, bench.morfem_config(), timer)
    return answers.Gsm(gsm)
