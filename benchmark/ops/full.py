"""Drives the full-order entry point: `apps/waveguide.py::full_order_gsm`
(every point solved at full order, then the GSM) on
``waveguide_system(...).with_domain(grid)``.

Counters: the panel sweep's refinement steps (``refine_steps``, the sum
of `solve_sweep_panel.chunk_iterations`) and escalations, zeroed before
the window.
"""

from __future__ import annotations

import torch

from benchmark.harness import answers, program


def setup(bench):
    return {"sys": program.waveguide_system(bench)}


def call(bench, state, req, timer):
    from morfem_tpu_torch.apps.waveguide import full_order_gsm

    sys_ = state["sys"].with_domain(
        torch.as_tensor(req.freqs(), device=bench.device))
    return answers.Gsm(full_order_gsm(sys_, bench.morfem_config(), timer))


def reset_counters(bench):
    from morfem_tpu_torch.ops.panel_lu import reset_sweep_counters

    reset_sweep_counters()


def counters(bench):
    from morfem_tpu_torch.ops.panel_lu import solve_sweep_panel

    steps = solve_sweep_panel.chunk_iterations
    if not steps:  # the panel sweep did not run (no card)
        return {}
    return {"refine_steps": float(sum(steps)),
            "escalations": float(solve_sweep_panel.escalations)}
