"""Hands a configuration's inputs to the program's public entries."""

from __future__ import annotations

import numpy as np


def waveguide_system(bench):
    """The port's AffineSystem of a ``dense_waveguide`` configuration on
    its grid."""
    from morfem_tpu_torch.apps.waveguide import (
        WaveguideData,
        waveguide_system as make,
    )

    cfg, inp = bench.config, bench.inputs
    if cfg["system"] != "dense_waveguide":
        raise ValueError(f"not a dense waveguide: {cfg['system']!r}")
    grid = np.linspace(cfg["lo_hz"], cfg["hi_hz"], int(cfg["points"]))
    data = WaveguideData(inp["c"], inp["t"], inp["wp"], inp["kte"], True)
    return make(grid, data, device=bench.device)
