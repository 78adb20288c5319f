"""What a call into the program answered, read back for the check once
the window has closed."""

from __future__ import annotations

import numpy as np


class Gsm:
    """A GSM [I, M, M] that the program returned (a tensor or an array)."""

    def __init__(self, gsm):
        self.gsm = gsm

    def values(self, idx, points):
        g = self.gsm
        g = g.detach().cpu().numpy() if hasattr(g, "detach") else g
        if g.shape[0] != points:
            raise ValueError(f"{g.shape[0]} answers for {points} points")
        return np.asarray(g)[idx]

