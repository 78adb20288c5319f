"""Peaks of the card and the work of the algorithms the benchmark rates.

The work counts what the algorithm needs, whatever implements it
(six bf16 passes or one FP64 product count alike), so no implementation
reads over 100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        # the dense bf16 tensor rate: every f32-accurate product on this
        # chip runs at or below it
        "flops_per_s": 989e12,
        "bytes_per_s": 3.35e12,
    },
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def lu_sweep_work(n: int, m: int, points: int, word: int = 8):
    """(operations, bytes) of a full-order sweep of `points` dense N×N
    systems with M right-hand sides: an LU (⅔N³) and two triangular
    solves (2N²M) per point; the three operators read once and x written
    once, in `word`-byte numbers."""
    flops = points * (2.0 * n**3 / 3.0 + 2.0 * n * n * m)
    nbytes = word * (3.0 * n * n + points * n * m)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, card: str = DEFAULT_PEAK):
    """(seconds, bound): the least time the card could take, and which of
    ``"operations"`` or ``"bytes"`` sets it."""
    peak = PEAKS.get(card, PEAKS[DEFAULT_PEAK])
    t_ops = flops / peak["flops_per_s"]
    t_bytes = nbytes / peak["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
