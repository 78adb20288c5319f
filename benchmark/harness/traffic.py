"""The one request generator: reads a traffic mix (``traffic/<mix>.json``)
and the run's seed, and yields the requests. Every seed gets the same
work in another order, so a window that completes n calls sees nearly
the same work whatever the seed.

A mix gives ``points`` equally spaced frequencies over [``lo_hz``,
``hi_hz``], the whole grid shifted per request within ±``shift_steps``
grid steps (the upstream sweep, re-run). The shifts are the ``offsets``
midpoints of that interval, each used once a cycle, every cycle in an
order drawn from the seed. Requests are served by a closed loop with one
caller.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    lo_hz: float
    hi_hz: float
    points: int

    def freqs(self) -> np.ndarray:
        return np.linspace(self.lo_hz, self.hi_hz, self.points)


def _request(mix: dict, index: int, u: float) -> Request:
    """The request whose grid is shifted by `u` ∈ [0, 1) of the mix's
    shift interval."""
    lo, hi = float(mix["lo_hz"]), float(mix["hi_hz"])
    n = int(mix["points"])
    step = (hi - lo) / (n - 1)
    off = (2.0 * u - 1.0) * float(mix["shift_steps"]) * step
    return Request(index, lo + off, hi + off, n)


def _lattice(seed: int, n: int) -> Iterator[float]:
    """The midpoints (k + ½)/n, k < n, each cycle in a seeded order."""
    cycle = 0
    while True:
        order = np.random.default_rng([int(seed), cycle]).permutation(n)
        yield from ((k + 0.5) / n for k in order)
        cycle += 1


def requests(mix: dict, seed: int) -> Iterator[Request]:
    """The mix's requests for `seed`, in order."""
    for i, u in enumerate(_lattice(seed, int(mix["offsets"]))):
        yield _request(mix, i, u)


def warmup_requests(mix: dict):
    """The set-up's requests, the same in every run: the unshifted
    grid."""
    return [_request(mix, -1, 0.5)]
