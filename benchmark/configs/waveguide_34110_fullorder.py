"""The full-order reference sweep of the upstream 10× tiled waveguide
(``main.py:28`` on ``fake_interpolate_bigger_sample.py``'s pencil),
N = 34,110, M = 2. The pencil, its input maker and its plain reference are
the tiled waveguide's (`waveguide_34110.py`): the deployment differs in
what is asked of it, a full-order solve at every point of the grid, not in
its data.
"""

from __future__ import annotations

from benchmark.configs.waveguide_34110 import (  # noqa: F401
    make_inputs, reference, tiled_gsm)
