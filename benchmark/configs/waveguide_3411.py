"""The 2-port waveguide (upstream morfem ``main.py``), N = 3,411, M = 2:
the frozen input maker and the plain reference.

The operators are the bundled stand-in ``synthetic_wg_3411.npz`` (raw C,
T and port columns WP; the upstream blobs are not in the repository),
checked against the fingerprint in ``waveguide_3411.json`` so that a
changed file cannot move the yardstick. The program is handed the raw
arrays and kTE; the reference scales them itself (``harness/reference``).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import reference as ref


def fingerprint(c, t, wp):
    """Sums and sums of squares of the three arrays."""
    arrays = (c, t, wp)
    return ([float(np.sum(a)) for a in arrays]
            + [float(np.vdot(a.ravel(), a.ravel())) for a in arrays])


def make_inputs(config, root):
    """{"c", "t", "wp", "kte"}: the raw waveguide data on the host."""
    with np.load(root / config["data"]) as z:
        c, t, wp = (np.asarray(z[k], np.float64) for k in ("c", "t", "wp"))
    n, m = int(config["n"]), int(config["m"])
    if c.shape != (n, n) or t.shape != (n, n) or wp.shape != (n, m):
        raise ValueError(f"{config['data']}: shapes {c.shape}, {t.shape}, "
                         f"{wp.shape} are not N={n}, M={m}")
    want = config.get("fingerprint")
    if want is not None and not np.allclose(fingerprint(c, t, wp), want,
                                            rtol=1e-9, atol=0):
        raise ValueError(f"{config['data']} is not the file this "
                         "configuration was measured on (fingerprint)")
    return {"c": c, "t": t, "wp": wp, "kte": float(config["kte"])}


def reference(config, freqs, dtype, device, inputs):
    """("gsm_err", the full-order GSM [P, M, M] at `freqs` in `dtype`)."""
    import torch

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    return "gsm_err", ref.waveguide_gsm(inputs["c"], inputs["t"],
                                        inputs["wp"], inputs["kte"], freqs,
                                        dt, device)
