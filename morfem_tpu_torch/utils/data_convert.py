"""Data conversion tooling — CSV matrices → .npy.

Counterpart of `morfem_tpu/utils/data_convert.py` (NumPy only): reads
headerless CSV matrices and writes .npy files with the same basenames, so a
reference ``data_csv/`` directory converts into the ``data/`` layout the
loaders expect.

Usage:
    python -m morfem_tpu_torch.utils.data_convert data_csv/ data/
    # or programmatically: convert_csv_dir("data_csv", "data")
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Optional

import numpy as np

# the reference's file set; kTe2 casing kept
DEFAULT_NAMES = ("Ct", "Tt", "WP", "kTE1", "kTe2")


def convert_csv_file(src: str, dst: str) -> np.ndarray:
    """Read one headerless CSV matrix and save as .npy."""
    arr = np.loadtxt(src, delimiter=",", ndmin=2)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    np.save(dst, arr)
    return arr


def convert_csv_dir(
    src_dir: str,
    dst_dir: str,
    names: Optional[Iterable[str]] = None,
) -> dict:
    """Convert every (existing) named CSV in src_dir to .npy in dst_dir."""
    results = {}
    for name in names or DEFAULT_NAMES:
        src = os.path.join(src_dir, f"{name}.csv")
        if not os.path.exists(src):
            continue
        dst = os.path.join(dst_dir, f"{name}.npy")
        results[name] = convert_csv_file(src, dst).shape
    return results


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(
            "usage: python -m morfem_tpu_torch.utils.data_convert "
            "<csv_dir> <npy_dir>",
            file=sys.stderr,
        )
        return 2
    results = convert_csv_dir(argv[0], argv[1])
    for name, shape in results.items():
        print(f"{name}.csv -> {name}.npy  {shape}")
    if not results:
        print("no known CSV files found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
