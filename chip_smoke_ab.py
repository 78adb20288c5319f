"""Run chip_smoke.py's krylov and parallel phases in several checkouts, one
after another, on one card, so that their times compare within one machine.

    python3 chip_smoke_ab.py [--skip-entry] DIR [DIR ...]

Each DIR is the root of a checkout (e.g. the parent commit unpacked with
`git archive`, then this tree, this tree, the parent). For each, in the
order given, a fresh process imports that checkout's `chip_smoke.py` and
`morfem_tpu_torch`, builds the kernels and runs its device-side phases:
`slice` (which the others need), then `entry` where the checkout has it
and `--skip-entry` is not given (as `chip_smoke.py` runs it before the
later phases), then `krylov` and `parallel`, each with its usual checks.
The phases' lines go to stdout, each run opened by a line naming its
index and DIR. Exits non-zero if any run failed. Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_one(root: str, skip_entry: bool) -> None:
    """The phases of the checkout at `root`, in this process."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from morfem_tpu_torch.bench import nvidia_smi_line
    from morfem_tpu_torch.ops.kernels import _lib

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"  {smi}", flush=True)
    with cs.phase("build"):
        _lib.load()
    with cs.phase("slice"):
        _, sys_, rm, gsm_full, x_full, _ = cs.slice_phase(dev)
    if hasattr(cs, "entry_phase") and not skip_entry:
        with cs.phase("entry"):
            cs.entry_phase(dev, sys_, gsm_full, smi)
    with cs.phase("krylov"):
        cs.krylov_phase(dev)
    with cs.phase("parallel"):
        cs.parallel_phase(dev, sys_, rm, x_full, smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-entry", action="store_true",
                    help="leave out the entry phase")
    ap.add_argument("--run-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="+")
    opts = ap.parse_args(argv)
    if opts.run_one:
        run_one(os.path.abspath(opts.dirs[0]), opts.skip_entry)
        return 0
    failed = []
    for i, d in enumerate(opts.dirs):
        root = os.path.abspath(d)
        print(f"=== run {i}: {root}", flush=True)
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run-one", root]
            + (["--skip-entry"] if opts.skip_entry else []),
            cwd=root).returncode
        print(f"=== run {i} rc={rc}", flush=True)
        if rc:
            failed.append(i)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
