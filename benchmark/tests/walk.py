"""Small copies of the benchmark's cells for CPU walks: the dense
waveguide at N=256 (the bundled ``synthetic_wg_256.npz``)."""

import time

from benchmark.harness import cli, registry


def small_cell(name, bench=None, bench_dir=registry.BENCH_DIR):
    cell = registry.find_cell(name, bench, bench_dir)
    cell.config.update(n=256, fingerprint=None,
                       data="data/synthetic_cache/synthetic_wg_256.npz")
    return cell


def run(cell, seed=2**31 + 77, seconds=0.4, traced=False):
    """One run of `cell` on the CPU, the card check skipped."""
    return cli.execute(cell, seed, seconds, traced, "cpu",
                       time.perf_counter())
