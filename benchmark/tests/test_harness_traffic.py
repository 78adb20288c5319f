"""The request generator is deterministic in the seed, stays inside each
mix's ranges, and gives every seed the same spread of work."""

import itertools
import json

import numpy as np
import pytest

from benchmark.harness import registry, traffic

MIXES = sorted(p.stem for p in (registry.BENCH_DIR / "traffic").glob(
    "*.json"))
SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


def mix(name):
    return json.loads((registry.BENCH_DIR / "traffic" /
                       f"{name}.json").read_text())


def take(name, seed, n=200):
    return list(itertools.islice(traffic.requests(mix(name), seed), n))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(name, seed):
    assert take(name, seed) == take(name, seed)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_requests(name):
    assert take(name, 1) != take(name, 2)


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_requests_stay_inside_the_mix(name, seed):
    m = mix(name)
    lo, hi = m["lo_hz"], m["hi_hz"]
    step = (hi - lo) / (m["points"] - 1)
    for r in take(name, seed, 500):
        assert r.points == m["points"]
        assert abs(r.lo_hz - lo) <= m["shift_steps"] * step
        assert r.hi_hz - r.lo_hz == pytest.approx(hi - lo)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_spread_of_work(name):
    """Every cycle of shifts is the same set, so the first n requests of
    two seeds carry nearly the same work."""
    def work(seed, n):
        reqs = take(name, seed, n)
        return np.array([[r.points, r.hi_hz - r.lo_hz, r.lo_hz]
                         for r in reqs]).mean(axis=0)

    for n, rel in ((200, 0.05), (1000, 0.02)):
        np.testing.assert_allclose(work(3, n), work(2**33 + 1, n), rtol=rel)


@pytest.mark.parametrize("name", MIXES)
def test_warmup_is_the_same_for_every_seed(name):
    reqs = traffic.warmup_requests(mix(name))
    assert reqs and reqs == traffic.warmup_requests(mix(name))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_shifts_in_another_order(name):
    n = mix(name)["offsets"]
    cycles = [[r.lo_hz for r in take(name, seed, 3 * n)] for seed in SEEDS]
    for c in cycles:
        for k in range(3):
            assert sorted(c[k * n:(k + 1) * n]) == sorted(cycles[0][:n])
    assert cycles[0][:n] != cycles[1][:n]
