"""The port's one refinement rule (`morfem_tpu_torch/ops/refine.py`) on the CPU.

`refine` stops at tol, on stagnation (a step that fails to cut ‖r‖ by the
factor ``stop``) or at the cap, reads the norm once a step, and records a
span a step only when it is given a name. Every host-refined solver that
runs on the CPU gives the same x, bit for bit, as the rule's loop written
out here around the solver's own factor.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.mor.reduced import solve_reduced_batch
from morfem_tpu_torch.ops.banded_matvec import (
    BandedAffineOperator,
    combine_addends,
)
from morfem_tpu_torch.ops.block_tridiag import (
    band_to_blocks,
    banded_direct_solve,
    block_tridiag_apply,
    block_tridiag_factor,
)
from morfem_tpu_torch.ops.blocked_inverse import gj_inverse_f32
from morfem_tpu_torch.ops.panel_lu import (
    panel_lu_apply,
    panel_lu_factor,
    solve_batch_panel,
)
from morfem_tpu_torch.ops.refine import host_norm, refine
from morfem_tpu_torch.ops.solve import gj_solve_refined, lu_solve_refined
from morfem_tpu_torch.utils.timing import HOST_SYNC, PhaseTimer

EPS = torch.finfo(torch.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(n=8, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.linspace(1.0, 10.0, n)) @ q.T
    b = rng.standard_normal((n, 2))
    return torch.from_numpy(a), torch.from_numpy(b)


def _contracting(a, deltas):
    """An apply that leaves δ_k·r of the k-th residual: (1 − δ_k)·A⁻¹r,
    δ_k from `deltas`, the last repeated."""
    calls = []

    def apply(r):
        d = deltas[min(len(calls), len(deltas) - 1)]
        calls.append(d)
        return (1.0 - d) * torch.linalg.solve(a, r)

    return apply


# (deltas, stop, tol as a share of ‖r0‖, cap) → (steps, ‖r‖ / ‖r0‖)
RULES = {
    "tol": ([0.1], 0.95, 5e-3, 10, 3, 1e-3),
    "stagnation_0.95": ([0.5, 0.96, 0.98], 0.95, 0.0, 10, 2, 0.48),
    "stagnation_0.97": ([0.5, 0.96, 0.98], 0.97, 0.0, 10, 3, 0.4704),
    "cap": ([0.5], 0.95, 0.0, 4, 4, 0.0625),
}


@pytest.mark.parametrize("case", [*RULES, "nan"])
def test_refine_stops_by_its_rule(case):
    a, b = _spd()
    x0 = torch.zeros_like(b)
    reads = []

    def norm(r):
        reads.append(1)
        return float(torch.linalg.norm(r))

    if case == "nan":
        x0 = torch.full_like(b, float("nan"))
        x, r, r_norm, steps = refine(
            x0, lambda x: b - a @ x, _contracting(a, [0.5]), 0.0, 10,
            norm=norm)
        assert steps == 0 and math.isnan(r_norm) and x is x0
        assert len(reads) == 1
        return
    deltas, stop, tol_share, cap, want_steps, want_share = RULES[case]
    r0 = float(torch.linalg.norm(b))
    x, r, r_norm, steps = refine(
        x0, lambda x: b - a @ x, _contracting(a, deltas), tol_share * r0,
        cap, norm=norm, stop=stop)
    assert steps == want_steps
    assert r_norm == pytest.approx(want_share * r0, rel=1e-9)
    assert r_norm == float(torch.linalg.norm(r))
    assert torch.equal(r, b - a @ x)
    assert len(reads) == steps + 1  # one read a step, and the first


@pytest.mark.parametrize("span_name", ["refine.step", "banded.refine", None])
def test_refine_records_one_span_a_step_holding_its_host_sync(span_name):
    a, b = _spd(seed=1)
    timer = PhaseTimer(trace=True)
    with timer.phase("solve"):
        _, _, _, steps = refine(
            torch.zeros_like(b), lambda x: b - a @ x, _contracting(a, [0.5]),
            0.0, 3, norm=host_norm, span_name=span_name)
    assert steps == 3
    syncs = [s for s in timer.spans if s.name == HOST_SYNC]
    assert len(syncs) == steps + 1
    if span_name is None:
        assert {s.name for s in timer.spans} == {"solve", HOST_SYNC}
        return
    numbers = [i for i, s in enumerate(timer.spans) if s.name == span_name]
    assert len(numbers) == steps
    assert sorted(s.parent for s in syncs[1:]) == numbers
    assert timer.spans[syncs[0].parent].name == "solve"
    assert all(timer.spans[i].parent == syncs[0].parent for i in numbers)


def _written_out(x, residual, apply, tol, cap, stop=0.95):
    """The reference's `lax.while_loop` rule, written out as a host loop
    with its count: the oracle of every caller below."""
    r = residual(x)
    r_norm, r_prev, it = float(torch.linalg.norm(r)), float("inf"), 0
    while r_norm > tol and r_norm < stop * r_prev and it < cap:
        x = x + apply(r)
        r = residual(x)
        r_prev, r_norm = r_norm, float(torch.linalg.norm(r))
        it += 1
    return x, r, it


def _ill(n=40, cond=1e5, m=2, seed=0, batch=()):
    """Systems whose f32 factor contracts the residual by ~cond·2⁻²⁴ a
    step: several steps to working precision."""
    rng = np.random.default_rng(seed)
    a, b = [], []
    for _ in range(int(np.prod(batch, dtype=int))):
        u, _ = np.linalg.qr(rng.standard_normal((n, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a.append((u * np.geomspace(1.0, 1.0 / cond, n)) @ v.T)
        b.append(rng.standard_normal((n, m)))
    a = torch.from_numpy(np.stack(a)).reshape(*batch, n, n)
    b = torch.from_numpy(np.stack(b)).reshape(*batch, n, m)
    return a, b


def _tol(b):
    return 10 * EPS * float(torch.linalg.norm(b))


def _lu(cap):
    a, b = _ill(batch=(1,))
    a, b = a[0], b[0]
    got = lu_solve_refined(a, b, refine_iterations=cap)
    lu, piv = torch.linalg.lu_factor(a.float())

    def apply(r):
        return torch.linalg.lu_solve(lu, piv, r.float()).double()

    want = _written_out(apply(b), lambda x: b - a @ x, apply, _tol(b), cap)
    return got, want


def _gj(cap):
    a, b = _ill(batch=(1,), seed=1)
    a, b = a[0], b[0]
    got = gj_solve_refined(a, b, refine_iterations=cap)
    ainv = gj_inverse_f32(a, panel=256, sub=8)

    def apply(r):
        return (ainv @ r.float()).double()

    want = _written_out(apply(b), lambda x: b - a @ x, apply, _tol(b), cap)
    return got, want


def _reduced(cap):
    a, b = _ill(n=12, cond=1e4, batch=(5,), seed=2)
    got = solve_reduced_batch(a, b, MorfemConfig(refine_iterations=cap))
    lu, piv = torch.linalg.lu_factor(a.float())

    def apply(r):
        return torch.linalg.lu_solve(lu, piv, r.float()).double()

    want = _written_out(apply(b), lambda x: b - a @ x, apply, _tol(b), cap)
    return got, want


def _panel(cap):
    a, b = _ill(n=256, cond=1e4, m=1, batch=(2,), seed=3)
    cfg = MorfemConfig(factorization="panel", panel_width=128,
                       refine_iterations=cap)
    got = solve_batch_panel(a, b, cfg)
    f = panel_lu_factor(a, panel=128)

    def apply(r):
        return panel_lu_apply(f, r).double()

    want = _written_out(apply(b), lambda x: b - a @ x, apply, _tol(b), cap)
    return got, want


def _banded_pencil(n=300, half=6, seed=4, shift=1.0):
    rng = np.random.default_rng(seed)

    def band(scale, s):
        diags = [rng.normal(size=n - abs(d)) * scale / (1 + abs(d))
                 for d in range(-half, half + 1)]
        a = sp.diags(diags, offsets=range(-half, half + 1)).tocsr()
        return (a + a.T) * 0.5 + sp.eye(n) * s

    return band(1.0, shift), sp.csr_matrix((n, n)), band(0.3, 0.0)


def _banded(cap):
    op = BandedAffineOperator(*_banded_pencil(), device="cpu")
    c = torch.tensor([1.0, 0.0, -1.1], dtype=torch.float64)
    rhs = torch.from_numpy(np.random.default_rng(2).standard_normal((300, 2)))
    got, relres, it = banded_direct_solve(op, c, rhs, refine_iterations=cap)
    factors = block_tridiag_factor(
        *band_to_blocks(combine_addends(c, op.bands_w), op.half, 128), op.n)
    mv = op.bind_precise(c)

    def apply(r):
        return block_tridiag_apply(factors, r).to(rhs.dtype)

    want = _written_out(apply(rhs), lambda x: rhs - mv(x), apply, _tol(rhs),
                        cap, stop=0.97)
    assert it == want[2]
    assert torch.equal(relres, torch.linalg.norm(want[1], dim=0)
                       / torch.linalg.norm(rhs, dim=0))
    return got, want


CALLERS = {"lu_solve_refined": _lu, "gj_solve_refined": _gj,
           "solve_reduced_batch": _reduced, "solve_batch_panel": _panel,
           "banded_direct_solve": _banded}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_callers_equal_the_written_out_loop(caller):
    got, (x, _, steps) = CALLERS[caller](8)
    assert steps >= 2  # the loop runs: the comparison covers the steps
    assert torch.equal(got, x)
