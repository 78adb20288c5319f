"""The port's panel LU (ops/panel_lu.py) against the JAX package and NumPy.

The port runs its kernels' plain versions here; the JAX panel LU runs its
Pallas kernels in interpret mode. Inputs are made with numpy from fixed
seeds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morfem_tpu import AffineSystem as JaxAffineSystem
from morfem_tpu.config import MorfemConfig as JaxConfig
from morfem_tpu.ops.panel_lu import solve_sweep_panel as jax_solve_sweep_panel
from morfem_tpu_torch.compat import system_from_numpy
from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.ops import panel_lu as panel_lu_mod
from morfem_tpu_torch.ops.panel_lu import (
    panel_lu_apply,
    panel_lu_factor,
    panel_lu_factor_block,
    reset_sweep_counters,
    solve_batch_panel,
    solve_sweep_panel,
)
from morfem_tpu_torch.utils.timing import HOST_SYNC, PhaseTimer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes on a shared CPU, and a full thread pool per process
    oversubscribes it (these are small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd_pencil(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a0 = (q * np.linspace(1.0, 50.0, n)) @ q.T
    a0 = (a0 + a0.T) / 2
    a2 = -np.eye(n) - 0.01 * np.diag(rng.uniform(size=n))
    b = rng.standard_normal((n, 2))
    return a0, np.zeros((n, n)), a2, b


@pytest.mark.parametrize("factor", [panel_lu_factor, panel_lu_factor_block])
@pytest.mark.parametrize("n", [100, 256, 300])
def test_factor_apply_f32_quality(factor, n):
    rng = np.random.default_rng(500 + n)
    a = rng.standard_normal((2, n, n)) + 0.5 * n**0.5 * np.eye(n)
    b = rng.standard_normal((2, n, 3))
    f = factor(torch.from_numpy(a), panel=128)
    x = panel_lu_apply(f, torch.from_numpy(b)).double().numpy()
    relres = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    # an f32 factor is cond·ε_f32-class by contract (callers refine in f64)
    cond = max(np.linalg.cond(a[i]) for i in range(2))
    assert relres < 100 * cond * np.finfo(np.float32).eps, (relres, cond)


def test_refined_batch_solve_matches_numpy():
    rng = np.random.default_rng(11)
    n = 200
    a = rng.standard_normal((2, n, n))
    a[0, 0, 0] = 0.0  # forces a pivot exchange at the first column
    b = rng.standard_normal((2, n, 2))
    x = solve_batch_panel(
        torch.from_numpy(a), torch.from_numpy(b),
        MorfemConfig(refine_iterations=8, panel_width=128),
    ).numpy()
    x_np = np.linalg.solve(a, b)
    # f64 refinement to working precision; cond of a gaussian 200×200 draw
    # is ~1e3, so the solution agrees to ~1e-13
    assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-11


@pytest.mark.parametrize("pivot", ["block", "full"])
def test_sweep_matches_jax_and_numpy(pivot):
    n, pts = 200, 5
    a0, a1, a2, b = _spd_pencil(n, 21)
    domain = np.linspace(1.5, 6.5, pts)
    kw = dict(factorization="panel", panel_width=128, solve_chunk=2,
              panel_pivot=pivot)
    x = solve_sweep_panel(
        system_from_numpy(domain, a0, a1, a2, b, device="cpu"),
        MorfemConfig(**kw),
    ).numpy()
    jsys = JaxAffineSystem.create(
        jnp.asarray(domain), a0, a1, a2, b
    )
    x_jax = np.asarray(jax_solve_sweep_panel(jsys, JaxConfig(**kw)))
    x_np = np.stack([
        np.linalg.solve(a0 + t * a1 + t * t * a2, t * b) for t in domain
    ])
    # both refine in f64 until the residual stops improving; the pencil's
    # cond stays below ~1e3 on this grid, so solutions agree to ~1e-13
    scale = np.linalg.norm(x_np)
    assert np.linalg.norm(x - x_np) / scale < 1e-11
    assert np.linalg.norm(x - x_jax) / scale < 1e-11


def test_block_factor_escalates_on_singular_diagonal_block():
    # the leading 128×128 block is singular: block pivoting cannot factor
    # it soundly, so the chunk must escalate to the full-pivot factor
    n = 256
    rng = np.random.default_rng(5)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    a0[:128, :128] = 0.0
    domain = np.array([1.0, 2.0])
    z = np.zeros((n, n))
    b = rng.standard_normal((n, 1))
    sys_ = system_from_numpy(domain, a0, z, z, b, device="cpu")
    x = solve_sweep_panel(
        sys_, MorfemConfig(factorization="panel", panel_width=128)
    ).numpy()
    x_np = np.stack([np.linalg.solve(a0, t * b) for t in domain])
    assert np.all(np.isfinite(x))
    assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-10


@pytest.mark.parametrize("factor,want_ct", [(panel_lu_factor, True),
                                            (panel_lu_factor_block, False)])
def test_only_the_full_pivot_factor_asks_for_the_coefficients(
        monkeypatch, factor, want_ct):
    # the block-pivot factor discards C̃, so K1 skips it there
    seen = []
    real = panel_lu_mod.panel_factor

    def spy(panel_t, avail, want_ct=True):
        seen.append(want_ct)
        return real(panel_t, avail, want_ct)

    monkeypatch.setattr(panel_lu_mod, "panel_factor", spy)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, 256, 256)) + 8 * np.eye(256)
    factor(torch.from_numpy(a), panel=128)
    assert seen == [want_ct] * 2


def _written_out_chunk_steps(sys_, cfg):
    """Each chunk's refinement steps, the sweep's loop written out: the
    block-pivot factor refined, and above max(10·ε·‖b‖, 1e-9·‖b‖) the
    full-pivot factor refined too (the reference's rule, with its
    count)."""
    ts_all = torch.cat([sys_.domain, sys_.domain[-1:]])  # padded to 2·2
    ops_w = torch.stack(sys_.operators())
    counts = []
    for ts in ts_all.split(cfg.solve_chunk):
        c, cb = sys_.coefficients(ts)
        a = torch.einsum("gp,pij->gij", c.float(), ops_w.float())
        b_w = cb[:, None, None] * sys_.b
        b_norm = float(torch.linalg.norm(b_w))
        tol = 10 * torch.finfo(torch.float64).eps * b_norm

        def residual(x):
            g, n, m = x.shape
            ys = (ops_w @ x.transpose(0, 1).reshape(n, g * m)).reshape(
                3, n, g, m)
            return b_w - (c.T[:, None, :, None] * ys).sum(0).transpose(0, 1)

        steps = 0
        for factor in (panel_lu_factor_block, panel_lu_factor):
            f = factor(a, trail="f32x6", panel=cfg.panel_width)
            x = panel_lu_apply(f, b_w).double()
            r = residual(x)
            r_norm, r_prev, it = float(torch.linalg.norm(r)), math.inf, 0
            while (r_norm > tol and r_norm < 0.95 * r_prev
                   and it < cfg.refine_iterations):
                x = x + panel_lu_apply(f, r).double()
                r = residual(x)
                r_prev, r_norm = r_norm, float(torch.linalg.norm(r))
                it += 1
            steps += it
            if r_norm <= max(tol, 1e-9 * b_norm):
                break
        counts.append(steps)
    return counts


@pytest.mark.parametrize("singular", [False, True])
def test_sweep_counts_escalations_and_refinement_iterations(singular):
    n = 256
    rng = np.random.default_rng(5)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    if singular:
        a0[:128, :128] = 0.0  # block pivoting must escalate
    domain = np.array([1.0, 2.0, 3.0])
    z = np.zeros((n, n))
    b = rng.standard_normal((n, 1))
    sys_ = system_from_numpy(domain, a0, z, z, b, device="cpu")
    cfg = MorfemConfig(factorization="panel", panel_width=128, solve_chunk=2)
    reset_sweep_counters()
    solve_sweep_panel(sys_, cfg)
    assert solve_sweep_panel.escalations == (2 if singular else 0)
    its = solve_sweep_panel.chunk_iterations
    assert len(its) == 2 and all(i >= 1 for i in its)
    assert its == _written_out_chunk_steps(sys_, cfg)
    # the CPU takes the eager step: nothing is captured or replayed
    assert solve_sweep_panel.captures == solve_sweep_panel.replays == 0
    reset_sweep_counters()
    assert solve_sweep_panel.escalations == 0
    assert solve_sweep_panel.chunk_iterations == []


class _StandInGraph:
    """A CUDA graph's contract on the CPU: `replay` reruns the captured
    function and writes its result into the outputs the capture returned
    (the static outputs)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def stand_in_capture(dev, fn, *args):
    out = fn(*args)
    return _StandInGraph(lambda: fn(*args), out), out


def use_stand_in_graphs(monkeypatch):
    """Route the CPU sweep through the captured step, with stand-in
    graphs: the step's static inputs, copies and outputs as on the
    card."""
    monkeypatch.setattr(panel_lu_mod, "_captures_on", lambda dev: True)
    monkeypatch.setattr(panel_lu_mod, "capture_graph", stand_in_capture)


def _sweep_pencil(singular, n=256, pts=5):
    rng = np.random.default_rng(5)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    a2 = -0.01 * np.eye(n)
    if singular:
        a0[:128, :128] = 0.0  # block pivoting must escalate
        a2[:128, :128] = 0.0
    b = rng.standard_normal((n, 2))
    return system_from_numpy(np.linspace(1.0, 3.0, pts), a0,
                             np.zeros((n, n)), a2, b, device="cpu")


@pytest.mark.parametrize("singular", [False, True])
def test_the_captured_step_gives_the_eager_bits(monkeypatch, singular):
    """Five points in chunks of 2 (a padded last chunk): the step
    captured once and replayed for every chunk's factor gives the eager
    x bit for bit, with the same steps. At N=256 in panels of 128 the
    escalation's full-pivot factor has the block factor's shapes, so it
    is copied in and replays too. `reset_sweep_counters` zeroes the graph
    counters."""
    sys_ = _sweep_pencil(singular)
    cfg = MorfemConfig(factorization="panel", panel_width=128, solve_chunk=2)
    reset_sweep_counters()
    eager = solve_sweep_panel(sys_, cfg)
    eager_its = solve_sweep_panel.chunk_iterations
    use_stand_in_graphs(monkeypatch)
    reset_sweep_counters()
    graphed = solve_sweep_panel(sys_, cfg)
    its = solve_sweep_panel.chunk_iterations
    assert torch.equal(graphed, eager)
    assert its == eager_its and len(its) == 3
    assert solve_sweep_panel.escalations == (3 if singular else 0)
    assert solve_sweep_panel.captures == 1
    # one first apply a factor, one apply a step
    factors = 3 + solve_sweep_panel.escalations
    assert solve_sweep_panel.replays == sum(its) + factors
    reset_sweep_counters()
    assert solve_sweep_panel.captures == solve_sweep_panel.replays == 0


@pytest.mark.parametrize("singular", [False, True])
def test_the_captured_step_keeps_the_eager_spans(monkeypatch, singular):
    """Under a trace-mode timer the replayed step records the eager
    step's spans and host reads, one for one, plus one ``panel.capture``
    in the first chunk, with nothing opened inside the capture."""
    cfg = MorfemConfig(factorization="panel", panel_width=128, solve_chunk=2)
    counts = []
    for graphed in (False, True):
        if graphed:
            use_stand_in_graphs(monkeypatch)
        timer = PhaseTimer(trace=True)
        with timer.span("sweep_call"), timer.phase("full-order sweep"):
            solve_sweep_panel(_sweep_pencil(singular), cfg)
        counts.append(dict(timer.counts))
    eager, replayed = counts
    assert replayed.pop("panel.capture") == 1 and "panel.capture" not in eager
    assert replayed == eager
    for name in ("panel.apply", "refine.step", HOST_SYNC):
        assert eager[name] > 0
    cap = [i for i, s in enumerate(timer.spans) if s.name == "panel.capture"]
    assert timer.spans[timer.spans[cap[0]].parent].name == "panel.chunk"
    assert not [s for s in timer.spans if s.parent == cap[0]]


def test_a_factor_of_other_shapes_takes_the_eager_step(monkeypatch):
    """Under full pivoting with panels of 384 at N=300 the factor's
    panel is 384 and nothing escalates: every chunk replays. A step
    captured on another chunk's shapes is not bound."""
    use_stand_in_graphs(monkeypatch)
    sys_ = _sweep_pencil(False, n=300, pts=4)
    cfg = MorfemConfig(factorization="panel", panel_width=384,
                       solve_chunk=2, panel_pivot="full")
    reset_sweep_counters()
    x = solve_sweep_panel(sys_, cfg)
    assert solve_sweep_panel.captures == 1
    assert solve_sweep_panel.replays == sum(
        solve_sweep_panel.chunk_iterations) + 2
    f = panel_lu_factor_block(torch.eye(300, dtype=torch.float64)[None]
                              .expand(2, 300, 300), panel=128)
    c = torch.zeros((2, 3), dtype=torch.float64)
    b_w = torch.zeros((2, 300, 2), dtype=torch.float64)
    step = panel_lu_mod._CapturedStep(f, c, b_w, torch.zeros(
        (3, 300, 300), dtype=torch.float64))
    other = panel_lu_factor(torch.eye(300, dtype=torch.float64)[None]
                            .expand(2, 300, 300), panel=384)
    lug = step.f.lug.clone()
    assert not step.bind(other, c, b_w)  # one block of 384, not 3 of 128
    assert torch.equal(step.f.lug, lug)
    assert bool(torch.isfinite(x).all())
