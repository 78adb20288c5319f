"""Blocked panel LU over a batch of real systems — the full-order sweep's solver.

Counterpart of `morfem_tpu/ops/panel_lu.py`, on four hand-written CUDA
kernels of ``ops/kernels``:

  * right-looking blocked LU with partial pivoting and no row swaps; each
    panel is factored by K1 (`panel_factor`);
  * the pivot rows of each trailing block and the final permutation are
    gathered by K3 (`gather_rows`);
  * every O(N³) trailing update is one f32-true GEMM with the addend fused,
    K2 (`mm_words`);
  * the diagonal blocks of L and U are inverted together, K7
    (`tri_inverse`).

Rows are equilibrated to unit max first, and the block-pivot factor runs
first with a residual-checked escalation of the whole chunk to the
full-pivot factor, exactly as in the reference, so the port factors the
same panels and its pivot sequences match. The diagonal blocks of L and U
are inverted once per factor (per block step in the block-pivot factor;
one K7 launch each time, a ``panel.invert`` span under a trace-mode
`PhaseTimer`) so that both triangular phases of the apply are batched
matmuls.

The refinement residuals in `solve_sweep_panel` are plain float64
matmuls against the three shared affine operators — one wide product
serves every point of a chunk. The card has native f64, so the reference's
Ozaki split has no counterpart. On the card a chunk's refinement step
(the factor's apply, the residual) is replayed from CUDA graphs captured
once a sweep, `_CapturedStep`: the same kernels on the same inputs, so the
same bits as the eager step, for a few launches instead of ~90.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.device import capture_graph
from morfem_tpu_torch.ops.kernels import (
    gather_rows,
    mm_words,
    panel_factor,
    tri_inverse,
)
from morfem_tpu_torch.ops.refine import host_norm, refine, refine_masked
from morfem_tpu_torch.utils.timing import span

PANEL = 128
_TRAILS = ("f32x6", "f32x3")


def _mm_true(c, r, t=None, sign=1):
    """f32-true c@r (+t, ×sign), output written once (kernel K2).

    Both of the reference's trails map here: K2 is the reference's
    3-word bf16 split (six products), which the TPU ran for "f32x6"; its
    "f32x3" (three products, bf16x3) has no separate kernel on the card.
    """
    return mm_words(c, r, t, sign=sign)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def full_pivot_panel(n: int, panel: int) -> int:
    """Effective panel width of the FULL-pivot factor.

    The reference clamps wide panels back to 128 where its Pallas kernel's
    five P×Npl f32 buffers would overflow the TPU's 16 MB VMEM. The card
    has another limit (K1 keeps a CTA's lanes of the panel in its shared
    memory on a cluster of 8 or 16 CTAs, else in device memory, and takes
    any panel this clamp leaves); the clamp is kept for parity, so that
    both packages factor the same panels and pick the same pivots.
    """
    if panel > PANEL and 5 * panel * _round_up(n, panel) * 4 > 12 << 20:
        return PANEL
    return panel


def _invert_diagonal(lu: torch.Tensor):
    """(linv, uinv) of packed LU diagonal blocks [..., P, P] (K7)."""
    with span("panel.invert"):
        return tri_inverse(lu)


def _diagonal_blocks(lug: torch.Tensor, panel: int) -> torch.Tensor:
    """The P×P diagonal blocks of lug [G, Np, Np] as a [G, nb, P, P]
    view (no copy)."""
    g, np_, _ = lug.shape
    s0, s1, s2 = lug.stride()
    return lug.as_strided((g, np_ // panel, panel, panel),
                          (s0, panel * (s1 + s2), s1, s2),
                          lug.storage_offset())


class PanelLUFactors(NamedTuple):
    """Batched compact LU with inverted diagonal blocks (f32).

    lug:  [G, Np, Np] compact LU in textbook order (rows permuted).
    perm: [G, Np] int32 pivot order; solve with ``rhs[perm]``.
    linv: [G, nb, P, P] inverses of the unit-lower diagonal blocks.
    uinv: [G, nb, P, P] inverses of the upper diagonal blocks.
    dinv: [G, Np] row-equilibration reciprocals.
    n:    true (unpadded) dimension.
    """

    lug: torch.Tensor
    perm: torch.Tensor
    linv: torch.Tensor
    uinv: torch.Tensor
    dinv: torch.Tensor
    n: int


def _check_args(a: torch.Tensor, trail: str, panel: int) -> torch.Tensor:
    if trail not in _TRAILS:
        raise ValueError(f"trail must be 'f32x6' or 'f32x3', got {trail!r}")
    if panel % 128:
        raise ValueError(
            f"panel must be a multiple of 128 (the row-gather P contract), "
            f"got panel={panel}"
        )
    if a.ndim == 2:
        a = a[None]
    if a.shape[1] != a.shape[2]:
        raise ValueError(f"square systems required, got {tuple(a.shape)}")
    return a


def _equilibrate(a: torch.Tensor, np_: int):
    """Rows scaled to unit max, padded to Np with an identity tail."""
    g, n, _ = a.shape
    a32 = a.to(torch.float32)
    d = a32.abs().amax(dim=-1)
    d = torch.where(d == 0, torch.ones_like(d), d)
    a32 = a32 / d[..., None]
    dinv = torch.ones((g, np_), dtype=torch.float32, device=a.device)
    dinv[:, :n] = 1.0 / d
    if np_ != n:
        padded = torch.zeros((g, np_, np_), dtype=torch.float32,
                             device=a.device)
        padded[:, :n, :n] = a32
        # a fill, not an indexed store of a host scalar: capturable
        padded.diagonal(dim1=1, dim2=2)[:, n:].fill_(1.0)
        a32 = padded
    return a32, dinv


def panel_lu_factor(
    a: torch.Tensor, trail: str = "f32x6", panel: int = PANEL
) -> PanelLUFactors:
    """Factor a batch of real square systems [G, N, N] with full pivoting.

    Each step factors the leading panel of the remaining columns (K1),
    gathers its pivot rows from the trailing block (K3), and applies one
    rank-P update to the whole trailing block (K2). The pivot order is
    applied once at the end with one more gather (K3).
    """
    a = _check_args(a, trail, panel)
    g, n, _ = a.shape
    panel = full_pivot_panel(n, panel)
    np_ = _round_up(n, panel)
    nb = np_ // panel
    rest, dinv = _equilibrate(a, np_)

    avail = torch.ones((g, np_), dtype=torch.float32, device=a.device)
    done, pivs = [], []
    for k in range(nb):
        panel_t = rest[:, :, :panel].transpose(1, 2).contiguous()
        fac_t, c_t, piv, avail = panel_factor(panel_t, avail)
        done.append(fac_t.transpose(1, 2))
        pivs.append(piv)
        if k + 1 < nb:
            tr = rest[:, :, panel:]
            rows = gather_rows(tr, piv)  # [G, P, W]
            rest = _mm_true(c_t.transpose(1, 2), rows, t=tr)

    perm = torch.cat(pivs, dim=1)
    lug = gather_rows(torch.cat(done, dim=2), perm)
    linv, uinv = _invert_diagonal(_diagonal_blocks(lug, panel))
    return PanelLUFactors(lug, perm, linv, uinv, dinv, n)


def panel_lu_factor_block(
    a: torch.Tensor, trail: str = "f32x6", panel: int = PANEL
) -> PanelLUFactors:
    """Blocked LU with BLOCK-LOCAL pivoting — every O(N³) FLOP is a GEMM.

    Pivots only within each P-row diagonal block (K1 on [P, P] blocks):

        P_k·D = L11·U11,  U12 = L11⁻¹·P_k·A12,  L21 = A21·U11⁻¹,
        S = A22 − L21·U12                        (K2, addend fused)

    Element growth is unbounded on ill-conditioned diagonal blocks, so
    callers verify residuals and escalate to `panel_lu_factor`
    (`solve_sweep_panel` does).
    """
    a = _check_args(a, trail, panel)
    g, n, _ = a.shape
    np_ = _round_up(n, panel)
    nb = np_ // panel
    rest, dinv = _equilibrate(a, np_)

    ones_avail = torch.ones((g, panel), dtype=torch.float32, device=a.device)
    out = torch.zeros((g, np_, np_), dtype=torch.float32, device=a.device)
    linvs, uinvs, pivs = [], [], []
    for k in range(nb):
        lo, hi = k * panel, (k + 1) * panel
        d_t = rest[:, :panel, :panel].transpose(1, 2).contiguous()
        # the block-local factor never uses C̃, so K1 does not compute it
        fac_t, _c, piv, _av = panel_factor(d_t, ones_avail, want_ct=False)
        lu_d = gather_rows(fac_t.transpose(1, 2).contiguous(), piv)
        linv, uinv = _invert_diagonal(lu_d)
        if k > 0:
            # the local pivot reorders this band's already-written L21
            # rows (LAPACK's laswp over the factored left part)
            out[:, lo:hi, :lo] = gather_rows(out[:, lo:hi, :lo], piv)
        out[:, lo:hi, lo:hi] = lu_d
        if k + 1 < nb:
            a12p = gather_rows(rest[:, :panel, panel:], piv)  # [G, P, W]
            u12 = _mm_true(linv, a12p)
            l21 = _mm_true(rest[:, panel:, :panel], uinv)  # [G, W, P]
            rest = _mm_true(l21, u12, t=rest[:, panel:, panel:], sign=-1)
            out[:, lo:hi, hi:] = u12
            out[:, hi:, lo:hi] = l21
        linvs.append(linv)
        uinvs.append(uinv)
        pivs.append(lo + piv)

    return PanelLUFactors(
        lug=out,
        perm=torch.cat(pivs, dim=1),
        linv=torch.stack(linvs, dim=1),
        uinv=torch.stack(uinvs, dim=1),
        dinv=dinv,
        n=n,
    )


def panel_lu_apply(f: PanelLUFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Approximate A⁻¹·rhs from the f32 factors; rhs [G, N, M] any float.

    Block forward and backward substitution with the inverted diagonal
    blocks: every step is a batched FP32 matmul. Callers refine.
    """
    g, np_, _ = f.lug.shape
    panel = f.linv.shape[-1]
    nb = np_ // panel
    n, m = rhs.shape[-2], rhs.shape[-1]
    r32 = torch.zeros((g, np_, m), dtype=torch.float32, device=rhs.device)
    r32[:, :n] = rhs.to(torch.float32)
    r32 = r32 * f.dinv[..., None]  # solve (D⁻¹A)x = D⁻¹b
    batch = torch.arange(g, device=rhs.device)[:, None]
    y = r32[batch, f.perm.long()]
    for k in range(nb):  # L·y = P·b, in place
        lo, hi = k * panel, (k + 1) * panel
        y[:, lo:hi] = f.linv[:, k] @ y[:, lo:hi]
        if hi < np_:
            y[:, hi:] -= f.lug[:, hi:, lo:hi] @ y[:, lo:hi]
    x = y
    for k in reversed(range(nb)):  # U·x = y, in place
        lo, hi = k * panel, (k + 1) * panel
        x[:, lo:hi] = f.uinv[:, k] @ x[:, lo:hi]
        if lo > 0:
            x[:, :lo] -= f.lug[:, :lo, lo:hi] @ x[:, lo:hi]
    return x[:, :n]


def solve_batch_panel(
    a: torch.Tensor,  # [G, N, N] working dtype (real)
    b: torch.Tensor,  # [G, N, M] working dtype
    config: MorfemConfig = DEFAULT_CONFIG,
    masked: bool = False,
) -> torch.Tensor:
    """Batched direct solve: full-pivot panel LU + adaptive refinement.

    The refinement stops on the norm of the whole batch's residual.
    ``masked=True`` refines each system to its own stopping rule, as the
    reference's `vmap` over solves of one system does, through the masked
    fixed trip `ops/refine.py::refine_masked`: nothing synchronises the
    host, so a CUDA graph can capture the call.
    """
    f = panel_lu_factor(a, panel=config.panel_width)
    work = torch.promote_types(a.dtype, b.dtype)
    x = panel_lu_apply(f, b).to(work)
    if torch.finfo(work).bits <= 32 or config.refine_iterations <= 0:
        return x
    if masked:
        return refine_masked(
            a, b, x, lambda r: panel_lu_apply(f, r).to(work),
            config.refine_iterations, per_lane=True,
        )
    a_w, b_w = a.to(work), b.to(work)
    tol = 10 * torch.finfo(work).eps * host_norm(b_w)
    return refine(
        x, lambda x: b_w - a_w @ x, lambda r: panel_lu_apply(f, r).to(work),
        tol, config.refine_iterations, norm=host_norm,
        span_name="refine.step",
    )[0]


def _chunk_residual(ops_w, c, b_w, x):
    """b − Σ_p c_p·(ops_w[p] @ x) of a chunk [G, N, M]: one wide
    [N, N] @ [N, G·M] product per operator serves the whole chunk."""
    g, n, m = x.shape
    xf = x.transpose(0, 1).reshape(n, g * m)
    ys = (ops_w @ xf).reshape(3, n, g, m)
    ax = (c.T.to(x.dtype)[:, None, :, None] * ys).sum(0)  # [N, G, M]
    return b_w - ax.transpose(0, 1)


def _captures_on(dev: torch.device) -> bool:
    """Whether the sweep captures its refinement step on `dev`: on a
    CUDA device."""
    return dev.type == "cuda"


def _step_shapes(f: PanelLUFactors, c, b_w):
    return tuple((t.shape, t.dtype) for t in (
        f.lug, f.perm, f.linv, f.uinv, f.dinv, c, b_w)) + (f.n,)


class _CapturedStep:
    """A chunk's refinement step as two CUDA graphs over static inputs.

    Captured on the factor, coefficients c and right-hand side b_w of one
    chunk, which stay its static inputs; `bind` copies another chunk's
    in when their shapes match. `residual(x)` replays b_w − A(t)·x and
    `apply(r)` the factor's apply, each after copying its argument into
    the static input unless it is that input: the apply reads the
    residual's static output, so a step copies only x. Both return
    static outputs, which the next replay overwrites.
    """

    def __init__(self, f: PanelLUFactors, c, b_w, ops_w):
        self.f = f
        self.c = c.clone(memory_format=torch.contiguous_format)
        self.b_w = b_w.clone(memory_format=torch.contiguous_format)
        self.x = torch.zeros_like(self.b_w)
        self.shapes = _step_shapes(f, c, b_w)
        dev = b_w.device
        self._residual, self.r = capture_graph(
            dev, lambda: _chunk_residual(ops_w, self.c, self.b_w, self.x))
        self._apply, self._dx = capture_graph(
            dev, lambda: panel_lu_apply(self.f, self.r).to(self.b_w.dtype))

    def bind(self, f: PanelLUFactors, c, b_w) -> bool:
        """Make the chunk (f, c, b_w) the static inputs; False, leaving
        them as they were, where its shapes differ from the captured."""
        if f is self.f:
            return True
        if _step_shapes(f, c, b_w) != self.shapes:
            return False
        for mine, new in zip(self.f[:5], f[:5]):
            mine.copy_(new)
        self.c.copy_(c)
        self.b_w.copy_(b_w)
        return True

    def residual(self, x):
        if x is not self.x:
            self.x.copy_(x)
        self._residual.replay()
        return self.r

    def apply(self, r):
        if r is not self.r:
            self.r.copy_(r)
        self._apply.replay()
        solve_sweep_panel.replays += 1
        return self._dx


def solve_sweep_panel(sys, config: MorfemConfig = DEFAULT_CONFIG):
    """Full-order sweep: chunked panel LU + shared-operator refinement.

    Per chunk of ``config.solve_chunk`` points: assemble A(t) in f32 from
    pre-cast operators, factor, solve, then refine the whole chunk with
    residuals against the three shared f64 operators. Under the default
    ``panel_pivot="block"`` the block-pivot factor runs first and the chunk
    escalates to the full-pivot factor when refinement stagnates above
    max(10·ε·‖b‖, 1e-9·‖b‖). Returns x [I, N, M].

    On the card the first refined factor of the call captures its step
    (`_CapturedStep`), and every factor of the same shapes (each chunk's
    first factor: the padded last chunk has the same G) replays it, its
    first apply too; a factor of other shapes (the full-pivot escalation's
    128-wide blocks) and the CPU take the eager step. Either gives the
    same bits.

    Plain counters, like the kernels' launches: ``escalations`` counts the
    chunks escalated to the full-pivot factor, and ``chunk_iterations``
    gets each chunk's refinement iterations (all its factors), appended in
    order; ``captures`` counts the steps captured, ``replays`` the applies
    run by replay. `reset_sweep_counters` zeroes them. Under a trace-mode
    `PhaseTimer` each chunk is a ``panel.chunk`` span, holding a
    ``panel.factor`` (with its ``panel.invert`` spans) and a
    ``panel.apply`` per factor tried, the ``refine.step`` spans and,
    around the full-pivot retry, ``panel.escalate``; the capture is a
    ``panel.capture`` span (`utils/timing.py`).
    """
    from morfem_tpu_torch.ops.assembly import impulse_vector

    i_pts = sys.num_points
    chunk = max(1, min(config.solve_chunk, i_pts))
    pad = (-i_pts) % chunk
    ts_all = torch.cat([sys.domain, sys.domain[-1:].expand(pad)])
    work = sys.b.dtype
    wide = torch.finfo(work).bits > 32
    ops = sys.operators()
    if config.symmetrize and not sys.symmetric_ops:
        ops = tuple((o + o.T) * 0.5 for o in ops)
    ops_w = torch.stack([o.to(work) for o in ops])  # [3, N, N]
    # the factor only preconditions (residuals use the exact f64
    # operators), so A(t) is assembled from pre-cast f32 operators
    ops32 = ops_w.to(torch.float32)
    cap = config.refine_iterations
    on_card = _captures_on(ops_w.device)
    step = None

    def solve_chunk(ts):
        c, cb = sys.coefficients(ts)  # [G, 3], [G]
        a = torch.einsum("gp,pij->gij", c.to(torch.float32), ops32)
        rhs = impulse_vector(sys.b, cb)
        if not wide or cap <= 0:
            with span("panel.factor"):
                f = panel_lu_factor(a, panel=config.panel_width)
            with span("panel.apply"):
                return panel_lu_apply(f, rhs).to(work), 0
        b_w = rhs.to(work)
        b_norm = host_norm(b_w)
        tol = 10 * torch.finfo(work).eps * b_norm

        def factor_refine(trail, pivot):
            nonlocal step
            factor = panel_lu_factor_block if pivot == "block" else (
                panel_lu_factor
            )
            with span("panel.factor"):
                f = factor(a, trail=trail, panel=config.panel_width)
            if on_card and step is None:
                with span("panel.capture"):
                    step = _CapturedStep(f, c, b_w, ops_w)
                solve_sweep_panel.captures += 1
            if step is not None and step.bind(f, c, b_w):
                residual, apply = step.residual, step.apply
                with span("panel.apply"):
                    # the replay's output is static: x starts as a copy
                    x = apply(rhs).clone()
            else:
                def residual(x):
                    return _chunk_residual(ops_w, c, b_w, x)

                def apply(r):
                    return panel_lu_apply(f, r).to(work)

                with span("panel.apply"):
                    x = apply(rhs)
            x, _, r_norm, steps = refine(
                x, residual, apply, tol, cap, norm=host_norm,
                span_name="refine.step",
            )
            return x, r_norm, steps

        sound_tol = max(tol, 1e-9 * b_norm)
        first_trail = "f32x3" if config.panel_trail == "fast" else "f32x6"
        if config.panel_pivot == "block":
            x, r_norm, steps = factor_refine(first_trail, "block")
        elif config.panel_trail == "fast":
            x, r_norm, steps = factor_refine("f32x3", "full")
        else:
            x, _, steps = factor_refine("f32x6", "full")
            return x, steps
        # "not <=" so that a NaN residual (an exactly singular diagonal
        # block under block pivoting) escalates too
        if not r_norm <= sound_tol:
            solve_sweep_panel.escalations += 1
            with span("panel.escalate"):
                x, _, more = factor_refine("f32x6", "full")
            steps += more
        return x, steps

    xs = []
    for ts in ts_all.split(chunk):
        with span("panel.chunk"):
            x, steps = solve_chunk(ts)
        xs.append(x)
        solve_sweep_panel.chunk_iterations.append(steps)
    return torch.cat(xs)[:i_pts]


def reset_sweep_counters() -> None:
    """Zero the refinement, escalation and graph counters of the panel
    sweep."""
    solve_sweep_panel.escalations = 0
    solve_sweep_panel.chunk_iterations = []
    solve_sweep_panel.captures = 0
    solve_sweep_panel.replays = 0


reset_sweep_counters()
