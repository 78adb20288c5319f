"""Public API: ``morfem()`` and `build_reduced_model`, which it wraps.

Counterpart of `morfem_tpu/mor/api.py` with the same call contract

    morfem(domain, a0, a1, a2, b, t_a0, t_a1, t_a2, t_b)
        -> (x, q, a0_r, a1_r, a2_r, b_r)

the same defaults (t_a0 = 1, t_a1 = t, t_a2 = t², t_b = t) and shapes
(x [I, Nr, M], q [N, Nr], a*_r [Nr, Nr], b_r [Nr, M]), plus a ``device``
(default ``"cuda"``). Real systems take the dense route, or, for
SciPy-sparse operators with N > ``config.dense_cutoff``, the matrix-free
route (`_morfem_matfree`: RCM-banded direct snapshot solves, or the
general-sparsity route after a `BandwidthError`).

A pencil that is swept again and again is prepared once as a
`MatfreeSystem` (the counterpart of the dense route's `AffineSystem`) and
handed to `build_reduced_model`, `morfem(domain, system)` or the
waveguide's `mor_gsm`.

Complex systems (complex operators or b, or a coefficient callable whose
values have a nonzero imaginary part anywhere on the grid) take the same
two routes: the dense pipeline runs natively in complex128, and the
matrix-free one runs on the interleaved real 2N embedding
(`_morfem_matfree_complex`) and returns the complex reduced model.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig
from morfem_tpu_torch.mor.equally import equally_distributed_basis
from morfem_tpu_torch.mor.greedy import GreedyResult, greedy_basis
from morfem_tpu_torch.mor.reduced import ReducedModel, project, sweep
from morfem_tpu_torch.device import resolve_device
from morfem_tpu_torch.system import (
    AffineSystem,
    Coefficient,
    _coefficients,
    _default_t_a0,
    _default_t_a1,
    _default_t_a2,
    _default_t_b,
)
from morfem_tpu_torch.utils.timing import PhaseTimer, span


def _warn_if_unconverged(result: GreedyResult) -> None:
    """Warn when the greedy loop stopped short of its error threshold.

    A failed snapshot solve (matrix-free greedy, ``failed_snapshot``) gets
    its own warning: more iterations cannot help there.
    """
    if result.converged:
        return
    if result.failed_snapshot:
        warnings.warn(
            "morfem(): greedy basis construction ABORTED after "
            f"{result.iterations} estimator evaluations because a "
            "seed/snapshot solve did not reach an acceptable residual "
            "(see the preceding snapshot-solver warnings for the failing "
            "point and residual). The returned reduced model is the best "
            "basis found; raising config.max_greedy_iterations will NOT "
            "help — improve the snapshot solver instead (e.g. "
            "config.band_max_half, Krylov settings, or conditioning of "
            "the system near the failing point).",
            stacklevel=3,
        )
        return
    warnings.warn(
        "morfem(): greedy basis construction stopped after "
        f"{result.iterations} estimator evaluations WITHOUT reaching the "
        "error threshold (column budget exhausted, or refinement "
        "stagnated). The returned reduced model is the best basis found; "
        "raise config.max_greedy_iterations or relax "
        "config.error_threshold to converge.",
        stacklevel=3,
    )


def build_reduced_model(
    sys: Union[AffineSystem, "MatfreeSystem"],
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
) -> Tuple[ReducedModel, Optional[GreedyResult]]:
    """Build the projection basis and project the system.

    Returns the padded ReducedModel and, for the greedy strategy, the
    GreedyResult with the error history. A `MatfreeSystem` takes the
    matrix-free route (`build_matfree`: the model comes back trimmed).
    """
    if isinstance(sys, MatfreeSystem):
        return build_matfree(sys, config, timer)
    timer = timer or PhaseTimer(disabled=True)
    greedy_result = None
    with timer.phase("projection base"):
        if config.use_equally_distributed:
            q = equally_distributed_basis(sys, config)
            ncols = q.shape[1]
        else:
            greedy_result = greedy_basis(sys, config)
            q, ncols = greedy_result.q, greedy_result.ncols
    if greedy_result is not None:
        _warn_if_unconverged(greedy_result)
    with timer.phase("projection"):
        rm = project(sys, q, ncols)
    return rm, greedy_result


def _run_sweep(rm: ReducedModel, config: MorfemConfig):
    """Final sweep per `config.sweep_method`: "auto" tries the two-term
    diagonalization, then the quadratic one, then batched LU."""
    if config.sweep_method == "lu":
        return sweep(rm, config)
    from morfem_tpu_torch.mor.spectral import (
        prepare_spectral,
        prepare_spectral_quadratic,
        spectral_sweep,
        spectral_sweep_quadratic,
    )

    try:
        return spectral_sweep(prepare_spectral(rm, config))
    except ValueError:
        if config.sweep_method == "spectral":
            raise
    try:
        return spectral_sweep_quadratic(prepare_spectral_quadratic(rm, config))
    except ValueError:
        return sweep(rm, config)


@dataclasses.dataclass(frozen=True)
class MatfreeSystem:
    """A large sparse pencil prepared once for the matrix-free route.

    The counterpart of the dense route's `AffineSystem`: `create` runs the
    operator setup of `morfem()`'s matrix-free route once (RCM reordering,
    banding and the copies to the device, `banded_via_rcm`; after a
    `BandwidthError` the exact operator with its truncated-band
    preconditioner, `truncated_band_via_rcm`), and `with_domain` re-grids
    it. `build_reduced_model`, `morfem()` and `apps/waveguide.py::mor_gsm`
    take it, so a call costs the greedy, the projection, the sweep and the
    GSM only, and gives what `morfem()` gives on the same matrices, bit for
    bit. Real pencils only.
    """

    domain: torch.Tensor  # [I]
    op: Any  # BandedAffineOperator, or GeneralSparseOperator
    perm: torch.Tensor  # [N]: the operator's row i is the caller's perm[i]
    b: torch.Tensor  # [N, M] in the operator's row order
    mats: tuple  # the SciPy addends as given (projected by the
    # equally-distributed basis)
    t_a0: Coefficient
    t_a1: Coefficient
    t_a2: Coefficient
    t_b: Coefficient
    t_extra: Tuple[Coefficient, ...] = ()
    symmetrize: bool = True  # the operator knobs it was made with
    band_max_half: int = 2048
    # what `project` prepares on first use, shared by the re-gridded
    # copies (``with_domain``)
    _prepared: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @classmethod
    def create(cls, domain, a0, a1, a2, b, t_a0=_default_t_a0,
               t_a1=_default_t_a1, t_a2=_default_t_a2, t_b=_default_t_b,
               config: MorfemConfig = DEFAULT_CONFIG, device="cuda",
               timer: Optional[PhaseTimer] = None, extra_terms=()):
        """Prepare the pencil with `config`'s operator knobs
        (``symmetrize``, ``band_max_half``). ``extra_terms``: ((matrix,
        coefficient callable), …) addends beyond the 3-term pencil; the
        complex route passes the embedded imaginary parts here, and they
        reach the reduced model as ``r_extra``."""
        import scipy.sparse as sp

        from morfem_tpu_torch.ops.block_tridiag import (
            BandwidthError,
            banded_via_rcm,
            truncated_band_via_rcm,
        )
        from morfem_tpu_torch.ops.sparse import GeneralSparseOperator

        timer = timer or PhaseTimer(disabled=True)
        dev = resolve_device(device)
        domain = torch.as_tensor(domain, device=dev)
        b = torch.as_tensor(b.toarray() if sp.issparse(b) else b, device=dev)
        if b.ndim == 1:
            b = b[:, None]
        mats = [m if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
                for m in (a0, a1, a2, *(m for m, _ in extra_terms))]
        with timer.phase("operator setup"):
            try:
                op, perm = banded_via_rcm(
                    *mats, symmetrize=config.symmetrize,
                    max_half=config.band_max_half, device=dev,
                )
            except BandwidthError:
                # non-band-recoverable sparsity: exact applies with the
                # truncated-band shifted-direct preconditioner; only the
                # bandwidth rejection lands here
                exact_op, band_op, perm, dropped = truncated_band_via_rcm(
                    *mats, symmetrize=config.symmetrize,
                    band_half=config.band_max_half, device=dev,
                )
                op = GeneralSparseOperator(exact_op, band_op, dropped=dropped)
            b_op = b[perm]
        return cls(domain=domain, op=op, perm=perm, b=b_op, mats=tuple(mats),
                   t_a0=t_a0, t_a1=t_a1, t_a2=t_a2, t_b=t_b,
                   t_extra=tuple(fn for _, fn in extra_terms),
                   symmetrize=config.symmetrize,
                   band_max_half=config.band_max_half)

    @property
    def n(self) -> int:
        return self.b.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[1]

    @property
    def device(self) -> torch.device:
        return self.b.device

    def with_domain(self, domain) -> "MatfreeSystem":
        return dataclasses.replace(
            self, domain=torch.as_tensor(domain, device=self.device))

    def coefficients(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c [..., P], cb [...]) for a tensor (or scalar) of points: the
        counterpart of `AffineSystem.coefficients`, over the operator's P
        addends (3, plus the extra terms)."""
        return _coefficients((self.t_a0, self.t_a1, self.t_a2,
                              *self.t_extra), self.t_b, t)

    def project(self, q: torch.Tensor):
        """Galerkin projection on the device → (P-tuple of r_p [K, K],
        b_r [K, M]): r_p = Qᵀ·A_p·Q of each addend as the caller passed
        it, b_r = Qᵀ·B, for q [N, K] in the operator's row order (what
        `ops/sparse.py::sparse_project` gives on the permuted addends).

        A_p·Q is the operator's `apply_addend` (the addend as the
        operator holds it), plus, where the operator symmetrised a
        non-symmetric addend, its antisymmetric part (A_p − A_pᵀ)/2
        applied from CSR storage on the device. An all-zero addend gives
        zeros. What this needs of the host (which addends are zero or
        non-symmetric, and those parts) is prepared on the first call and
        kept, so a call does no host work that scales with the nonzeros.
        """
        nonzero, skews = self._projection_storage()
        qt = q.T
        rs = []
        for p in range(len(self.mats)):
            if p not in nonzero:
                rs.append(q.new_zeros((q.shape[1], q.shape[1])))
                continue
            aq = self.op.apply_addend(p, q)
            if p in skews:
                aq = aq + skews[p] @ q
            rs.append(qt @ aq)
        return tuple(rs), qt @ self.b

    def _projection_storage(self):
        """(the nonzero addends, {p: (A_p − A_pᵀ)/2 as CSR on the device,
        in the operator's row order}), made on the first call: the
        antisymmetric part only of an addend the operator symmetrised
        that is not symmetric."""
        got = self._prepared.get("projection")
        if got is not None:
            return got
        from morfem_tpu_torch.ops.sparse import to_csr

        nonzero = [p for p, m in enumerate(self.mats) if m.count_nonzero()]
        skews, perm = {}, None
        for p in nonzero if self.symmetrize else ():
            m = self.mats[p].tocsr()
            skew = ((m - m.T) * 0.5).tocsr()
            skew.eliminate_zeros()
            if skew.nnz:
                if perm is None:
                    perm = self.perm.cpu().numpy()
                skews[p] = to_csr(skew[perm][:, perm], dtype=self.b.dtype,
                                  device=self.device)
        got = self._prepared["projection"] = (frozenset(nonzero), skews)
        return got

    def check_knobs(self, config: MorfemConfig) -> None:
        """Raise unless `config`'s operator knobs are the ones the system
        was prepared with."""
        if (config.symmetrize, config.band_max_half) != (
                self.symmetrize, self.band_max_half):
            raise ValueError(
                "the matrix-free system was prepared with symmetrize="
                f"{self.symmetrize}, band_max_half={self.band_max_half}; "
                "prepare it again with this config's")


def build_matfree(sys: MatfreeSystem, config: MorfemConfig = DEFAULT_CONFIG,
                  timer: Optional[PhaseTimer] = None):
    """The matrix-free reduced model, trimmed, with its basis in the
    CALLER's row order, and the GreedyResult (None for the
    equally-distributed basis)."""
    from morfem_tpu_torch.mor.equally import matfree_seed_basis
    from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree

    sys.check_knobs(config)
    timer = timer or PhaseTimer(disabled=True)
    domain, op, perm, b_op = sys.domain, sys.op, sys.perm, sys.b
    t_a0, t_a1, t_a2, t_b, t_extra = (sys.t_a0, sys.t_a1, sys.t_a2, sys.t_b,
                                      sys.t_extra)
    gres = None
    with timer.phase("projection base"):
        if config.use_equally_distributed:
            q_op = matfree_seed_basis(sys, config)
            with span("equally.project"):
                (r0, r1, r2, *r_extra), b_r = sys.project(q_op)
            rm = ReducedModel(
                domain=domain, q=q_op, r0=r0, r1=r1, r2=r2, b_r=b_r,
                ncols=q_op.shape[1], t_a0=t_a0, t_a1=t_a1, t_a2=t_a2,
                t_b=t_b, r_extra=tuple(r_extra), t_extra=t_extra,
            )
        else:
            gres, rm = greedy_basis_matfree(
                op, b_op, domain, t_a0, t_a1, t_a2, t_b, config=config,
                t_extra=t_extra,
            )
            _warn_if_unconverged(gres)
    rm = rm.trim()
    q_out = torch.zeros_like(rm.q)
    q_out[perm] = rm.q
    return dataclasses.replace(rm, q=q_out), gres


def _morfem_matfree(sys: MatfreeSystem, config, timer):
    """Matrix-free `morfem()` (same contract): `build_matfree`, then the
    reduced sweep. The returned q is in the CALLER's row order."""
    rm, _ = build_matfree(sys, config, timer)
    with timer.phase("reduced sweep"):
        x = _run_sweep(rm, config)
    return x, rm.q, rm.r0, rm.r1, rm.r2, rm.b_r


def morfem(
    domain,
    a0,
    a1=None,
    a2=None,
    b=None,
    t_a0=_default_t_a0,
    t_a1=_default_t_a1,
    t_a2=_default_t_a2,
    t_b=_default_t_b,
    config: MorfemConfig = DEFAULT_CONFIG,
    timer: Optional[PhaseTimer] = None,
    device="cuda",
):
    """Solve the parametric problem via model order reduction.

    Solves (t_a0·a0 + t_a1·a1 + t_a2·a2)·x = t_b·b over the whole domain
    by Galerkin projection onto a snapshot basis. Operators are arrays,
    tensors or SciPy sparse matrices, real or complex: sparse ones with
    N > ``config.dense_cutoff`` stay matrix-free end to end, smaller
    ones are densified. Coefficient callables act elementwise on a tensor
    of points and may return complex values. A complex system runs the
    dense pipeline in complex128, or the matrix-free one on the
    interleaved real embedding (``symmetrize=False`` required there).
    Returns (x, q, a0_r, a1_r, a2_r, b_r) as tensors on `device`, padding
    trimmed; q is in the caller's row order; for a complex system all six
    are complex and ``einsum("nk,ikm->inm", q, x)`` gives the solutions.

    ``morfem(domain, system)`` takes a `MatfreeSystem` prepared once from
    the sparse pencil (its coefficients and device are the system's): the
    operator setup is skipped, and the result is the one-shot call's on
    the same matrices, bit for bit.
    """
    import scipy.sparse as sp

    from morfem_tpu_torch.ops.complex_split import eval_coefficient_table

    timer = timer or PhaseTimer(disabled=True)
    if isinstance(a0, MatfreeSystem):
        if any(x is not None for x in (a1, a2, b)) or (
                t_a0, t_a1, t_a2, t_b) != (_default_t_a0, _default_t_a1,
                                           _default_t_a2, _default_t_b):
            raise ValueError("morfem(domain, system): a prepared "
                             "MatfreeSystem carries its operators, b and "
                             "coefficients")
        with timer.span("morfem"):
            return _morfem_matfree(a0.with_domain(domain), config, timer)
    missing = [name for name, x in (("a1", a1), ("a2", a2), ("b", b))
               if x is None]
    if missing:
        raise TypeError(
            f"morfem() missing {len(missing)} required argument(s): "
            + ", ".join(repr(name) for name in missing)
            + " (only a prepared MatfreeSystem carries them)")
    with timer.span("morfem"):
        fns = (t_a0, t_a1, t_a2, t_b)
        # one table per callable over the whole grid: the system is complex
        # when an operator or b is, or when a coefficient's value has a
        # nonzero imaginary part anywhere on the grid
        grid = torch.as_tensor(domain).to(device=resolve_device(device),
                                          dtype=torch.float64)
        tables = [eval_coefficient_table(grid, fn) for fn in fns]
        is_complex = any(_is_complex(x) for x in (a0, a1, a2, b)) or any(
            t.is_complex() and bool((t.imag != 0).any()) for t in tables
        )
        if not is_complex:
            fns = tuple(_real_valued(fn, t) for fn, t in zip(fns, tables))
        if (any(sp.issparse(x) for x in (a0, a1, a2))
                and a0.shape[0] > config.dense_cutoff):
            if is_complex:
                return _morfem_matfree_complex(domain, a0, a1, a2, b, tables,
                                               fns, config, timer, device)
            sys = MatfreeSystem.create(domain, a0, a1, a2, b, *fns,
                                       config=config, device=device,
                                       timer=timer)
            return _morfem_matfree(sys, config, timer)
        # a complex system is cast to complex128 once, in `AffineSystem.create`
        sys = AffineSystem.create(domain, a0, a1, a2, b, *fns, device=device)
        rm, _ = build_reduced_model(sys, config, timer)
        rm = rm.trim()
        with timer.phase("reduced sweep"):
            x = _run_sweep(rm, config)
        return x, rm.q, rm.r0, rm.r1, rm.r2, rm.b_r


def _is_complex(x) -> bool:
    """Complex dtype of an array, tensor or SciPy sparse matrix (read from
    the sparse matrix's data, never through ``np.asarray``)."""
    import scipy.sparse as sp

    if isinstance(x, torch.Tensor):
        return x.is_complex()
    return np.iscomplexobj(x.data if sp.issparse(x) else x)


def _real_valued(fn, table):
    """A callable whose complex-typed values are real on the grid, made to
    return their real part, so that a real system stays real."""
    if not table.is_complex():
        return fn
    return lambda t: fn(t).real


def _morfem_matfree_complex(domain, a0, a1, a2, b, tables, fns, config,
                            timer, device):
    """Complex `morfem()` — complex operators and/or complex coefficient
    callables — on the interleaved real 2N embedding, matrix-free.

    As in the reference:

    * complex operators embed as interleaved real 2×2 rotation blocks, so
      band structure survives (`embed_sparse_interleaved`);
    * a complex coefficient splits into two real terms,
      E(c·A) = Re(c)·E(A) + Im(c)·E(i·A); the Im parts ride as extra
      addends (``extra_terms`` → ``t_extra`` / ``r_extra``);
    * a complex t_b folds in as |t_b| during the build: A·x = c·b ⇔
      x = (c/|c|)·y with A·y = |c|·b, and the estimator's residual weight
      |t_b| is unchanged, so the greedy picks the complex problem's
      points.

    The build evaluates exact grid-lookup callables made from ``tables``
    (one evaluation of each callable over the grid). The returned model
    is the complex one (`mor/complex_model.py::finish_complex_model`):
    q [N, Nr] complex-orthonormal, r_i = qᵀ·a_i·q of the ORIGINAL
    operators, b_r = qᵀ·b, and x solving (Σ t_ai·r_i)·x = t_b·b_r, so any
    grid can be re-swept with the caller's callables
    (`sweep_complex_reduced`).
    """
    import scipy.sparse as sp

    from morfem_tpu_torch.mor.complex_model import finish_complex_model
    from morfem_tpu_torch.ops.complex_split import (
        _host_array,
        deinterleave,
        embed_rhs_interleaved,
        embed_sparse_interleaved,
        grid_lookup_coefficient,
    )

    if config.symmetrize:
        raise ValueError(
            "complex sparse systems: the real embedding is non-symmetric; "
            "run with config.symmetrize=False (the (A+Aᵀ)/2 step would "
            "change the problem)"
        )
    ops = [m if sp.issparse(m) else sp.csr_matrix(_host_array(m))
           for m in (a0, a1, a2)]
    ca, cb = tables[:3], tables[3]
    mats = [embed_sparse_interleaved(m) for m in ops]
    lookups = [grid_lookup_coefficient(domain, t.real) for t in ca]
    extra = tuple(
        (embed_sparse_interleaved(1j * m),
         grid_lookup_coefficient(domain, t.imag))
        for m, t in zip(ops, ca)
        if t.is_complex() and bool((t.imag != 0).any())
    )
    # the build solves with |t_b| (see above); the returned x comes from
    # the complex reduced model, so no phase is folded back here, and the
    # embedded real model is not swept (the reference sweeps it and
    # discards the result)
    tb = cb.abs() if cb.is_complex() else cb
    sys = MatfreeSystem.create(
        domain, *mats, embed_rhs_interleaved(b), *lookups,
        grid_lookup_coefficient(domain, tb), config=config, device=device,
        timer=timer, extra_terms=extra,
    )
    rm, _ = build_matfree(sys, config, timer)
    with timer.phase("complex reduced model"):
        return finish_complex_model(deinterleave(rm.q), *ops, b, domain,
                                    *fns)
