"""Framework configuration — every knob of the pipeline in one dataclass.

PyTorch counterpart of `morfem_tpu/config.py`: the same fields, defaults
and checks, so one configuration reads the same in both packages. See that
module's docstring for what each knob means; the notes below say only
where the port differs.

* ``factorization="auto"`` resolves to the blocked panel LU
  (`ops/panel_lu.py`, hand-written CUDA kernels) for real systems with a
  float32 factor on a CUDA device, else to `torch.linalg` LU — the rule the
  reference applies on its accelerator (`ops/solve.py::
  use_panel_factorization`).
* ``use_pallas_reduced_sweep=True`` keeps the reference's name: the
  reduced LU sweep then runs the hand-written CUDA kernel K4
  (`ops/kernels/reduced_sweep.py`) in place of the batched library LU.
* ``"gj"`` solves real operators through the blocked Gauss–Jordan f32
  inverse with f64 refinement (`ops/solve.py::gj_solve_refined`), point
  by point, as in the reference.
* ``panel_width`` keeps the reference's multiple-of-128 rule: the panel LU
  factors the same panels as the reference, so its pivot sequences match.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MorfemConfig:
    """All tunables of the MOR pipeline (field parity with `morfem_tpu`)."""

    error_threshold: float = 1e-6
    factorization: str = "auto"
    use_equally_distributed: bool = False
    equally_distributed_reduction_rate: float = 0.97
    max_greedy_iterations: int = 40
    orthonormalization: str = "svd"
    factor_dtype_name: str = "float32"
    refine_iterations: int = 25
    solve_chunk: int = 8
    use_pallas_reduced_sweep: bool = False
    symmetrize: bool = True
    dependency_tolerance: float = 1e-12
    estimator: str = "direct"
    estimator_chunk: int = 1024
    estimator_impl: str = "auto"
    sweep_method: str = "auto"
    dense_cutoff: int = 8192
    band_max_half: int = 2048
    panel_trail: str = "accurate"
    panel_pivot: str = "block"
    panel_width: int = 384

    def __post_init__(self):
        choices = {
            "panel_trail": ("accurate", "fast"),
            "panel_pivot": ("full", "block"),
            "estimator_impl": ("auto", "einsum", "ozaki"),
            "factorization": ("auto", "lu", "gj", "panel"),
            "sweep_method": ("auto", "lu", "spectral"),
            "estimator": ("direct", "gram"),
            "orthonormalization": ("svd", "mgs"),
            "factor_dtype_name": ("float32", "float64"),
        }
        for name, allowed in choices.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got {value!r}"
                )
        if self.panel_width % 128 != 0 or self.panel_width <= 0:
            raise ValueError(
                f"panel_width must be a positive multiple of 128, got "
                f"{self.panel_width}"
            )
        if not 0.0 <= self.equally_distributed_reduction_rate < 1.0:
            raise ValueError(
                "equally_distributed_reduction_rate must be in [0, 1)"
            )

    def replace(self, **kw) -> "MorfemConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MorfemConfig()
