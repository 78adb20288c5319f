"""morfem_tpu_torch — the PyTorch/CUDA port of morfem_tpu.

Model order reduction for fast frequency sweeps of parametric affine
systems, ``(t_a0·A0 + t_a1·A1 + t_a2·A2)·X = t_b·B`` over a domain, with
the same API and module layout as the JAX package `morfem_tpu` (the
reference it is tested against). The full-order sweep's blocked panel LU
runs on hand-written CUDA kernels (``ops/kernels``, sources in ``csrc``).
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

import torch

# FP32 products must be f32-true: the f32 factor preconditions an f64
# refinement whose contraction rate is ~cond·ε_f32, and TF32 (about three
# decimal digits) would stall it near resonances. Both switches are set
# explicitly, whatever PyTorch's defaults are.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from morfem_tpu_torch.config import DEFAULT_CONFIG, MorfemConfig  # noqa: E402
from morfem_tpu_torch.system import AffineSystem  # noqa: E402
from morfem_tpu_torch.mor.api import (  # noqa: E402
    MatfreeSystem,
    build_reduced_model,
    morfem,
)
from morfem_tpu_torch.mor.reduced import ReducedModel, project, sweep  # noqa: E402
from morfem_tpu_torch.mor.greedy import GreedyResult, greedy_basis  # noqa: E402
from morfem_tpu_torch.mor.equally import equally_distributed_basis  # noqa: E402
from morfem_tpu_torch.ops.block_tridiag import (  # noqa: E402
    banded_direct_solve,
    banded_via_rcm,
    rcm_direct_solve,
    shifted_gmres_solve,
)
from morfem_tpu_torch.ops.spectral_solve import (  # noqa: E402
    FullOrderSpectral,
    prepare_spectral_full,
    spectral_full_sweep,
)
from morfem_tpu_torch.mor.spectral import (  # noqa: E402
    QuadraticSpectralModel,
    SpectralModel,
    prepare_spectral,
    prepare_spectral_quadratic,
    spectral_sweep,
    spectral_sweep_quadratic,
)
from morfem_tpu_torch.mor.estimator import (  # noqa: E402
    estimate_errors,
    estimate_errors_direct,
    estimator_blocks,
    operator_images,
)
from morfem_tpu_torch.ops.solve import (  # noqa: E402
    gj_solve_refined,
    lu_solve_refined,
    solve_batch,
    solve_dense,
    solve_point,
    solve_sweep,
)
from morfem_tpu_torch.ops.blocked_inverse import gj_inverse_f32  # noqa: E402
from morfem_tpu_torch.ops.complex_split import (  # noqa: E402
    embed_affine_system,
    solve_complex,
    solve_complex_split,
    split_solution,
)
from morfem_tpu_torch.mor.complex_model import sweep_complex_reduced  # noqa: E402
from morfem_tpu_torch.mor.greedy_matfree import greedy_basis_matfree  # noqa: E402
from morfem_tpu_torch.utils.timing import PhaseTimer  # noqa: E402
from morfem_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_reduced_model,
    save_reduced_model,
)

__all__ = [
    "MorfemConfig",
    "DEFAULT_CONFIG",
    "AffineSystem",
    "ReducedModel",
    "morfem",
    "build_reduced_model",
    "project",
    "sweep",
    "greedy_basis",
    "GreedyResult",
    "equally_distributed_basis",
    "SpectralModel",
    "QuadraticSpectralModel",
    "banded_direct_solve",
    "banded_via_rcm",
    "rcm_direct_solve",
    "shifted_gmres_solve",
    "FullOrderSpectral",
    "prepare_spectral_full",
    "spectral_full_sweep",
    "prepare_spectral",
    "prepare_spectral_quadratic",
    "spectral_sweep",
    "spectral_sweep_quadratic",
    "estimator_blocks",
    "estimate_errors",
    "estimate_errors_direct",
    "operator_images",
    "solve_point",
    "solve_batch",
    "solve_sweep",
    "solve_dense",
    "lu_solve_refined",
    "gj_solve_refined",
    "gj_inverse_f32",
    "greedy_basis_matfree",
    "sweep_complex_reduced",
    "PhaseTimer",
    "save_reduced_model",
    "load_reduced_model",
]
