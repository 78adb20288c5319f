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
from morfem_tpu_torch.mor.api import build_reduced_model, morfem  # noqa: E402
from morfem_tpu_torch.mor.greedy import GreedyResult, greedy_basis  # noqa: E402
from morfem_tpu_torch.mor.reduced import ReducedModel, project, sweep  # noqa: E402
from morfem_tpu_torch.ops.solve import solve_sweep  # noqa: E402
from morfem_tpu_torch.system import AffineSystem  # noqa: E402
from morfem_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

__all__ = [
    "DEFAULT_CONFIG",
    "MorfemConfig",
    "AffineSystem",
    "ReducedModel",
    "GreedyResult",
    "PhaseTimer",
    "morfem",
    "build_reduced_model",
    "greedy_basis",
    "project",
    "sweep",
    "solve_sweep",
]
