"""Hand-written CUDA kernels of the port, each beside its plain version.

K1 `panel_factor`, K2 `mm_words` and K3 `gather_rows` replace the Pallas
kernels of the panel LU; K4 `gauss_jordan_sweep_solve` the fused
reduced-sweep kernel; K5 `banded_matvec_padded` and K6 `bsr_matmul_f32`
the banded and block-sparse matvecs of the Krylov snapshot solves; K7
`tri_inverse` the panel LU's diagonal-block inverses (batched matmuls in
the JAX package, no Pallas kernel). Each wrapper takes its plain PyTorch
version for a CPU tensor and launches its kernel for a CUDA tensor,
counting launches in its ``launches`` attribute.
"""

from morfem_tpu_torch.ops.kernels.banded_matvec import (
    banded_matvec_padded,
    banded_matvec_padded_plain,
)
from morfem_tpu_torch.ops.kernels.block_sparse import (
    bsr_matmul_f32,
    bsr_matmul_f32_plain,
)
from morfem_tpu_torch.ops.kernels.fused_mm import mm_words, mm_words_plain
from morfem_tpu_torch.ops.kernels.panel_factor import (
    panel_factor,
    panel_factor_plain,
)
from morfem_tpu_torch.ops.kernels.reduced_sweep import (
    gauss_jordan_sweep_solve,
    gauss_jordan_sweep_solve_plain,
)
from morfem_tpu_torch.ops.kernels.row_gather import (
    gather_rows,
    gather_rows_plain,
)
from morfem_tpu_torch.ops.kernels.tri_inverse import (
    tri_inverse,
    tri_inverse_plain,
)

KERNELS = (
    panel_factor, mm_words, gather_rows, gauss_jordan_sweep_solve,
    banded_matvec_padded, bsr_matmul_f32, tri_inverse,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
