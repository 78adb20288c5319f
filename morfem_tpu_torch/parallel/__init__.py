"""Multi-GPU scaling on torch.distributed: meshes and sharded paths.

Counterpart of `morfem_tpu/parallel`, with the same public names. Every
entry point is called on every rank with the whole inputs and returns the
whole output (`parallel/sharded.py` states the contract); the ranks are
processes of one process group (`parallel/launch.py::run_spmd` spawns
them).
"""

from morfem_tpu_torch.parallel.mesh import factorize_mesh, make_mesh
from morfem_tpu_torch.parallel.sharded import (
    batch_systems,
    multi_geometry_greedy,
    multi_geometry_mor,
    sharded_full_order_sweep,
    sharded_spectral_sweep,
    sharded_sweep,
    tp_operator_images_and_project,
)
from morfem_tpu_torch.parallel.tp_dense import (
    tp_gj_apply,
    tp_gj_factor,
    tp_solve_dense,
    tp_solve_dense_compiled,
)
from morfem_tpu_torch.parallel.tp_solve import (
    tp_matvec_fn,
    tp_snapshot_basis,
    tp_solve,
)

__all__ = [
    "factorize_mesh",
    "make_mesh",
    "batch_systems",
    "multi_geometry_greedy",
    "multi_geometry_mor",
    "sharded_full_order_sweep",
    "sharded_spectral_sweep",
    "sharded_sweep",
    "tp_operator_images_and_project",
    "tp_gj_apply",
    "tp_gj_factor",
    "tp_matvec_fn",
    "tp_snapshot_basis",
    "tp_solve",
    "tp_solve_dense",
    "tp_solve_dense_compiled",
]
