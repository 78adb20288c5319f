"""Device meshes and the three collectives of the port's parallel layer.

Counterpart of `morfem_tpu/parallel/mesh.py`. The scaling axes are the
reference's:

  * ``dp`` — independent MOR problems (multi-geometry batches, BASELINE
    config 5);
  * ``sp`` — the frequency/domain axis (independent points);
  * ``tp`` — the FEM DOF axis N (row- or column-sharded operators).

A `jax.sharding.Mesh` holds devices of one process; a
`torch.distributed.device_mesh.DeviceMesh` holds the ranks of a process
group, one process per rank (`parallel/launch.py` spawns them). The
process group must exist before `make_mesh` is called: NCCL on the
card, gloo on the CPU (gloo also carries CUDA tensors, staged through host
memory).

The collectives are `all_reduce`, the list form of `all_gather` followed by
`torch.cat` (the reference's tiled `lax.all_gather`) and `broadcast`, each
on the process group of one mesh axis. NCCL and gloo support all three.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "sp", "tp")


def make_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: int = 1,
    devices: Optional[Sequence[int]] = None,
):
    """A ('dp', 'sp', 'tp') `DeviceMesh` over the given (or all) ranks.

    ``devices`` are global ranks of the initialized process group
    (default: all of them, in order); the first dp·sp·tp are used. Raises
    `ValueError` when there are fewer. The mesh's device type follows the
    backend: ``cuda`` under NCCL, ``cpu`` under gloo (whose collectives
    take CPU and CUDA tensors alike).
    """
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices) if devices is not None else list(
        range(dist.get_world_size()))
    need = dp * sp * tp
    if len(ranks) < need:
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks[:need], dtype=torch.int).reshape(dp, sp, tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def factorize_mesh(n_devices: int) -> Tuple[int, int, int]:
    """Split n devices into a (dp, sp, tp) shape, preferring balance.

    Powers of two split evenly (8 → 2·2·2); otherwise the largest factor
    goes to dp (independent problems scale perfectly).
    """
    dp, sp, tp = 1, 1, 1
    rem = n_devices
    # peel factors of two round-robin onto tp, sp, dp
    order = ["tp", "sp", "dp"]
    i = 0
    while rem % 2 == 0 and rem > 1:
        if order[i % 3] == "tp":
            tp *= 2
        elif order[i % 3] == "sp":
            sp *= 2
        else:
            dp *= 2
        rem //= 2
        i += 1
    dp *= rem  # odd remainder → data parallelism
    return dp, sp, tp


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along one mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (the reference's
    `lax.axis_index`)."""
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) of t over the ranks of `axis` (the reference's
    `lax.psum` / `lax.pmax`); reduces t in place when it is contiguous,
    else a contiguous copy, and returns the reduced tensor."""
    t = t.contiguous()
    dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def all_gather_cat(t: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's t along `dim`, in the order of the ranks'
    coordinates on `axis` (the reference's tiled `lax.all_gather`).
    Every rank's t has the same shape."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def chunk(n: int, parts: int, index: int) -> Tuple[int, int, int]:
    """(start, stop, width) of block `index` when n rows are cut into
    `parts` blocks of width ceil(n / parts); the last may be short."""
    width = -(-n // parts)
    start = min(index * width, n)
    return start, min(start + width, n), width


def gather_rows(t_local: torch.Tensor, n: int, mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """The whole [..., n, ...] tensor from every rank's `chunk` of it along
    `dim`: short blocks are zero-padded to the common width for the
    gather and the padding is cut after."""
    width = -(-n // axis_size(mesh, axis))
    t = t_local.movedim(dim, 0)
    if t.shape[0] < width:
        t = torch.cat([t, t.new_zeros((width - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    full = all_gather_cat(t, mesh, axis)
    parts = full.split(width)
    return torch.cat([p[:max(0, min(width, n - i * width))]
                      for i, p in enumerate(parts)]).movedim(0, dim)
