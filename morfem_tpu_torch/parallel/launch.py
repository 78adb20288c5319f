"""Process launch for the parallel layer: one process per rank.

The reference runs its SPMD programs on the devices of one process (on
the CPU, JAX's virtual devices). SPMD code in PyTorch needs one process
per rank, so this module spawns them:

  * `run_spmd(fn, world_size, backend, device, *args)` starts
    ``world_size`` processes (the ``spawn`` start method), builds the
    process group in each (a file rendezvous in a fresh temporary
    directory, so concurrent launches never share a port), calls
    ``fn(*args)`` on every rank and returns rank 0's result with its
    tensors moved to the CPU. ``fn`` must be importable by name from a
    fresh process (a module-level function). A rank that raises, or dies,
    ends the launch with a `RuntimeError` carrying its traceback; the
    other ranks are stopped. On ``device="cuda"`` rank r runs on card
    r mod (card count) — two ranks may share one card — and the kernel
    library is built by the parent before any rank starts, so the ranks
    only load it.
  * `call_on_mesh(dims, calls)` is a generic rank body: it builds the
    (dp, sp, tp) mesh and evaluates `Call`s, with `MESH` standing for the
    rank's mesh in their arguments.
  * `dryrun_multichip(n)` runs one sharded step of each path on tiny
    shapes over n gloo CPU ranks and holds each against the single-rank
    functions (the counterpart of the JAX package's
    `__graft_entry__.dryrun_multichip`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist


def _to_host(x):
    """x with every tensor moved to the CPU (tuples, named tuples, lists
    and dicts are walked)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world_size, backend, device, init_file, timeout_s,
               results, call):
    """Body of one spawned rank (see `run_spmd`). ``call`` and the result
    travel as plain pickles: `torch.multiprocessing`'s reducers would
    share tensor storage by file descriptors, which die with the rank."""
    try:
        fn, args = pickle.loads(call)
        extra = {}
        if torch.device(device).type == "cuda":
            card = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(card)
            if backend == "nccl":
                extra["device_id"] = card
        else:
            torch.set_num_threads(1)  # ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s), **extra)
        out = fn(*args)
        dist.barrier()
        results.put((rank, "ok",
                     pickle.dumps(_to_host(out)) if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_spmd(fn: Callable, world_size: int, backend: str = "gloo",
             device: str = "cpu", *args, timeout: float = 900.0) -> Any:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group (``backend``: "gloo" or "nccl") and return rank 0's result,
    tensors on the CPU. Raises `RuntimeError` when a rank fails or the
    launch exceeds ``timeout`` seconds."""
    import multiprocessing as mp

    if torch.device(device).type == "cuda":
        from morfem_tpu_torch.ops.kernels import _lib

        _lib.load()
    call = pickle.dumps((fn, args))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(target=_rank_main, args=(
                r, world_size, backend, str(device), init_file, timeout,
                results, call))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        try:
            out, done = None, set()
            deadline = time.monotonic() + timeout
            while len(done) < world_size:
                try:
                    rank, status, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} without a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"ranks {sorted(set(range(world_size)) - done)}"
                            f" did not finish within {timeout} s") from None
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                done.add(rank)
                if rank == 0:
                    out = pickle.loads(payload)
            for p in procs:
                p.join(timeout=60)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()


class _MeshRef:
    """Stands for the rank's mesh in the arguments of a `Call`."""


MESH = _MeshRef()


class Call(NamedTuple):
    """``fn(*args, **kwargs)`` evaluated on every rank by `call_on_mesh`;
    arguments may be `MESH` or other `Call`s."""

    fn: Callable
    args: tuple = ()
    kwargs: dict = {}


def call_on_mesh(dims, calls):
    """Rank body: build the (dp, sp, tp) mesh ``dims`` and evaluate each
    `Call` in ``calls`` in order; returns their results."""
    from morfem_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*dims)

    def resolve(x):
        if isinstance(x, _MeshRef):
            return mesh
        if isinstance(x, Call):
            return x.fn(*(resolve(a) for a in x.args),
                        **{k: resolve(v) for k, v in x.kwargs.items()})
        return x

    return [resolve(c) for c in calls]


def _dryrun_body(n_ranks: int):
    """One sharded step of each path on tiny shapes, each held against the
    single-rank functions on the same inputs; returns the deviations."""
    import numpy as np
    import scipy.sparse as sp

    from morfem_tpu_torch import (
        AffineSystem,
        MorfemConfig,
        equally_distributed_basis,
        greedy_basis,
        project,
        solve_sweep,
        sweep,
    )
    from morfem_tpu_torch.mor.equally import seed_indices
    from morfem_tpu_torch.mor.spectral import prepare_spectral_quadratic
    from morfem_tpu_torch.parallel import (
        batch_systems,
        factorize_mesh,
        make_mesh,
        multi_geometry_greedy,
        multi_geometry_mor,
        sharded_full_order_sweep,
        sharded_spectral_sweep,
        sharded_sweep,
        tp_operator_images_and_project,
        tp_solve_dense_compiled,
    )
    from morfem_tpu_torch.parallel.tp_banded import spike_solve
    from morfem_tpu_torch.utils.synthetic import random_affine_system

    dp, sp_, tp = factorize_mesh(n_ranks)
    mesh = make_mesh(dp, sp_, tp)
    cfg = MorfemConfig(factor_dtype_name="float32", refine_iterations=2)
    g, n, i_pts, m = 2 * dp, 16 * tp, 8 * sp_, 2
    systems = [AffineSystem.create(*random_affine_system(
        s, n=n, m=m, num_points=i_pts, device="cpu"), device="cpu")
        for s in range(g)]
    dev = {}

    def rec(q, x):
        return torch.einsum("nk,ikm->inm", q, x)

    a0s, a1s, a2s, bs, doms = batch_systems(systems)
    sidx = seed_indices(i_pts, cfg, count=3)
    s0 = systems[0]
    coeffs = (s0.t_a0, s0.t_a1, s0.t_a2, s0.t_b)
    x, q = multi_geometry_mor(a0s, a1s, a2s, bs, doms, sidx, coeffs, cfg,
                              mesh=mesh)
    dev["mor"] = max(
        float((rec(q[k], x[k]) - rec(qg, sweep(project(sg, qg), cfg)))
              .abs().max())
        for k, sg in enumerate(systems)
        for qg in [equally_distributed_basis(sg, cfg, count=3)])

    qq = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(1).standard_normal((n, 4))))[0]
    u, r, b_r = tp_operator_images_and_project(s0.operators(), s0.b, qq,
                                               mesh)
    dev["tp_project"] = max(
        max(float((u[p] - a @ qq).abs().max()),
            float((r[p] - qq.T @ a @ qq).abs().max()))
        for p, a in enumerate(s0.operators()))
    dev["tp_project"] = max(dev["tp_project"],
                            float((b_r - qq.T @ s0.b).abs().max()))

    rm = project(s0, qq)
    dev["sp_sweep"] = float(
        (sharded_sweep(rm, mesh, cfg) - sweep(rm, cfg)).abs().max())

    gcfg = cfg.replace(max_greedy_iterations=3, error_threshold=1e-6)
    gres = multi_geometry_greedy(a0s, a1s, a2s, bs, doms, coeffs, gcfg,
                                 mesh=mesh)
    d_gr = 0.0
    for k, sg in enumerate(systems):
        rs = greedy_basis(sg, gcfg)
        if int(gres.ncols[k]) != rs.ncols or \
                int(gres.iterations[k]) != rs.iterations:
            raise RuntimeError(f"greedy lane {k} differs from the serial run")
        qb, qs = gres.q[k][:, :rs.ncols], rs.q[:, :rs.ncols]
        d_gr = max(d_gr, float((qb @ qb.T - qs @ qs.T).abs().max()))
    dev["greedy"] = d_gr

    sq = prepare_spectral_quadratic(rm, cfg)
    dev["spectral"] = float(
        (sharded_spectral_sweep(sq, mesh) - sq.sweep()).abs().max())
    dev["full_sweep"] = float(
        (sharded_full_order_sweep(s0, mesh, cfg) - solve_sweep(s0, cfg))
        .abs().max())

    a_dense = s0.a0 + 2.0 * s0.a1 + 4.0 * s0.a2
    x_tp = tp_solve_dense_compiled(a_dense, s0.b, mesh, panel=8, sub=8)
    dev["tp_dense_residual"] = float(
        torch.linalg.norm(a_dense @ x_tp - s0.b) / torch.linalg.norm(s0.b))

    nb, half = max(256 * tp, 512), 3
    rng = np.random.default_rng(11)
    main_d = 2.0 + rng.random(nb)
    a_band = sp.diags([main_d] + [np.full(nb - d, -0.5)
                                  for d in range(1, half + 1)],
                      [0] + list(range(1, half + 1)))
    a_band = (a_band + a_band.T - sp.diags([main_d], [0])).tocoo()
    band = np.zeros((nb, 2 * half + 1))
    band[a_band.row, half + a_band.col - a_band.row] = a_band.data
    rhs = rng.standard_normal((nb, 2))
    x_sp, _, _ = spike_solve(torch.from_numpy(band), half,
                             torch.from_numpy(rhs), mesh, tol=1e-12)
    dev["spike_banded"] = float(np.abs(
        x_sp.numpy() - np.linalg.solve(a_band.toarray(), rhs)).max())

    bars = {"mor": 1e-9, "tp_project": 1e-10, "sp_sweep": 1e-9,
            "greedy": 1e-9, "spectral": 1e-9, "full_sweep": 1e-9,
            "tp_dense_residual": 1e-10, "spike_banded": 1e-9}
    bad = {k: v for k, v in dev.items() if not v < bars[k]}
    if bad:
        raise RuntimeError(f"dry run deviations over their bars: {bad}")
    return dev


def dryrun_multichip(n_devices: int) -> dict:
    """One sharded step of every parallel path over ``n_devices`` gloo CPU
    ranks (mesh shape from `factorize_mesh`), each held against the
    single-rank functions; returns the deviations, raises on a miss."""
    return run_spmd(_dryrun_body, n_devices, "gloo", "cpu", n_devices)
