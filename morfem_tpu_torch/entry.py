"""The flagship forward step, captured as CUDA graphs, and its entry points.

Counterpart of the repository's `__graft_entry__.py`. `entry()` returns
the flagship forward step of the waveguide MOR pipeline as a function of
plain tensors, with its example arguments; `dryrun_multichip` (from
`parallel/launch.py`) runs one sharded step of every parallel path. The
step (`flagship_step`, the reference's `_flagship_step`) is

    seed solves at equally spaced points (each A(t) symmetrised)
    → thin SVD + one CholeskyQR pass → Galerkin projection
    → reduced assembly → batched reduced LU → GSM (re, im).

The reference runs it as one compiled program (`jax.jit`), whose
refinement `while_loop`s never return to the host. Here every solve
refines as a masked fixed trip (`ops/refine.py::refine_masked`) and nothing
else synchronises the host, except the thin SVD: `torch.linalg.svd` checks
its info on the host with every cuSOLVER algorithm, so no CUDA graph can hold
it. `capture` therefore records the step as two graphs with the SVD run
eagerly between them (`FlagshipStep.stages`).

    python -m morfem_tpu_torch.entry [--cpu]

runs `entry()`'s example once (captured and replayed on the card) and
prints the outputs' shapes.
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from morfem_tpu_torch.apps.waveguide import (
    B_SCALE,
    GAMMA_SCALE,
    b_coefficient,
    calibrate_port_amplitude,
    generalized_scattering_matrix,
    synthesize_waveguide,
)
from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.device import capture_graph, resolve_device
from morfem_tpu_torch.mor.reduced import (
    ReducedModel,
    assemble_reduced,
    solve_reduced_batch,
)
from morfem_tpu_torch.ops.orthonormalize import cholesky_qr_refine
from morfem_tpu_torch.ops.solve import solve_dense
from morfem_tpu_torch.parallel.launch import dryrun_multichip

__all__ = ["FlagshipStep", "CapturedStep", "capture", "dryrun_multichip",
           "entry", "flagship_step"]


# the waveguide's coefficient functions; each returns a tensor, so nothing
# is copied from the host inside a captured graph
def t_a0(t):
    return torch.ones_like(t)


def t_a1(t):
    return t


def t_a2(t):
    return t**2


t_b = b_coefficient


class FlagshipStep:
    """step(a0, a1, a2, b, domain, seed_idx) → (x, gsm_re, gsm_im).

    a0, a1, a2 [N, N] and b [N, M] float64; domain [I]; seed_idx [S]
    integer indices into domain. x [I, S·M, M] holds the reduced
    solutions, gsm_re / gsm_im [I, M, M] the GSM's parts.

    ``stages`` lists the step's parts in order as (label, function,
    capturable); each function takes the step's arguments followed by the
    previous stage's outputs and returns a tuple. Calling the step runs
    them in order.
    """

    def __init__(self, config: MorfemConfig):
        self.config = config
        self.stages: Tuple[Tuple[str, Callable, bool], ...] = (
            ("seed solves", self.snapshots, True),
            ("thin SVD", self.svd, False),
            ("projection, reduced sweep and GSM", self.reduce, True),
        )

    def snapshots(self, a0, a1, a2, b, domain, seed_idx):
        """The seed solves' columns, stacked → ([N, S·M],)."""
        ts = domain[seed_idx]
        a_seed = a0 + (ts**2)[:, None, None] * a2 + ts[:, None, None] * a1
        a_seed = (a_seed + a_seed.transpose(-1, -2)) * 0.5
        rhs = t_b(ts)[:, None, None] * b
        snaps = solve_dense(a_seed, rhs, self.config, masked=True)
        return (snaps.transpose(0, 1).reshape(a0.shape[0], -1),)

    def svd(self, *args):
        """Left singular vectors of the snapshots (the last argument)."""
        return (torch.linalg.svd(args[-1], full_matrices=False)[0],)

    def reduce(self, a0, a1, a2, b, domain, seed_idx, u):
        """CholeskyQR of u, projection, reduced sweep over the domain, GSM."""
        q = cholesky_qr_refine(u)
        qt = q.T
        rm = ReducedModel(
            domain=domain, q=q, r0=qt @ (a0 @ q), r1=qt @ (a1 @ q),
            r2=qt @ (a2 @ q), b_r=qt @ b, ncols=q.shape[1],
            t_a0=t_a0, t_a1=t_a1, t_a2=t_a2, t_b=t_b,
        )
        a_red, rhs_red = assemble_reduced(rm, domain, self.config)
        x = solve_reduced_batch(a_red, rhs_red, self.config, masked=True)
        gsm = generalized_scattering_matrix(
            domain, x, t_b(domain)[:, None, None] * rm.b_r)
        return x, gsm.real, gsm.imag

    def __call__(self, *args):
        out = ()
        for _, fn, _ in self.stages:
            out = fn(*args, *out)
        return out


def flagship_step(cfg_kw: Optional[dict] = None) -> FlagshipStep:
    """The flagship forward step under ``MorfemConfig(**cfg_kw)``.

    The seed solves follow ``config.factorization`` as `solve_dense` does
    (``"panel"``: the panel LU's kernels K1–K3 on the whole batch of
    seeds); every refinement stops as the reference's does, each seed on
    its own norms, the reduced sweep on the whole batch's.
    """
    return FlagshipStep(MorfemConfig(**(cfg_kw or {})))


class _Segment(NamedTuple):
    label: str
    graph: Optional[torch.cuda.CUDAGraph]  # None: runs eagerly
    fn: Callable
    args: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]


class CapturedStep:
    """A step recorded as CUDA graphs, replayed by calling it.

    ``inputs`` are the static input tensors, ``outputs`` the static
    outputs (overwritten by every call); ``segments`` names each part and
    whether it is a graph. A call copies its arguments (if any) into the
    inputs, replays every graph and runs the eager parts between them.
    """

    def __init__(self, inputs, segments, outputs):
        self.inputs = inputs
        self.segments = segments
        self.outputs = outputs

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        for seg in self.segments:
            if seg.graph is not None:
                seg.graph.replay()
            else:
                for dst, src in zip(seg.outputs, seg.fn(*seg.args)):
                    dst.copy_(src)
        return self.outputs


def capture(fn, args: Sequence[torch.Tensor]) -> CapturedStep:
    """Record ``fn(*args)`` as CUDA graphs → a replayable `CapturedStep`.

    `fn` is a step with ``stages``, as `FlagshipStep` is, and `args` are
    CUDA tensors. Each capturable stage is captured by
    `device.capture_graph` (a warm-up on a side stream first) and
    replayed once, so that its outputs hold
    the values the next stage reads; a stage that cannot be captured runs
    eagerly between the graphs at every call, its results copied into the
    buffers the next graph reads. Any failure raises: there is no quiet
    eager fallback.
    """
    args = tuple(args)
    dev = args[0].device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("capture needs all arguments on one CUDA device")
    inputs = tuple(a.clone() for a in args)
    segments, prev = [], ()
    for label, stage, capturable in fn.stages:
        stage_args = inputs + tuple(prev)
        if capturable:
            graph, out = capture_graph(dev, stage, *stage_args)
            graph.replay()
        else:
            graph, out = None, stage(*stage_args)
        out = tuple(out)
        segments.append(_Segment(label, graph, stage, stage_args, out))
        prev = out
    return CapturedStep(inputs, segments, prev)


def entry(device="cuda"):
    """(fn, example_args): the flagship step and the reference's example.

    N=256, M=2, I=64 points over 3–5 GHz, 6 equally spaced seeds; the
    synthetic waveguide of seed 7, its port amplitude calibrated, scaled by
    GAMMA_SCALE and B_SCALE as `__graft_entry__.entry` builds it.
    """
    dev = resolve_device(device)
    n, m, i_pts, seeds = 256, 2, 64, 6
    c_mat, t_mat, wp = synthesize_waveguide(n, m, seed=7)
    wp = calibrate_port_amplitude(c_mat, t_mat, wp)

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    args = (
        f64(c_mat),
        torch.zeros((n, n), dtype=torch.float64, device=dev),
        f64(t_mat * GAMMA_SCALE),
        f64(wp * B_SCALE),
        f64(np.linspace(3e9, 5e9, i_pts)),
        torch.as_tensor(np.linspace(0, i_pts - 1, seeds).astype(int),
                        device=dev),
    )
    return flagship_step(), args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the step eagerly on the CPU")
    opts = ap.parse_args(argv)
    fn, args = entry("cpu" if opts.cpu else "cuda")
    out = fn(*args) if opts.cpu else capture(fn, args)()
    if args[0].device.type == "cuda":
        torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
