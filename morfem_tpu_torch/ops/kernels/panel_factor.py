"""Masked partial-pivot panel factor — kernel K1 of the panel LU.

Counterpart of `morfem_tpu/ops/pallas/panel_factor.py::panel_factor`; the
CUDA source is ``csrc/panel_factor.cu``, whose header states the algebra:
pivoting without row swaps over an availability mask, the lowest row index
winning a tie, used rows keeping their U entries, and the composed
elimination coefficients C̃.

Pivots come back as int32 (the TPU kernel carried them as f32, an artefact
of that chip). With ``want_ct=False`` C̃ is neither computed nor returned
(the block-pivot LU discards it). A CPU tensor takes `panel_factor_plain`;
a CUDA tensor launches the one kernel, each panel split by lanes over a
thread-block cluster, in the variant that `panel_factor_plan` names from
the shape alone: ``"cluster8"`` (8 CTAs, the CTA's lanes in its shared
memory) where they fit, else ``"cluster16"`` (16 CTAs, non-portable) where
they fit and the card can place such a cluster, else ``"cluster_global"``
(the same split, the lanes in device memory). A launch that fails raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from morfem_tpu_torch.ops.kernels import _lib

# shared memory a block may use on Hopper (232,448 bytes)
MAX_SMEM = 232448


class PanelPlan(NamedTuple):
    """How the kernel factors a [P, Npl] panel (`panel_factor_plan`)."""

    variant: str  # "cluster8", "cluster16" or "cluster_global"
    cluster: int  # CTAs per batch entry
    lanes: int  # lanes (matrix rows) per CTA
    smem: int  # dynamic shared memory per CTA, bytes
    in_smem: bool  # the CTA's lanes live in its shared memory
    threads: int  # threads per CTA


def cta_threads(lanes: int) -> int:
    """Threads per CTA: 512 where a CTA owns 96 lanes or more (the update
    of its rows wants the warps), else 256 (three CTAs of the block-pivot
    [G, 384, 384] panels then share an SM)."""
    return 512 if lanes >= 96 else 256


def cluster_lanes(npl: int, cluster: int) -> int:
    """Lanes (matrix rows) per CTA: ceil(Npl / cluster)."""
    return -(-npl // cluster)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cluster_smem_bytes(p: int, npl: int, cluster: int, in_smem: bool) -> int:
    """Shared memory per CTA (``csrc/panel_factor.cu::smem_bytes``): the
    pivot lane's column, the CTA's buffer of L lanes, each of stride
    round_up(P, 32) + 4 (or, with the buffer in device memory, c_j over
    its L lanes), the mask over its lanes and the step slots. The same
    with or without C̃: one buffer holds both."""
    lanes = cluster_lanes(npl, cluster)
    buf = lanes * (_round_up(p, 32) + 4) if in_smem else lanes
    return 4 * (_round_up(p, 4) + buf + lanes + 6 * cluster + 2)


# (cluster, lanes in shared memory) in order of preference
_CANDIDATES = ((8, True), (16, True), (16, False), (8, False))


def panel_factor_plan(
    p: int, npl: int, want_ct: bool = True,
    placeable: Optional[Callable[[int, int, bool, int, bool], bool]] = None,
) -> PanelPlan:
    """The kernel variant for a [P, Npl] panel, from its shape alone.

    ``placeable(p, npl, want_ct, cluster, in_smem)`` says whether a
    cluster of more than 8 CTAs at that shared memory can be placed on the
    card at all (the wrapper asks `cudaOccupancyMaxActiveClusters`);
    ``None`` takes yes, the H100's answer at every shape the port runs.
    """
    for cluster, in_smem in _CANDIDATES:
        smem = cluster_smem_bytes(p, npl, cluster, in_smem)
        if smem > MAX_SMEM:
            continue
        if cluster > 8 and placeable is not None and not placeable(
                p, npl, want_ct, cluster, in_smem):
            continue
        variant = f"cluster{cluster}" if in_smem else "cluster_global"
        lanes = cluster_lanes(npl, cluster)
        return PanelPlan(variant, cluster, lanes, smem, in_smem,
                         cta_threads(lanes))
    raise ValueError(
        f"panel_factor: a [{p}, {npl}] panel fits no cluster variant"
    )


_MAX_CLUSTERS: dict = {}


def max_active_clusters(device: torch.device, p: int, npl: int,
                        want_ct: bool, cluster: int, in_smem: bool) -> int:
    """How many clusters of `cluster` CTAs at the shared memory of a
    [P, Npl] panel the card holds at once (`cudaOccupancyMaxActiveClusters`;
    0: none can be placed). One query per shape and variant, cached."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    key = (index, p, npl, bool(want_ct), cluster, bool(in_smem))
    if key not in _MAX_CLUSTERS:
        import ctypes

        count = ctypes.c_int(0)
        with torch.cuda.device(index):
            _lib.load().call(
                "morfem_panel_factor_max_clusters", p, npl, int(want_ct),
                cluster, int(in_smem),
                cta_threads(cluster_lanes(npl, cluster)), ctypes.byref(count))
        _MAX_CLUSTERS[key] = count.value
    return _MAX_CLUSTERS[key]


def placeable_on(device: torch.device):
    """`placeable` for `panel_factor_plan` on the card `device`."""
    def placeable(p, npl, want_ct, cluster, in_smem):
        return max_active_clusters(device, p, npl, want_ct, cluster,
                                   in_smem) > 0

    return placeable


def _check(panel_t: torch.Tensor, avail: torch.Tensor):
    if panel_t.ndim != 3 or avail.ndim != 2:
        raise ValueError(
            f"panel_factor needs panel_t [G, P, Npl] and avail [G, Npl], got "
            f"{tuple(panel_t.shape)} and {tuple(avail.shape)}"
        )
    g, p, npl = panel_t.shape
    if tuple(avail.shape) != (g, npl):
        raise ValueError(
            f"avail shape {tuple(avail.shape)} != {(g, npl)}"
        )
    if p > npl:
        raise ValueError(f"panel width P={p} exceeds its row count {npl}")
    for name, x in (("panel_t", panel_t), ("avail", avail)):
        if x.dtype != torch.float32:
            raise ValueError(f"panel_factor needs f32 {name}, got {x.dtype}")


def panel_factor_plain(panel_t: torch.Tensor, avail: torch.Tensor,
                       want_ct: bool = True):
    """The same function in plain PyTorch, one column step at a time.

    Returns (fac_t [G, P, Npl], c_t [G, P, Npl] or None, piv [G, P] int32,
    avail_new [G, Npl]).
    """
    _check(panel_t, avail)
    g, p, npl = panel_t.shape
    fac = panel_t.clone()
    ct = torch.zeros_like(fac) if want_ct else None
    av = avail.clone()
    piv = torch.empty((g, p), dtype=torch.int32, device=fac.device)
    lanes = torch.arange(npl, device=fac.device)
    for j in range(p):
        col = fac[:, j, :].clone()
        score = col.abs() * av - (1.0 - av)
        mx = score.max(dim=1, keepdim=True).values
        cand = torch.where(score >= mx, lanes, npl)
        r = cand.min(dim=1, keepdim=True).values  # lowest lane on ties
        # a NaN score finds no maximum (max propagates it); the pivot is
        # lane 0, in the kernel too
        r = torch.where(r < npl, r, torch.zeros_like(r))
        oh = lanes[None, :] == r
        inv = 1.0 / col.gather(1, r)
        keep = (av == 0) | oh
        l = torch.where(keep, torch.zeros_like(col), col * inv)
        c = -l
        fac[:, j, :] = torch.where(keep, col, l)
        ridx = r[:, None, :]
        later = fac[:, j + 1:, :]
        later += later.gather(2, ridx.expand(-1, later.shape[1], 1)) * c[:, None]
        if want_ct:
            ct[:, j, :] = c
            earlier = ct[:, :j, :]
            earlier += (
                earlier.gather(2, ridx.expand(-1, earlier.shape[1], 1))
                * c[:, None]
            )
        av = av * (~oh)
        piv[:, j] = r[:, 0].to(torch.int32)
    return fac, ct, piv, av


def panel_factor(panel_t: torch.Tensor, avail: torch.Tensor,
                 want_ct: bool = True):
    """Factor a batch of [Npl, P] panels given transposed as [G, P, Npl].

    Returns (fac_t, c_t or None, piv int32 [G, P], avail_new) — see the
    header of `csrc/panel_factor.cu` for their meaning. Any batch size G.
    """
    if panel_t.device.type == "cpu":
        return panel_factor_plain(panel_t, avail, want_ct)
    _check(panel_t, avail)
    _lib.check_cuda_tensor("panel_t", panel_t, torch.float32)
    _lib.check_cuda_tensor("avail", avail, torch.float32)
    if not (panel_t.is_contiguous() and avail.is_contiguous()):
        raise ValueError("panel_factor needs contiguous panel_t and avail")
    g, p, npl = panel_t.shape
    plan = panel_factor_plan(p, npl, want_ct, placeable_on(panel_t.device))
    fac = torch.empty_like(panel_t)
    ct = torch.empty_like(panel_t) if want_ct else None
    piv = torch.empty((g, p), dtype=torch.int32, device=panel_t.device)
    av_out = torch.empty_like(avail)
    lib = _lib.load()
    lib.call(
        "morfem_panel_factor", panel_t.data_ptr(), avail.data_ptr(),
        fac.data_ptr(), ct.data_ptr() if want_ct else None, piv.data_ptr(),
        av_out.data_ptr(), g, p, npl, int(want_ct), plan.cluster,
        int(plan.in_smem), plan.threads, _lib.stream_handle(panel_t),
    )
    panel_factor.launches += 1
    return fac, ct, piv, av_out


panel_factor.launches = 0
