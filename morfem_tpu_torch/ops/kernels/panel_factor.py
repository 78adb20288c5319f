"""Masked partial-pivot panel factor — kernel K1 of the panel LU.

Counterpart of `morfem_tpu/ops/pallas/panel_factor.py::panel_factor`; the
CUDA source is ``csrc/panel_factor.cu``, whose header states the algebra:
pivoting without row swaps over an availability mask, the lowest row index
winning a tie, used rows keeping their U entries, and the composed
elimination coefficients C̃.

Pivots come back as int32 (the TPU kernel carried them as f32, an artefact
of that chip). With ``want_ct=False`` C̃ is neither computed nor returned
(the block-pivot LU discards it). A CPU tensor takes `panel_factor_plain`;
a CUDA tensor launches one of two kernels, picked by shape alone: the
cluster kernel (each panel split by lanes over 8 CTAs, held in their
shared memory) when its lanes fit, else the one-CTA kernel (panel in
device memory), which only the full-pivot escalation's [8, 128, 3456]
panel with C̃ needs.
"""

from __future__ import annotations

import torch

from morfem_tpu_torch.ops.kernels import _lib

# shared memory a block may use on Hopper (232,448 bytes)
MAX_SMEM = 232448
CLUSTER = 8  # CTAs per panel in the cluster kernel (portable cluster size)


def cluster_smem_bytes(p: int, npl: int, want_ct: bool) -> int:
    """Shared memory per CTA of the cluster kernel for a [P, Npl] panel
    (``csrc/panel_factor.cu::cluster_smem_bytes``): the step slots, the
    CTA's L = ceil(Npl / 8) lanes of pt (and of C̃), c_j and the mask over
    those lanes, and the pivot lane's column (and its C̃ column)."""
    lanes = -(-npl // CLUSTER)
    per = 2 if want_ct else 1
    return 2 * CLUSTER * 12 + 4 * (per * p * lanes + 2 * lanes + per * p)


def uses_cluster_kernel(p: int, npl: int, want_ct: bool) -> bool:
    """Whether a CUDA panel of this shape goes to the cluster kernel."""
    return cluster_smem_bytes(p, npl, want_ct) <= MAX_SMEM


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
        # a column of NaNs finds no maximum; keep the index in range (the
        # kernel does the same)
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
    header of `csrc/panel_factor.cu` for their meaning.
    """
    if panel_t.device.type == "cpu":
        return panel_factor_plain(panel_t, avail, want_ct)
    _check(panel_t, avail)
    _lib.check_cuda_tensor("panel_t", panel_t, torch.float32)
    _lib.check_cuda_tensor("avail", avail, torch.float32)
    if not (panel_t.is_contiguous() and avail.is_contiguous()):
        raise ValueError("panel_factor needs contiguous panel_t and avail")
    g, p, npl = panel_t.shape
    if uses_cluster_kernel(p, npl, want_ct):
        entry = "morfem_panel_factor_cluster"
    elif 2 * npl * 4 + 512 <= MAX_SMEM:
        entry = "morfem_panel_factor_cta"
    else:
        raise ValueError(
            f"panel_factor keeps 2*Npl floats in shared memory; Npl={npl} "
            f"does not fit in {MAX_SMEM} bytes"
        )
    fac = torch.empty_like(panel_t)
    ct = torch.empty_like(panel_t) if want_ct else None
    piv = torch.empty((g, p), dtype=torch.int32, device=panel_t.device)
    av_out = torch.empty_like(avail)
    lib = _lib.load()
    lib.call(
        entry, panel_t.data_ptr(), avail.data_ptr(), fac.data_ptr(),
        ct.data_ptr() if want_ct else None, piv.data_ptr(),
        av_out.data_ptr(), g, p, npl, int(want_ct),
        _lib.stream_handle(panel_t),
    )
    panel_factor.launches += 1
    return fac, ct, piv, av_out


panel_factor.launches = 0
