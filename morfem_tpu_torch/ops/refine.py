"""Iterative refinement around an approximate solver: the port's one rule.

Every adaptively refined solve of the port runs ``r = b − A·x;  x +=
M⁻¹·r`` in the working dtype, M⁻¹ applying a factor in a narrower one,
and stops at its tolerance, when a step fails to cut ‖r‖ by the factor
``stop`` (5 %, or 3 % in the banded solves, as in the reference), or at
the cap: the reference's `lax.while_loop` criterion. `refine` runs it as
a host loop with the caller's residual, apply, tolerance and norm read
(a plain read, one inside a ``"host sync"`` span, or a sum all-reduced
across ranks). `refine_masked` runs it as a masked fixed trip that
synchronises nothing, which a CUDA graph can capture.
"""

from __future__ import annotations

import contextlib
import math

import torch

from morfem_tpu_torch.utils.timing import host_read, span


def host_norm(r: torch.Tensor) -> float:
    """‖r‖ read back to the host, as a ``"host sync"`` span when traced."""
    return host_read(float, torch.linalg.norm(r))


def refine(x, residual, apply, tol: float, cap: int, *, norm,
           stop: float = 0.95, span_name=None):
    """Refine x by ``x += apply(r)``, r = residual(x), while the rule holds.

    Stops when ``norm(r) <= tol``, when a step leaves ``norm(r)`` at or
    above ``stop`` times the last one, or after ``cap`` steps; a NaN
    residual stops it at once. ``norm`` returns a Python float. Under a
    trace-mode `PhaseTimer` each step is a ``span_name`` span when one is
    given. Returns (x, r, norm(r), steps).
    """
    r = residual(x)
    r_norm = norm(r)
    r_prev, steps = math.inf, 0
    while r_norm > tol and r_norm < stop * r_prev and steps < cap:
        with span(span_name) if span_name else contextlib.nullcontext():
            x = x + apply(r)
            r = residual(x)
            r_prev, r_norm = r_norm, norm(r)
        steps += 1
    return x, r, r_norm, steps


def refine_masked(a, b, x0, apply_factor, refine_iterations: int,
                  per_lane: bool):
    """`refine` of ``a @ x = b`` as a masked fixed trip: no host
    synchronisation.

    All `refine_iterations` iterations run; each one's update is kept
    only where the reference's `lax.while_loop` condition still holds
    (``r_norm > tol``, ``r_norm < 0.95·r_prev``), decided on the device
    with `torch.where`; the trip count is the loop's cap. Once the
    condition fails the state is frozen, so x is the while-loop's x bit
    for bit. ``per_lane``: each
    [N, M] system of a batch [..., N, M] stops on its own norms and its
    own tol (the reference's rule under `vmap`); else one norm over the
    whole batch.
    """
    work = torch.promote_types(a.dtype, b.dtype)
    a_w = a.to(work)
    b_w = b.to(work)

    def norm(v):
        if per_lane:
            return torch.linalg.norm(v, dim=(-2, -1))
        return torch.linalg.norm(v)

    tol = 10 * torch.finfo(work).eps * norm(b_w)
    x = x0
    r = b_w - a_w @ x
    r_norm = norm(r)
    r_prev = torch.full_like(r_norm, float("inf"))
    for _ in range(refine_iterations):
        go = (r_norm > tol) & (r_norm < 0.95 * r_prev)
        x_new = x + apply_factor(r)
        r_new = b_w - a_w @ x_new
        go_v = go[..., None, None] if per_lane else go
        x = torch.where(go_v, x_new, x)
        r = torch.where(go_v, r_new, r)
        r_prev = torch.where(go, r_norm, r_prev)
        r_norm = torch.where(go, norm(r_new), r_norm)
    return x
