"""Synthetic large-N test systems (NumPy/SciPy, no device).

Port copies of `morfem_tpu/utils/synthetic.py::banded_waveguide_system`
and `banded_waveguide_system_2d`, bit for bit: the same seeds give the
same SciPy matrices in both packages. They stand in for the reference's
~34k-DOF waveguide stress case on the matrix-free route. The rest of that
module (the dense generators) belongs to a later slice of the port.
"""

from __future__ import annotations

import numpy as np


def banded_waveguide_system(
    n: int,
    m: int = 2,
    half: int = 8,
    seed: int = 0,
    length_m: float = 20.0,
):
    """Banded waveguide-like Helmholtz pencil at large N (SciPy sparse).

    The reference's large-N stress case is the rate-10 block-diagonal
    upscale of the bundled waveguide (fake_interpolate_bigger_sample.py:14),
    whose Ct/Tt blobs are absent from the mount; this generator stands in
    with the real structure those matrices have: a BANDED FEM
    discretization whose pencil (C, T) puts hundreds of modes inside the
    3–5 GHz k₀² band — so A(f) = C − k₀²T is strongly indefinite at every
    in-band frequency, the regime where Jacobi-Krylov stagnates and the
    block-tridiagonal direct solver (ops/block_tridiag) is required.

    Base: 1-D P1 FEM stiffness/mass on [0, L] (tridiagonal, h = L/(n+1));
    eigenvalues ≈ (jπ/L)², so L=20 m puts ~270 modes in the band. A small
    banded random symmetric perturbation widens the bandwidth to ``half``
    while keeping C and T safely SPD (Gershgorin margins checked by
    construction). Returns (c, t, wp): SciPy CSR matrices + dense ports.
    Use with the waveguide wave form: a0=c, a2=GAMMA_SCALE·t, t_a2=f².
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    h = length_m / (n + 1)
    # The in-band Helmholtz shift per low mode is ≈ h·k₀² (mass-matrix
    # scale times k₀² ∈ [3.9e3, 1.1e4] over 3–5 GHz). The perturbation and
    # its SPD Gershgorin margin must stay well BELOW that shift or the
    # margin re-definitizes A(f) and the "indefinite" claim is false
    # (a 0.08/h margin ≈ 137 vs a shift ≈ 4.5 did exactly that).
    shift_scale = h * (2 * np.pi * 4e9 / 299792458.0) ** 2  # mid-band
    pert = 0.02 * shift_scale
    margin = 2 * pert * sum(0.5 ** (d - 2) for d in range(2, half + 1))
    main_c = np.full(n, 2.0 / h + margin)
    off_c = np.full(n - 1, -1.0 / h)
    c = sp.diags([off_c, main_c, off_c], [-1, 0, 1], format="lil")
    main_t = np.full(n, 4.0 * h / 6.0)
    off_t = np.full(n - 1, h / 6.0)
    t = sp.diags([off_t, main_t, off_t], [-1, 0, 1], format="lil")
    # banded symmetric perturbations, geometrically damped with offset —
    # total off-diagonal mass stays below the diagonal margin (SPD kept)
    for d in range(2, half + 1):
        vc = rng.uniform(-1.0, 1.0, size=n - d) * pert * 0.5 ** (d - 2)
        c[np.arange(n - d), np.arange(d, n)] = vc
        c[np.arange(d, n), np.arange(n - d)] = vc
        vt = rng.uniform(-1.0, 1.0, size=n - d) * (0.02 * h / 6) * 0.5 ** (
            d - 2
        )
        t[np.arange(n - d), np.arange(d, n)] = vt
        t[np.arange(d, n), np.arange(n - d)] = vt
    wp = np.zeros((n, m))
    nnz = max(8, n // 1000)
    for j in range(m):
        rows = rng.choice(n, size=nnz, replace=False)
        wp[rows, j] = rng.uniform(0.5, 1.0, size=nnz)
    return c.tocsr(), t.tocsr(), wp


def banded_waveguide_system_2d(
    p: int,
    m: int = 2,
    seed: int = 0,
    side_m: float = 0.15,
):
    """2-D P1-FEM waveguide-cross-section Helmholtz pencil (N = p²).

    The reference's ~34k-DOF stress case is an upscaled version of the
    bundled 2-D waveguide FEM problem (fake_interpolate_bigger_sample.py:
    1-34); this generator builds the genuine article instead of a tiling:
    stiffness/mass of a p×p-interior-node square cross-section, Dirichlet
    walls. Row-major node ordering gives a BANDED pattern with
    half-bandwidth p+1 (stiffness: 5-point stencil; mass: 9-point
    tensor-product P1), the structure the RCM-banded matrix-free route
    (ops/block_tridiag.py) exists for.

    Why 2-D for the large-N benchmark and not `banded_waveguide_system`
    (1-D): refining a 1-D mesh at fixed length drives cond(A) ~ n² past
    what an f32 factorization + f64 refinement can recover (measured at
    n=34k/L=1 m: first snapshot stalls at 1e-2 relative residual), while
    shrinking the length to keep cond down packs hundreds of resonances
    into the 3-5 GHz band — more modes than any greedy budget. In 2-D,
    h = L/(p+1) with n = p², so cond(A) ~ 1/h² ~ n: at n≈34k that is
    ~1e5-1e6 (comfortably refinable) with ~10 in-band resonances at
    side_m=0.15 — the same physics regime as the bundled N=3411 problem.

    Returns (c, t, wp): SciPy CSR stiffness/mass + dense ports (a few
    point excitations per port, like WP.npy's 38 nonzeros). Use with the
    wave form a0=c, a2=GAMMA_SCALE·t, t_a2=f²; eigenfrequencies sit at
    k₀² = π²(j²+k²)/side² — ~10 inside the 3-5 GHz band by default.
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    h = side_m / (p + 1)
    # 1-D P1 factors (scale-free stiffness, h-scaled consistent mass);
    # the 2-D P1 tensor-product operators are K⊗M + M⊗K and M⊗M
    k1 = sp.diags(
        [np.full(p - 1, -1.0), np.full(p, 2.0), np.full(p - 1, -1.0)],
        [-1, 0, 1],
    ) / h
    m1 = sp.diags(
        [np.full(p - 1, 1.0), np.full(p, 4.0), np.full(p - 1, 1.0)],
        [-1, 0, 1],
    ) * (h / 6.0)
    c = (sp.kron(k1, m1) + sp.kron(m1, k1)).tocsr()
    t = sp.kron(m1, m1).tocsr()
    n = p * p
    wp = np.zeros((n, m))
    nnz = max(8, n // 1000)
    for j in range(m):
        rows = rng.choice(n, size=nnz, replace=False)
        wp[rows, j] = rng.uniform(0.5, 1.0, size=nnz)
    return c, t, wp
