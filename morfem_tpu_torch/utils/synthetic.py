"""Synthetic test systems.

Counterpart of `morfem_tpu/utils/synthetic.py`. The two banded large-N
generators (`banded_waveguide_system`, `banded_waveguide_system_2d`) are
NumPy/SciPy copies, bit for bit: the same seeds give the same SciPy
matrices in both packages. They stand in for the reference's ~34k-DOF
waveguide stress case on the matrix-free route.

The dense generators (`diagonal_heavy_matrix`, `random_affine_system`,
`waveguide_like_system`) return tensors on a device. The JAX package keys
them on `jax.random`, whose streams PyTorch cannot reproduce, so here they
take a ``seed`` (an int or a `torch.Generator`; draws are made on the CPU,
so one seed gives the same matrices on every device) and keep each
generator's documented properties, not its numbers. Parity tests feed one
package's arrays to both pipelines.
"""

from __future__ import annotations

import numpy as np
import torch

from morfem_tpu_torch.device import resolve_device


def _generator(seed) -> torch.Generator:
    """A CPU `torch.Generator` from an int seed (or the generator given)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def diagonal_heavy_matrix(
    seed,
    size: int,
    max_abs_value: float = 10.0,
    density: float = 0.5,
    dtype=torch.float64,
    device="cuda",
) -> torch.Tensor:
    """Random matrix with nonzeros concentrated around the diagonal.

    The probability that the d-th off-diagonal is populated decays
    geometrically with |d|, and populated diagonals are scaled by the same
    decaying factor (one keep/drop draw per diagonal offset, as the
    reference's per-diagonal coin flip); the main diagonal is always kept
    at weight 1. Values are uniform in ±max_abs_value before scaling.
    """
    g = _generator(seed)
    density = float(min(max(density, 0.0), 1.0))
    i = np.arange(size)
    dist = np.abs(i[:, None] - i[None, :])
    band = np.geomspace(1.0, 1.0 + density, num=max(size, 2)) - 1.0
    decay = np.where(dist == 0, 1.0,
                     band[np.clip(size - 1 - dist, 0, size - 1)])
    decay = torch.from_numpy(decay)
    vals = (torch.rand((size, size), generator=g, dtype=torch.float64) * 2
            - 1) * max_abs_value
    keep_band = torch.rand(size, generator=g, dtype=torch.float64)
    keep = keep_band[torch.from_numpy(dist)] <= decay
    out = vals * decay * keep.to(torch.float64)
    return out.to(device=resolve_device(device), dtype=dtype)


def random_affine_system(
    seed,
    n: int = 64,
    m: int = 2,
    num_points: int = 32,
    t_lo: float = 3.0,
    t_hi: float = 5.0,
    dtype=torch.float64,
    symmetric: bool = True,
    device="cuda",
):
    """A well-posed random parametric affine system for tests:
    (domain, a0, a1, a2, b) with A(t) = a0 + t·a1 + t²·a2 safely invertible
    over [t_lo, t_hi] (a0 carries a diagonal shift of 2 + t_hi², and the
    random parts have entries of scale 1/n)."""
    g = _generator(seed)
    f64 = torch.float64

    def mat():
        a = torch.randn((n, n), generator=g, dtype=f64) / n
        return (a + a.T) * 0.5 if symmetric else a

    a0 = mat() + torch.eye(n, dtype=f64) * (2.0 + t_hi**2)
    a1 = mat()
    a2 = mat()
    b = torch.randn((n, m), generator=g, dtype=f64)
    domain = torch.linspace(t_lo, t_hi, num_points, dtype=f64)
    dev = resolve_device(device)
    return tuple(x.to(device=dev, dtype=dtype)
                 for x in (domain, a0, a1, a2, b))


def waveguide_like_system(
    seed,
    n: int = 512,
    m: int = 2,
    num_points: int = 100,
    f_lo: float = 3e9,
    f_hi: float = 5e9,
    n_inband: int = 12,
    dtype=torch.float64,
    device="cuda",
):
    """Synthetic stand-in for the bundled waveguide: (domain, C, Γ, B).

    The pencil's spectrum is set exactly, as in the reference: C = R·VΛVᵀ·Rᵀ
    and T = R·Rᵀ with V orthogonal and R = I + 0.3·G/√n, so the (C, T)
    eigenvalues are Λ: ``n_inband`` of them uniform in the band's
    (2πf/c)² range (each at least a third of a grid spacing from every
    sample point), ~4 % below it, the rest log-spaced up to 60× above it.
    Γ = −(2π/c)²·T, for the wave form C + f²·Γ. B has a few entries in
    [0.5, 1] per port column. Use as a0 = C, a1 = 0, a2 = Γ.
    """
    from scipy.constants import c as c_lightspeed

    g = _generator(seed)
    f64 = torch.float64
    host = np.random.default_rng(
        int(torch.randint(0, 2**62, (1,), generator=g)))
    k_lo2 = (2 * np.pi * f_lo / c_lightspeed) ** 2
    k_hi2 = (2 * np.pi * f_hi / c_lightspeed) ** 2
    n_low = max(1, n // 25)
    n_high = n - n_inband - n_low
    lam_in = host.uniform(k_lo2 * 1.02, k_hi2 * 0.98, size=n_inband)
    grid_k2 = (
        2 * np.pi * np.linspace(f_lo, f_hi, num_points) / c_lightspeed
    ) ** 2
    spacing = np.min(np.diff(grid_k2))
    for _ in range(4):
        d = np.abs(lam_in[:, None] - grid_k2[None, :]).min(axis=1)
        lam_in = np.where(d < spacing / 3, lam_in + spacing / 2, lam_in)
    lam_low = host.uniform(0.15 * k_lo2, 0.75 * k_lo2, size=n_low)
    lam_high = np.exp(
        host.uniform(np.log(1.15 * k_hi2), np.log(60 * k_hi2), size=n_high)
    )
    lam = torch.from_numpy(
        np.sort(np.concatenate([lam_low, lam_in, lam_high])))
    v, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=f64))
    r = torch.eye(n, dtype=f64) + 0.3 * torch.randn(
        (n, n), generator=g, dtype=f64) / np.sqrt(n)
    c_mat = r @ ((v * lam[None, :]) @ v.T) @ r.T
    t_mat = r @ r.T
    c_mat = (c_mat + c_mat.T) * 0.5
    t_mat = (t_mat + t_mat.T) * 0.5
    nnz = max(4, n // 64)
    b = np.zeros((n, m))
    for j in range(m):
        rows = host.choice(n, size=nnz, replace=False)
        b[rows, j] = host.uniform(0.5, 1.0, size=nnz)
    gamma = -t_mat * ((2 * np.pi / c_lightspeed) ** 2)
    domain = torch.linspace(f_lo, f_hi, num_points, dtype=f64)
    dev = resolve_device(device)
    return tuple(x.to(device=dev, dtype=dtype)
                 for x in (domain, c_mat, gamma, torch.from_numpy(b)))


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
