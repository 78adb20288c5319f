"""The port's banded operators and block-tridiagonal solver against the JAX
package (kernel K5's plain version, the blocked wide-band matvec, block
Thomas, the banded direct solve, RCM and the shifted GMRES escalation).

On the CPU the K5 wrapper runs its plain PyTorch version; the JAX kernel
runs in interpret mode. Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from morfem_tpu.ops import block_tridiag as jbt
from morfem_tpu.ops.pallas import banded_matvec as jbm

from morfem_tpu_torch.ops import banded_matvec as tbm
from morfem_tpu_torch.ops import block_tridiag as tbt
from morfem_tpu_torch.ops.kernels import (
    banded_matvec_padded,
    banded_matvec_padded_plain,
    launch_counts,
    reset_launch_counts,
)
from morfem_tpu_torch.ops.kernels.banded_matvec import bind_banded_matvec
from morfem_tpu_torch.utils.synthetic import banded_waveguide_system

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _banded_pencil(n=300, half=6, seed=0, shift=12.0):
    """Diagonally dominant banded pencil (a0, 0, a2) as SciPy CSR."""
    rng = np.random.default_rng(seed)

    def band(scale, s):
        diags = [rng.normal(size=n - abs(d)) * scale / (1 + abs(d))
                 for d in range(-half, half + 1)]
        a = sp.diags(diags, offsets=range(-half, half + 1)).tocsr()
        return (a + a.T) * 0.5 + sp.eye(n) * s

    return band(1.0, shift), sp.csr_matrix((n, n)), band(0.3, 0.0)


@pytest.mark.parametrize("sparse_input", [True, False])
def test_to_banded_and_pad_band_match(sparse_input):
    a0, _, _ = _banded_pencil(n=70, half=4, seed=1)
    a = a0 if sparse_input else a0.toarray()
    band_t, half_t = tbm.to_banded(a)
    band_j, half_j = jbm.to_banded(a)
    assert half_t == half_j == 4
    np.testing.assert_array_equal(band_t, band_j)
    trunc_t, _ = tbm.to_banded(a, bandwidth=2)
    np.testing.assert_array_equal(trunc_t, jbm.to_banded(a, bandwidth=2)[0])
    padded = tbm.pad_band(torch.from_numpy(band_t), tile=32)
    np.testing.assert_array_equal(
        _np(padded), np.asarray(jbm.pad_band(jnp.asarray(band_t), tile=32)))


@pytest.mark.parametrize("n,half,m", [(1000, 6, 2), (333, 6, 1), (90, 0, 3)])
def test_banded_matvec_plain_matches_pallas(n, half, m):
    # N not a multiple of the reference's 256-row tile
    rng = np.random.default_rng(n + half)
    band = rng.standard_normal((n, 2 * half + 1)).astype(np.float32)
    x = rng.standard_normal((n, m))
    ref = np.asarray(jbm.banded_matvec(jnp.asarray(band), half,
                                       jnp.asarray(x), interpret=True))
    reset_launch_counts()
    got = _np(tbm.banded_matvec(torch.from_numpy(band), half,
                                torch.from_numpy(x)))
    assert launch_counts()["banded_matvec_padded"] == 0  # CPU: plain
    assert got.dtype == np.float32
    # f32 sums of 2·half+1 products in the same diagonal order; the
    # reference's compiled loop may contract products into FMAs:
    # 1e-6 of Σ|band|·|x|
    scale = np.abs(band).sum(axis=1).max() * np.abs(x).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale


def test_banded_matvec_padded_takes_padded_and_plain_layouts():
    rng = np.random.default_rng(3)
    band = torch.from_numpy(rng.standard_normal((77, 5)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((77, 2)))
    direct = banded_matvec_padded(band, 77, 5, 2, x)
    padded = banded_matvec_padded(tbm.pad_band(band, 64), 77, 5, 2, x)
    assert torch.equal(direct, padded)
    with pytest.raises(ValueError):
        banded_matvec_padded(band, 77, 5, 1, x)  # bw != 2·half+1


@pytest.mark.parametrize("x_dtype", [torch.float64, torch.float32])
def test_banded_matvec_out_dtype_is_the_cast_of_the_f32_result(x_dtype):
    # out_dtype=float64 is the old `.to(torch.float64)` after the f32
    # matvec, bit for bit; the bound closure gives the same
    rng = np.random.default_rng(11)
    n, half = 333, 6
    band = torch.from_numpy(rng.standard_normal((n, 13)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, 3))).to(x_dtype)
    f32 = banded_matvec_padded_plain(band, n, 13, half, x)
    assert f32.dtype == torch.float32
    for out in (torch.float64, torch.float32):
        got = banded_matvec_padded_plain(band, n, 13, half, x,
                                         out_dtype=out)
        assert got.dtype == out and torch.equal(got, f32.to(out))
        bound = bind_banded_matvec(band, n, 13, half)
        assert torch.equal(bound(x, out), got)
        if out == x_dtype:  # by default the closure writes x's type
            assert torch.equal(bound(x), got)
        assert torch.equal(banded_matvec_padded(band, n, 13, half, x, out),
                           got)
    with pytest.raises(ValueError):
        banded_matvec_padded_plain(band, n, 13, half, x,
                                   out_dtype=torch.float16)
    with pytest.raises(ValueError):
        bind_banded_matvec(band, n, 13, half)(x[:-1])  # wrong N
    with pytest.raises(ValueError):
        bind_banded_matvec(band, n, 13, 5)  # bw != 2·half+1


def test_wide_band_blocked_matvec_matches():
    # bw = 2·60+1 = 121 > WIDE_BW: both packages take the blocked form
    rng = np.random.default_rng(5)
    n, half = 500, 60
    band = rng.standard_normal((n, 2 * half + 1))
    x = rng.standard_normal((n, 2))
    ref = np.asarray(jbm.banded_matvec_blocked(jnp.asarray(band), half,
                                               jnp.asarray(x)))
    got = _np(tbm.banded_matvec_blocked(torch.from_numpy(band), half,
                                        torch.from_numpy(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    ref_t = _np(tbm.banded_matvec_ref(torch.from_numpy(band), half,
                                      torch.from_numpy(x)))
    np.testing.assert_array_equal(ref_t, got)  # wide: ref = blocked
    a = np.zeros((n, n))
    for d in range(-half, half + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        a[rows, rows + d] = band[rows, d + half]
    np.testing.assert_allclose(got, a @ x, atol=1e-11 * np.abs(a @ x).max())


@pytest.mark.parametrize("x_dtype", [np.float64, np.float32])
def test_operator_bind_routes_like_the_reference(x_dtype):
    a0, a1, a2 = _banded_pencil(n=200, half=6, seed=2)
    op_t = tbm.BandedAffineOperator(a0, a1, a2, device=CPU)
    op_j = jbm.BandedAffineOperator(a0, a1, a2)
    assert (op_t.half, op_t.bw, op_t.n_addends) == (op_j.half, op_j.bw, 3)
    np.testing.assert_array_equal(_np(op_t.bands_w), np.asarray(op_j.bands_w))
    c = np.array([1.0, 0.0, 2.3])
    x = np.random.default_rng(0).standard_normal((200, 2))
    # K5 reads x in its own type and writes y in it (out_dtype=x.dtype)
    fast_t = _np(op_t.bind(torch.from_numpy(c))(
        torch.from_numpy(x.astype(x_dtype))))
    fast_j = np.asarray(op_j.bind(jnp.asarray(c))(jnp.asarray(x)))
    assert fast_t.dtype == x_dtype
    assert np.abs(fast_t - fast_j).max() <= 1e-5 * np.abs(fast_j).max()
    # a 1-D x keeps its shape
    fast_1 = _np(op_t.bind(torch.from_numpy(c))(
        torch.from_numpy(x[:, 1].astype(x_dtype))))
    np.testing.assert_array_equal(fast_1, fast_t[:, 1])
    prec_t = _np(op_t.bind_precise(torch.from_numpy(c))(torch.from_numpy(x)))
    dense = (a0 + 2.3 * a2).toarray()
    np.testing.assert_allclose(prec_t, dense @ x, rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(_np(op_t.diagonal(torch.from_numpy(c))),
                               np.diag(dense), rtol=1e-15)
    np.testing.assert_allclose(_np(op_t.apply_addend(2, torch.from_numpy(x))),
                               a2.toarray() @ x, rtol=1e-13, atol=1e-13)


def test_band_to_blocks_and_block_thomas_match():
    a0, a1, a2 = _banded_pencil(n=300, half=6, seed=3)
    op = tbm.BandedAffineOperator(a0, a1, a2, device=CPU)
    c = torch.tensor([1.0, 0.0, 1.7], dtype=torch.float64)
    band = tbm.combine_addends(c, op.bands_w)
    l, d, u = tbt.band_to_blocks(band, op.half, 128)
    lj, dj, uj = jbt.band_to_blocks(jnp.asarray(_np(band)), op.half, 128)
    for a, b in ((l, lj), (d, dj), (u, uj)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    fac = tbt.block_tridiag_factor(l, d, u, op.n)
    fac_j = jbt.block_tridiag_factor(lj, dj, uj, op.n)
    rhs = np.random.default_rng(1).standard_normal((300, 2))
    x = _np(tbt.block_tridiag_apply(fac, torch.from_numpy(rhs)))
    xj = np.asarray(jbt.block_tridiag_apply(fac_j, jnp.asarray(rhs)))
    assert x.dtype == np.float32
    # f32 factors: both are f32 solves of the same system (cond ≈ 10)
    assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max()
    dense = (a0 + 1.7 * a2).toarray()
    ref = np.linalg.solve(dense, rhs)
    assert np.abs(x - ref).max() <= 1e-5 * np.abs(ref).max()


def _tiled_pencil(tiles=17, tile=45, seed=7):
    """Dense symmetric tiles on a block diagonal (a0, 0, a2): the
    tiled-waveguide structure at a small size."""
    rng = np.random.default_rng(seed)

    def tiled(scale, shift):
        mats = []
        for _ in range(tiles):
            a = rng.standard_normal((tile, tile)) * scale / np.sqrt(tile)
            mats.append((a + a.T) * 0.5 + np.eye(tile) * shift)
        return sp.block_diag(mats, format="csr")

    n = tiles * tile
    return tiled(1.0, 3.0), sp.csr_matrix((n, n)), tiled(0.3, 0.0)


def _full_product_factor(l, d, u):
    """Block Thomas with every coupling product over all b rows and
    columns, as the factor was first written."""
    g, h = torch.empty_like(d), torch.empty_like(d)
    for i in range(d.shape[0]):
        s = d[i] if i == 0 else d[i] - l[i] @ (g[i - 1] @ u[i - 1])
        g[i] = torch.linalg.inv_ex(s)[0]
        h[i] = g[i] @ u[i]
    return g, h


# tiled: tiles of 45 factored in blocks of 48, so U_i's nonzero rows are
# the last 3(i+1) mod 45 (U_14 is empty, U_15 lies outside the matrix)
# and the share kept is 2·3·(1+…+14) / (2·15·48) = 0.4375; lower: two
# entries more, unsymmetrised, so L_3's column set holds an index that
# U_2's row set lacks and S_2⁻¹ couples it to them; full: blocks of the
# half-bandwidth, so every coupling block is full
@pytest.mark.parametrize("case,block,share", [("tiled", 48, 0.4375),
                                              ("lower", 48, 631 / 1440),
                                              ("full", 6, 1.0)])
def test_block_thomas_forms_coupling_products_over_nonzero_rows(
        case, block, share):
    if case == "full":
        a0, a1, a2 = _banded_pencil(n=300, half=6, seed=8, shift=2.0)
    else:
        a0, a1, a2 = _tiled_pencil()
    if case == "lower":  # L_3's column 14; D_2's (14, 44) joins tiles
        a0 = a0.tolil()
        a0[150, 110] = a0[110, 140] = 0.5
        a0 = a0.tocsr()
    n = a0.shape[0]
    sym = case != "lower"
    op = tbm.BandedAffineOperator(a0, a1, a2, symmetrize=sym, device=CPU)
    c = np.array([1.0, 0.0, -1.1])
    band = tbm.combine_addends(torch.from_numpy(c), op.bands_w)
    l, d, u = tbt.band_to_blocks(band, op.half, block)
    tbt.reset_factor_counters()
    fac = tbt.block_tridiag_factor(l, d, u, n)
    assert tbt.block_tridiag_factor.coupling_share == [share]
    tbt.reset_factor_counters()
    assert tbt.block_tridiag_factor.coupling_share == []
    f32 = torch.float32
    g0, h0 = _full_product_factor(l.to(f32), d.to(f32), u.to(f32))
    if case == "full":  # the plain products, in the same order: same bits
        assert torch.equal(fac.g, g0) and torch.equal(fac.h, h0)
    else:  # only exact zeros are left out of the sums: f32 rounding
        for got, want in ((fac.g, g0), (fac.h, h0)):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        assert not fac.h[14].any() and not fac.h[-1].any()
    rhs = np.random.default_rng(5).standard_normal((n, 2))
    x = _np(tbt.block_tridiag_apply(fac, torch.from_numpy(rhs)))
    x0 = _np(tbt.block_tridiag_apply(fac._replace(g=g0, h=h0),
                                     torch.from_numpy(rhs)))
    assert np.abs(x - x0).max() <= 1e-5 * np.abs(x0).max()
    lj, dj, uj = jbt.band_to_blocks(jnp.asarray(_np(band)), op.half, block)
    fac_j = jbt.block_tridiag_factor(lj, dj, uj, n)
    xj = np.asarray(jbt.block_tridiag_apply(fac_j, jnp.asarray(rhs)))
    assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max()
    a = (a0 - 1.1 * a2).toarray()
    ref = np.linalg.solve((a + a.T) / 2 if sym else a, rhs)
    assert np.abs(x - ref).max() <= 1e-5 * np.abs(ref).max()
    x_r, relres, _ = tbt.banded_direct_solve(
        op, torch.from_numpy(c), torch.from_numpy(rhs), block=block)
    assert float(relres.max()) < 1e-13
    assert np.abs(_np(x_r) - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("coupled", [False, True])
def test_singular_schur_complement_factors_to_non_finite(coupled):
    # no raise: the refinement's residual turns NaN and callers escalate
    d = torch.eye(8, dtype=torch.float64).repeat(2, 1, 1)
    d[0, 7, 7] = 0.0
    l, u = torch.zeros_like(d), torch.zeros_like(d)
    if coupled:  # S_1 = D_1 − L_1·S_0⁻¹·U_0 over one row and column
        u[0, 7, 0] = l[1, 0, 7] = 0.5
    fac = tbt.block_tridiag_factor(l, d, u, 16)
    assert not bool(torch.isfinite(fac.g[0]).all())
    # decoupled, the second block stays finite; coupled, it is poisoned
    assert bool(torch.isfinite(fac.g[1]).all()) != coupled
    x = tbt.block_tridiag_apply(fac, torch.ones((16, 1), dtype=torch.float64))
    assert not bool(torch.isfinite(x).all())


@pytest.fixture(scope="module")
def tiled_blocks():
    """f32 blocks [3, nb, 256, 256] and N of the synthesized waveguide
    (N=250) tiled 10×, at 3 points of 3–5 GHz: blocks of 256 straddle the
    tiles, so the coupling blocks are nonzero."""
    from morfem_tpu_torch import MorfemConfig
    from morfem_tpu_torch.apps import waveguide as wg

    c, t, wp = wg.synthesize_waveguide(250)
    wp = wg.calibrate_port_amplitude(c, t, wp)
    data = wg.WaveguideData(c, t, wp, wg.KTE_DEFAULT, True)
    sys_ = wg.tiled_waveguide_system(
        np.linspace(3e9, 5e9, 13)[[0, 5, 12]], data, 10,
        MorfemConfig(band_max_half=256), device=CPU)
    coef, _ = sys_.coefficients(sys_.domain)
    return sys_.op.blocks(coef.to(sys_.b.dtype), 256), sys_.op.n


def _frobenius_rel(a, b):
    """‖a − b‖_F / ‖b‖_F of each matrix of [..., b, b], in float64."""
    a, b = a.double(), b.double()
    return (torch.linalg.norm(a - b, dim=(-2, -1))
            / torch.linalg.norm(b, dim=(-2, -1)))


def test_the_batched_route_matches_a_factor_of_inv_ex_inverses(
        monkeypatch, tiled_blocks):
    """A step of 3 points inverts its Schur complements together
    (`_invert_points`: the panel LU, then two substitutions). Each S⁻¹,
    against the float64 inverse (`chip_smoke.inverse_quality`), is off by
    at most 0.02·κ_F(S)·ε relative to its norm (κ_F = ‖S‖_F·‖S⁻¹‖_F,
    1.9e4–6.4e7 on these blocks; measured ≤ 0.0093·κ_F·ε), and each
    128-wide column panel of S·X − I and row panel of X·S − I stays
    within 4× `inv_ex`'s largest (measured ≤ 2.4×; a panel of X left
    wrong reads about 1 there). Against the same factor with each
    complement inverted by `inv_ex`: both are f32 inverses by
    backward-stable LUs with other pivots and sums, each off the exact
    S⁻¹ by c·κ_F·ε, so the routes' g differ by at most κ_F·ε/8, and the
    products of g (h, the apply) with an f32-true rounding of their own
    on top."""
    import chip_smoke as cs

    (l, d, u), n = tiled_blocks
    assert d.shape[0] == 3 >= tbt.POINTS_TO_BATCH
    tbt.reset_factor_counters()
    fac = tbt.block_tridiag_factor(l, d, u, n)
    nb = d.shape[1]
    assert tbt.block_tridiag_factor.batched_inverses == [3] * nb
    assert tbt.block_tridiag_factor.coupling_share[0] < 1.0
    assert fac.h[:, :-1].abs().amax(dim=(-2, -1)).min() > 0  # coupled
    _, cols = tbt._coupling_sets(l, u)
    s = torch.stack([tbt._schur_complement(l, d, fac.h, cols, i)
                     for i in range(nb)], dim=1)  # [3, nb, b, b]
    eps = torch.finfo(torch.float32).eps
    for i in range(nb):
        got, each = cs.inverse_quality(
            s[:, i], (fac.g[:, i], tbt._inverse_each(s[:, i])))
        assert bool((got["err"] <= 0.02 * got["kappa"] * eps).all())
        assert bool((got["right"] <= 4 * each["right"]).all())
        assert bool((got["left"] <= 4 * each["left"]).all())
    monkeypatch.setattr(tbt, "_invert_points", tbt._inverse_each)
    ref = tbt.block_tridiag_factor(l, d, u, n)
    kappa = (torch.linalg.norm(s.double(), dim=(-2, -1))
             * torch.linalg.norm(ref.g.double(), dim=(-2, -1)))
    limit = kappa * eps / 8
    assert bool((_frobenius_rel(fac.g, ref.g) <= limit).all())
    live = ref.h.abs().amax(dim=(-2, -1)) > 0  # h of the last block is 0
    assert bool((_frobenius_rel(fac.h, ref.h)[live] <= limit[live]).all())
    rhs = torch.from_numpy(
        np.random.default_rng(9).standard_normal((3, n, 2)))
    x = tbt.block_tridiag_apply(fac, rhs)
    x_ref = tbt.block_tridiag_apply(ref, rhs)
    assert bool((_frobenius_rel(x, x_ref) <= limit.amax(dim=1)).all())


def _inv_ex_factor(l, d, u):
    """The single-point block-Thomas factor written out with `inv_ex` and
    the coupling sets: g and h."""
    rows, cols = tbt._coupling_sets(l, u)
    g, h = torch.empty_like(d), torch.empty_like(d)
    for i in range(d.shape[-3]):
        c, r = cols[i], rows[i]
        s = d[i] if i == 0 or not c.numel() else (
            d[i] - tbt._product_over(l[i], h[i - 1], c))
        g[i] = torch.linalg.inv_ex(s)[0]
        h[i] = tbt._product_over(g[i], u[i], r) if r.numel() else 0.0
    return g, h


@pytest.mark.parametrize("point_axis", [False, True])
def test_blocks_of_one_point_keep_inv_ex(tiled_blocks, point_axis):
    """[nb, b, b] blocks, and a point axis of one point (below
    ``POINTS_TO_BATCH``), invert each Schur complement by `inv_ex`, bit
    for bit, and invert nothing together."""
    (l, d, u), n = tiled_blocks
    one = [x[1:2] if point_axis else x[1] for x in (l, d, u)]
    tbt.reset_factor_counters()
    fac = tbt.block_tridiag_factor(*one, n)
    assert tbt.block_tridiag_factor.batched_inverses == []
    g, h = _inv_ex_factor(l[1], d[1], u[1])
    shape = fac.g.shape
    assert torch.equal(fac.g, g.reshape(shape))
    assert torch.equal(fac.h, h.reshape(shape))


@pytest.mark.parametrize("coupled", [False, True])
def test_a_singular_schur_complement_poisons_its_point_alone(coupled):
    """Three points a step, the middle one's first Schur complement
    exactly singular: its g turns non-finite (from that block on, where
    the blocks are coupled), the other points' stay finite."""
    b = 256
    d = torch.eye(b, dtype=torch.float64).repeat(3, 2, 1, 1)
    d[1, 0, b - 1, b - 1] = 0.0
    l, u = torch.zeros_like(d), torch.zeros_like(d)
    if coupled:
        u[:, 0, b - 1, 0] = l[:, 1, 0, b - 1] = 0.5
    tbt.reset_factor_counters()
    fac = tbt.block_tridiag_factor(l, d, u, 2 * b)
    assert tbt.block_tridiag_factor.batched_inverses == [3, 3]
    finite = torch.isfinite(fac.g).all(dim=(-2, -1))
    assert finite.tolist() == [[True, True], [False, not coupled],
                               [True, True]]
    x = tbt.block_tridiag_apply(fac, torch.ones((3, 2 * b, 1)))
    assert torch.isfinite(x).all(dim=(1, 2)).tolist() == [True, False, True]


def test_banded_direct_solve_matches():
    a0, a1, a2 = _banded_pencil(n=300, half=6, seed=4, shift=2.0)
    op_t = tbm.BandedAffineOperator(a0, a1, a2, device=CPU)
    op_j = jbm.BandedAffineOperator(a0, a1, a2)
    c = np.array([1.0, 0.0, -1.1])
    rhs = np.random.default_rng(2).standard_normal((300, 2))
    x, relres, it = tbt.banded_direct_solve(op_t, torch.from_numpy(c),
                                            torch.from_numpy(rhs))
    xj, relres_j, it_j = jbt.banded_direct_solve(op_j, jnp.asarray(c),
                                                 jnp.asarray(rhs))
    ref = np.linalg.solve((a0 - 1.1 * a2).toarray(), rhs)
    assert np.abs(_np(x) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(_np(x) - np.asarray(xj)).max() <= 1e-12 * np.abs(ref).max()
    assert float(relres.max()) < 1e-13
    # the refinement takes the same number of steps (±1: f32 factors)
    assert abs(it - int(it_j)) <= 1
    # cyclic reduction is ported: the same solution within 1e-12
    x_cr, relres_cr, _ = tbt.banded_direct_solve(
        op_t, torch.from_numpy(c), torch.from_numpy(rhs), factorization="cr")
    assert np.abs(_np(x_cr) - ref).max() <= 1e-12 * np.abs(ref).max()
    assert float(relres_cr.max()) < 1e-13


def test_banded_via_rcm_gives_the_reference_permutation():
    n = 400
    c, t, wp = banded_waveguide_system(n, half=5, seed=0)
    scram = np.random.default_rng(3).permutation(n)
    cs = c.tocsr()[scram][:, scram]
    ts = t.tocsr()[scram][:, scram]
    zero = sp.csr_matrix((n, n))
    op_t, perm_t = tbt.banded_via_rcm(cs, zero, ts, device=CPU)
    op_j, perm_j = jbt.banded_via_rcm(cs, zero, ts)
    np.testing.assert_array_equal(_np(perm_t), np.asarray(perm_j))
    assert op_t.half == op_j.half <= 10
    np.testing.assert_array_equal(_np(op_t.bands_w), np.asarray(op_j.bands_w))
    with pytest.raises(tbt.BandwidthError):
        tbt.banded_via_rcm(cs, zero, ts, max_half=2, device=CPU)
    # the one-call form un-permutes
    cc = np.array([1.0, 0.0, -2.0])
    rhs = wp
    x, relres, _ = tbt.rcm_direct_solve(cs, zero, ts, cc, rhs, device=CPU)
    a = (cs - 2.0 * ts).toarray()
    a = (a + a.T) / 2
    ref = np.linalg.solve(a, rhs)
    assert np.abs(_np(x) - ref).max() <= 1e-10 * np.abs(ref).max()


def test_shifted_gmres_solve_matches():
    # an indefinite banded pencil: the σ-shifted block factorization
    # preconditions exact GMRES
    a0, a1, a2 = _banded_pencil(n=256, half=5, seed=6, shift=0.5)
    op_t = tbm.BandedAffineOperator(a0, a1, a2, device=CPU)
    op_j = jbm.BandedAffineOperator(a0, a1, a2)
    c = np.array([1.0, 0.0, 1.0])
    rhs = np.random.default_rng(4).standard_normal((256, 2))
    x, relres = tbt.shifted_gmres_solve(op_t, torch.from_numpy(c),
                                        torch.from_numpy(rhs), maxiter=10)
    xj, relres_j = jbt.shifted_gmres_solve(op_j, jnp.asarray(c),
                                           jnp.asarray(rhs), maxiter=10)
    ref = np.linalg.solve((a0 + a2).toarray(), rhs)
    assert float(relres.max()) < 1e-10
    assert np.abs(_np(x) - ref).max() <= 1e-8 * np.abs(ref).max()
    assert np.abs(_np(x) - np.asarray(xj)).max() <= 1e-8 * np.abs(ref).max()
    # the preconditioner itself: Re((A − iσs)⁻¹ r) against a dense solve
    prec, _ = tbt.shifted_block_precond(op_t, torch.from_numpy(c), sigma=1e-2)
    a = (a0 + a2).toarray()
    s = 1e-2 * np.abs(np.diag(a)).max()
    want = np.linalg.solve(a - 1j * s * np.eye(256), rhs).real
    got = _np(prec(torch.from_numpy(rhs)))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
