"""The port's block-sparse (kernel K6), ELL and general-sparsity operators
against the JAX package.

On the CPU the K6 wrapper runs its plain PyTorch version; the JAX kernel
`bsr_matmul_pallas` runs in interpret mode, as the JAX package's own tests
run it. Inputs are made with numpy from fixed seeds and fed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from morfem_tpu.ops import block_sparse as jbs
from morfem_tpu.ops import block_tridiag as jbt
from morfem_tpu.ops import ell as jell

from morfem_tpu_torch.ops import block_sparse as tbs
from morfem_tpu_torch.ops import block_tridiag as tbt
from morfem_tpu_torch.ops import ell as tell
from morfem_tpu_torch.ops.kernels import (
    bsr_matmul_f32,
    bsr_matmul_f32_plain,
    launch_counts,
    reset_launch_counts,
)
from morfem_tpu_torch.ops.kernels.block_sparse import (
    SECTOR_WIDTH,
    bsr_pack_sectors,
    pack_sectors,
    sector_matmul_plain,
)
from morfem_tpu_torch.ops.sparse import SparseAffineOperator

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


def _random_sparse(n, rng, density=0.01, scatter=0.2, half=40):
    """Banded-ish sparsity plus a scattered off-band remainder (the JAX
    package's own block-sparse fixture)."""
    nnz_band = int(n * n * density * (1 - scatter))
    r = rng.integers(0, n, nnz_band)
    c = np.clip(r + rng.integers(-half, half + 1, nnz_band), 0, n - 1)
    nnz_far = int(n * n * density * scatter)
    rows = np.concatenate([r, rng.integers(0, n, nnz_far)])
    cols = np.concatenate([c, rng.integers(0, n, nnz_far)])
    vals = rng.standard_normal(rows.size)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return a + sp.eye(n) * (2.0 * half * density * n + 1.0)


def _scattered_pencil(n=350, seed=0, nfar=80):
    """Diagonal + weak scattered couplings: BSR blocks it worst, ELL best."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(3):
        far = sp.coo_matrix(
            (0.05 * rng.standard_normal(nfar),
             (rng.integers(0, n, nfar), rng.integers(0, n, nfar))),
            shape=(n, n))
        mats.append((sp.diags(4.0 + rng.random(n)) + far + far.T).tocsr())
    return mats, rng


def test_bsr_from_scipy_matches():
    rng = np.random.default_rng(0)
    n = 300
    mats = [_random_sparse(n, rng) for _ in range(3)]
    got = tbs.bsr_from_scipy(mats, n)
    ref = jbs.bsr_from_scipy(mats, n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _empty_rows_matrix(n, rng):
    a = sp.lil_matrix((n, n))
    for i in list(range(0, 64)) + list(range(128, n)):
        a[i, rng.integers(0, n)] = rng.standard_normal()
    return a.tocsr()


@pytest.mark.parametrize("case", ["random", "empty_block_rows", "vector"])
def test_bsr_kernel_plain_matches_pallas(case):
    rng = np.random.default_rng(1)
    n = 260
    a = _empty_rows_matrix(n, rng) if case == "empty_block_rows" else (
        _random_sparse(n, rng))
    vals, brows, bcols, nbr, nbc = tbs.bsr_from_scipy([a], n)
    x = rng.standard_normal(n) if case == "vector" else (
        rng.standard_normal((n, 2)))
    vals2d = vals[0].astype(np.float32).reshape(-1, 128)
    ref = np.asarray(jbs.bsr_matmul_pallas(
        jnp.asarray(vals2d), jnp.asarray(brows), jnp.asarray(bcols), nbr, nbc,
        n, 32, 128, jnp.asarray(x), interpret=True))
    reset_launch_counts()
    got = _np(bsr_matmul_f32(
        torch.from_numpy(vals2d), torch.from_numpy(brows),
        torch.from_numpy(bcols), nbr, nbc, n, 32, 128, torch.from_numpy(x)))
    assert launch_counts()["bsr_matmul_f32"] == 0  # CPU: plain version
    assert got.shape == ref.shape and got.dtype == np.float32
    # f32 block products summed per block row, in another order than the
    # reference's MXU-precision dot: 1e-6 of Σ|A|·|x|
    scale = (abs(a) @ np.abs(x)).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    if case == "empty_block_rows":
        assert np.abs(got[64:128]).max() == 0.0
    np.testing.assert_allclose(got, a @ x, atol=1e-5 * scale)


def _straddling_matrix(n, rng):
    """Random sparsity plus rows whose nonzeros cross the 128-column block
    edge and reach column N − 2 (sectors over block edges and past N)."""
    a = sp.lil_matrix(_random_sparse(n, rng))
    for r in range(0, n, 4):
        a[r, 126], a[r, 130], a[r, n - 2] = 1.25, -0.5, 2.0
    return a.tocsr()


def _matrix(case, n, rng):
    return {"random": _random_sparse, "empty_block_rows": _empty_rows_matrix,
            "straddling": _straddling_matrix}[case](n, rng)


def _pack(source, a, n, dtype=np.float64):
    """The matrix's packing, from its stored blocks or from its nonzeros."""
    if source == "blocks":
        vals, brows, bcols, _, _ = tbs.bsr_from_scipy([a], n)
        return bsr_pack_sectors(torch.from_numpy(vals[0].astype(dtype)),
                                brows, bcols, n)
    coo = a.tocsr().tocoo()
    return pack_sectors(torch.from_numpy(coo.row.astype(np.int64)),
                        torch.from_numpy(coo.col.astype(np.int64)),
                        torch.from_numpy(coo.data.astype(dtype)), n)


@pytest.mark.parametrize("source", ["blocks", "nonzeros"])
@pytest.mark.parametrize("case", ["random", "empty_block_rows", "straddling"])
def test_sector_packing_holds_every_nonzero_once(case, source):
    rng = np.random.default_rng(2)
    n, width = 260, SECTOR_WIDTH
    a = _matrix(case, n, rng)
    pk = _pack(source, a, n)
    assert tuple(pk.vals.shape[1:]) == (width,) and pk.n == n
    assert pk.vals.dtype == torch.float64
    rows = np.repeat(np.arange(n), np.diff(_np(pk.rowptr)))
    starts = _np(pk.cols).astype(np.int64)
    # the values put back where they came from: the matrix, exactly
    dense = np.zeros((n, n + width))
    for s, (r, c0) in enumerate(zip(rows, starts)):
        dense[r, c0:c0 + width] = _np(pk.vals[s])
    np.testing.assert_array_equal(dense[:, :n], a.toarray())
    assert not dense[:, n:].any()
    # greedy: each sector starts at a nonzero column, sectors of a row are
    # disjoint and in column order, and none is stored empty
    assert (a[rows, starts] != 0).all()
    same_row = rows[1:] == rows[:-1]
    assert (starts[1:][same_row] >= starts[:-1][same_row] + width).all()
    aligned = np.unique(a.tocoo().row.astype(np.int64) * n
                        + a.tocoo().col // width * width).size
    assert pk.cols.numel() <= aligned
    if case == "straddling":
        assert ((starts < 128) & (starts + width > 128)).any()
        assert (starts + width > n).any()
    # one greedy cover, whichever storage it was packed from
    other = _pack({"blocks": "nonzeros", "nonzeros": "blocks"}[source], a, n)
    for t, u in zip(pk, other):
        assert torch.equal(t, u)


@pytest.mark.parametrize("source", ["blocks", "nonzeros"])
@pytest.mark.parametrize("case", ["random", "empty_block_rows", "straddling"])
def test_sector_matmul_matches_blocks_and_pallas(case, source):
    rng = np.random.default_rng(4)
    n = 260
    a = _matrix(case, n, rng)
    vals, brows, bcols, nbr, nbc = tbs.bsr_from_scipy([a], n)
    vals2d = vals[0].astype(np.float32).reshape(-1, 128)
    x = rng.standard_normal((n, 3))
    pk = _pack(source, a, n, np.float32)
    assert pk.vals.dtype == torch.float32
    blocks = (torch.from_numpy(vals2d), torch.from_numpy(brows),
              torch.from_numpy(bcols), nbr, nbc, n, 32, 128)
    reset_launch_counts()
    got = _np(bsr_matmul_f32(*blocks, torch.from_numpy(x), packing=pk))
    assert launch_counts()["bsr_matmul_f32"] == 0  # CPU: plain version
    np.testing.assert_array_equal(
        got, _np(sector_matmul_plain(pk, torch.from_numpy(x).float())))
    ref = _np(bsr_matmul_f32_plain(*blocks, torch.from_numpy(x)))
    pallas = np.asarray(jbs.bsr_matmul_pallas(
        jnp.asarray(vals2d), jnp.asarray(brows), jnp.asarray(bcols), nbr,
        nbc, n, 32, 128, jnp.asarray(x), interpret=True))
    # f32 products summed per row in another order than the blocks'
    # batched product or the reference's dot: 1e-6 of Σ|A|·|x|
    scale = (abs(a) @ np.abs(x)).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    assert np.abs(got - pallas).max() <= 1e-6 * scale
    # in f64 (the operator's precise path) it is the matrix's product
    pk64 = _pack(source, a, n)
    np.testing.assert_allclose(
        _np(sector_matmul_plain(pk64, torch.from_numpy(x))), a @ x,
        rtol=0, atol=1e-13 * scale)
    y1 = sector_matmul_plain(pk64, torch.from_numpy(x[:, 0]))
    assert tuple(y1.shape) == (n,)


def test_block_sparse_operator_bind_matches_the_reference():
    rng = np.random.default_rng(6)
    n = 300
    mats = [_random_sparse(n, rng) for _ in range(3)]
    op_t = tbs.BlockSparseAffineOperator(*mats, device=CPU)
    op_j = jbs.BlockSparseAffineOperator(*mats)
    c = np.array([0.4, -1.1, 1.7])
    x = rng.standard_normal((n, 2))
    got = _np(op_t.bind(torch.from_numpy(c))(torch.from_numpy(x)))
    # the reference's bind runs its Pallas kernel (interpret mode here)
    ref = np.asarray(op_j.bind(jnp.asarray(c))(jnp.asarray(x)))
    dense = sum(c[p] * abs((m + m.T) * 0.5) for p, m in enumerate(mats))
    scale = (abs(dense) @ np.abs(x)).max()
    # both apply the f32 combined operator, summed in other orders
    assert np.abs(got - ref).max() <= 1e-6 * scale
    # the packing holds the union of the addends' patterns
    union = sum(abs((m + m.T) * 0.5) for m in mats)
    assert int((op_t.sectors.vals != 0).any(0).sum()) == union.nnz


@pytest.mark.parametrize("case", ["random", "empty_block_rows", "straddling"])
def test_block_sparse_operator_packs_its_nonzeros(case):
    """The operator packs its CSR nonzeros as the blocks would be packed,
    and reports the blocks' inflation as the reference does."""
    rng = np.random.default_rng(8)
    n = 260
    mats = [_matrix(case, n, rng), _random_sparse(n, rng)]
    op_t = tbs.BlockSparseAffineOperator(*mats, device=CPU)
    sym = [(m + m.T) * 0.5 for m in mats]
    vals, brows, bcols, _, _ = tbs.bsr_from_scipy(sym, n)
    ref = bsr_pack_sectors(torch.from_numpy(vals), brows, bcols, n)
    assert tuple(op_t.sectors.vals.shape[:1]) == (2,)
    for t, u in zip(op_t.sectors, ref):
        assert torch.equal(t, u)
    assert op_t.inflation == jbs.BlockSparseAffineOperator(*mats).inflation


def test_block_sparse_operator_matches():
    rng = np.random.default_rng(3)
    n = 280
    mats = [_random_sparse(n, rng) for _ in range(3)]
    op_t = tbs.BlockSparseAffineOperator(*mats, device=CPU)
    op_j = jbs.BlockSparseAffineOperator(*mats)
    assert op_t.inflation == pytest.approx(op_j.inflation, rel=1e-15)
    c = np.array([1.3, -0.7, 2.1])
    x = rng.standard_normal((n, 2))
    dense = sum(c[p] * ((m + m.T) * 0.5).toarray()
                for p, m in enumerate(mats))
    ref = dense @ x
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    np.testing.assert_allclose(_np(op_t.matvec(ct, xt)), ref,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(
        _np(op_t.matvec(ct, xt)),
        np.asarray(op_j.matvec(jnp.asarray(c), jnp.asarray(x))),
        atol=1e-12 * np.abs(ref).max())
    fast = _np(op_t.bind(ct)(xt))
    assert fast.dtype == np.float64
    assert np.abs(fast - ref).max() <= 1e-5 * np.abs(ref).max()
    for p in range(3):
        refp = ((mats[p] + mats[p].T) * 0.5) @ x
        np.testing.assert_allclose(_np(op_t.apply_addend(p, xt)), refp,
                                   atol=1e-12 * np.abs(refp).max())
    np.testing.assert_allclose(_np(op_t.diagonal(ct)), np.diag(dense),
                               rtol=1e-14)


def test_ell_operator_matches():
    mats, rng = _scattered_pencil(seed=5)
    n = mats[0].shape[0]
    vals_t, cols_t = tell.ell_from_scipy(mats, n)
    vals_j, cols_j = jell.ell_from_scipy(mats, n)
    np.testing.assert_array_equal(vals_t, vals_j)
    np.testing.assert_array_equal(cols_t, cols_j)
    op_t = tell.ELLAffineOperator(*mats, device=CPU)
    op_j = jell.ELLAffineOperator(*mats)
    assert op_t.inflation == op_j.inflation
    c = np.array([1.0, 0.2, 0.4])
    x = rng.standard_normal((n, 2))
    ct, xt = torch.from_numpy(c), torch.from_numpy(x)
    ref = np.asarray(op_j.matvec(jnp.asarray(c), jnp.asarray(x)))
    np.testing.assert_allclose(_np(op_t.matvec(ct, xt)), ref, rtol=1e-13,
                               atol=1e-13)
    assert np.abs(_np(op_t.bind(ct)(xt)) - ref).max() <= 1e-5 * np.abs(
        ref).max()
    # the slot-loop form (large operands) equals the one-shot gather
    y1 = tell.ell_matmul(op_t.vals_w[1], op_t.cols, xt[:, 0])
    big = tell._ONE_SHOT_ELEMS
    try:
        tell._ONE_SHOT_ELEMS = 0
        y2 = tell.ell_matmul(op_t.vals_w[1], op_t.cols, xt[:, 0])
    finally:
        tell._ONE_SHOT_ELEMS = big
    np.testing.assert_allclose(_np(y1), _np(y2), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("kind", ["scattered", "blocky"])
def test_truncated_band_via_rcm_picks_the_reference_operator(kind):
    if kind == "scattered":
        mats, _ = _scattered_pencil(seed=6)
        band_half = 8
    else:
        rng = np.random.default_rng(7)
        mats = [_random_sparse(300, rng, half=20) for _ in range(3)]
        band_half = 16
    got = tbt.truncated_band_via_rcm(*mats, band_half=band_half, device=CPU)
    ref = jbt.truncated_band_via_rcm(*mats, band_half=band_half)
    assert type(got[0]).__name__ == type(ref[0]).__name__
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    assert got[3] == pytest.approx(ref[3], rel=1e-14)
    assert got[1].half == ref[1].half <= band_half


def test_csr_operator_matches_dense():
    mats, rng = _scattered_pencil(n=120, seed=8, nfar=30)
    x = rng.standard_normal((120, 2))
    c = np.array([0.5, 1.0, -2.0])
    op = SparseAffineOperator(*mats, device=CPU)
    dense = sum(c[p] * ((m + m.T) * 0.5).toarray()
                for p, m in enumerate(mats))
    np.testing.assert_allclose(
        _np(op.matvec(torch.from_numpy(c), torch.from_numpy(x))), dense @ x,
        rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        _np(op.matvec(torch.from_numpy(c), torch.from_numpy(x[:, 0]))),
        dense @ x[:, 0], rtol=1e-13, atol=1e-13)


def test_general_sparse_solve_matches():
    mats, rng = _scattered_pencil(seed=6)
    n = mats[0].shape[0]
    exact_t, band_t, perm_t, _ = tbt.truncated_band_via_rcm(
        *mats, band_half=8, device=CPU)
    exact_j, band_j, perm_j, _ = jbt.truncated_band_via_rcm(*mats,
                                                            band_half=8)
    c = np.array([1.0, 0.2, 0.4])
    rhs = rng.standard_normal((n, 2))
    x, relres = tbt.general_sparse_solve(
        exact_t, band_t, torch.from_numpy(c), torch.from_numpy(rhs),
        maxiter=200)
    xj, relres_j = jbt.general_sparse_solve(
        exact_j, band_j, jnp.asarray(c), jnp.asarray(rhs), maxiter=200)
    assert float(relres.max()) < 1e-8
    p = np.asarray(perm_j)
    dense = sum(c[q] * ((m + m.T) * 0.5).toarray()
                for q, m in enumerate(mats))[p][:, p]
    ref = np.linalg.solve(dense, rhs)
    assert np.linalg.norm(_np(x) - ref) <= 1e-7 * np.linalg.norm(ref)
    assert np.linalg.norm(_np(x) - np.asarray(xj)) <= 1e-7 * np.linalg.norm(
        ref)
