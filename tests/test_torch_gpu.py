"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device. Run them on the
machine with the card:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have and these tests do not need.)

Inputs are made with numpy from fixed seeds at small ragged shapes (the
main path's shapes are checked by chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from morfem_tpu_torch.ops.kernels import (
    gather_rows,
    gather_rows_plain,
    launch_counts,
    mm_words,
    mm_words_plain,
    panel_factor,
    panel_factor_plain,
    reset_launch_counts,
    tri_inverse,
    tri_inverse_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("g,p,npl", [(3, 24, 200), (2, 128, 640)])
def test_panel_factor_kernel(cuda, g, p, npl):
    rng = np.random.default_rng(p + npl)
    pt = _t(rng.standard_normal((g, p, npl)).astype(np.float32), cuda)
    av = np.ones((g, npl), np.float32)
    av[:, rng.choice(npl, npl // 5, replace=False)] = 0.0
    av = _t(av, cuda)
    reset_launch_counts()
    got = panel_factor(pt, av)
    ref = panel_factor_plain(pt, av)
    torch.cuda.synchronize()
    assert launch_counts()["panel_factor"] == 1
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    # products and sums rounded alike: equal up to f32 rounding order
    for a, b in zip(got[:2], ref[:2]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("m,k,n", [(70, 50, 90), (129, 384, 257)])
@pytest.mark.parametrize("with_t,sign", [(False, 1), (True, -1)])
def test_mm_words_kernel(cuda, m, k, n, with_t, sign):
    rng = np.random.default_rng(m + k + n)
    c = _t(rng.standard_normal((2, k, m)).astype(np.float32), cuda)
    c = c.transpose(1, 2)  # a strided view, as the panel LU passes
    r = _t(rng.standard_normal((2, k, n)).astype(np.float32), cuda)
    t = _t(rng.standard_normal((2, m, n)).astype(np.float32), cuda) if (
        with_t) else None
    got = mm_words(c, r, t, sign=sign)
    ref = mm_words_plain(c, r, t, sign=sign)
    # FP32 accumulation over K ≤ 384 in another order than cuBLAS
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_gather_rows_kernel(cuda):
    rng = np.random.default_rng(0)
    src = _t(rng.standard_normal((2, 256, 384)).astype(np.float32), cuda)
    view = src[:, :, 128:]  # strided source, unit column stride
    idx = _t(np.stack([rng.permutation(256)[:128] for _ in range(2)])
             .astype(np.int32), cuda)
    assert torch.equal(gather_rows(view, idx), gather_rows_plain(view, idx))


# (W, first column of the view): P=384 rows of strided views as the
# block-pivot LU passes them, copied with float4 loads and stores; a column
# offset that is no multiple of 4 floats takes the kernel's 4-byte copies
@pytest.mark.parametrize("w,col0", [
    (384, 0), (3072, 384), (4352, 0), (384, 1), (3072, 3),
])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_kernel_paths(cuda, w, col0, idx_dtype):
    rng = np.random.default_rng(w + col0)
    g, n, p = 3, 392, 384
    big = _t(rng.standard_normal((g, n + 8, w + col0 + 4))
             .astype(np.float32), cuda)
    src = big[:, 8:, col0:col0 + w]
    idx = np.stack([rng.permutation(n)[:p] for _ in range(g)])
    # contiguous indices, and a strided view of the same indices
    pairs = _t(np.stack([idx, idx], axis=2).reshape(g, 2 * p), cuda)
    for ix in (_t(idx, cuda).to(idx_dtype), pairs.to(idx_dtype)[:, ::2]):
        reset_launch_counts()
        got = gather_rows(src, ix)
        torch.cuda.synchronize()
        assert launch_counts()["gather_rows"] == 1
        assert torch.equal(got, gather_rows_plain(src, ix))


@pytest.mark.parametrize("col0", [0, 1])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_kernel_out_of_range_index_writes_nan(cuda, col0,
                                                         idx_dtype):
    rng = np.random.default_rng(5 + col0)
    g, n, p, w = 2, 256, 128, 512
    big = _t(rng.standard_normal((g, n, w + 4)).astype(np.float32), cuda)
    src = big[:, :, col0:col0 + w]
    idx = np.stack([rng.permutation(n)[:p] for _ in range(g)])
    idx[0, 5], idx[1, 127] = n, -1
    ix = _t(idx, cuda).to(idx_dtype)
    got = gather_rows(src, ix)
    ref = gather_rows_plain(src, ix.clamp(0, n - 1))
    ref[0, 5], ref[1, 127] = float("nan"), float("nan")
    assert torch.equal(got.isnan(), ref.isnan())
    assert bool(got[0, 5].isnan().all() and got[1, 127].isnan().all())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.parametrize("k,i_pts,m", [(12, 37, 2), (84, 100, 2), (37, 5, 3)])
def test_reduced_sweep_kernel(cuda, k, i_pts, m):
    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve,
        gauss_jordan_sweep_solve_plain,
    )

    rng = np.random.default_rng(k + i_pts)
    rs = [_t(rng.standard_normal((k, k)), cuda) for _ in range(3)]
    rs[0] = rs[0] + 3 * k * torch.eye(k, dtype=torch.float64, device=cuda)
    c = _t(rng.uniform(0.5, 2.0, (i_pts, 3)), cuda)
    rhs = _t(rng.standard_normal((i_pts, k, m)), cuda)
    inactive = torch.zeros(k, dtype=torch.float64, device=cuda)
    inactive[k - 2:] = 1.0  # two masked columns
    rhs[:, k - 2:] = 0.0
    from morfem_tpu_torch.ops.kernels.reduced_sweep import sweep_variant

    # K ≤ 64 (and M ≤ 8) runs the warp variant, K = 84 the block variant
    assert sweep_variant(k, m) == ("block" if k > 64 else "warp")
    for sym in (True, False):
        reset_launch_counts()
        got = gauss_jordan_sweep_solve(*rs, c, rhs, inactive, symmetrize=sym)
        ref = gauss_jordan_sweep_solve_plain(*rs, c, rhs, inactive,
                                             symmetrize=sym)
        torch.cuda.synchronize()
        assert launch_counts()["gauss_jordan_sweep_solve"] == 1
        # the same pivots and the same roundings, step for step
        assert torch.equal(got, ref), float((got - ref).abs().max())


class _AtenOps(TorchDispatchMode):
    """The ATen operators a call dispatches (casts and copies show here)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


# N = 384 fills whole 128-row tiles, 1000 / 777 / 300 leave a ragged one;
# half=47 (bw=95) with 64 float64 columns takes more than 48 KB of shared
# memory (the launcher opts in)
@pytest.mark.parametrize("n,half", [(1000, 6), (777, 0), (300, 47), (384, 6)])
@pytest.mark.parametrize("m", [1, 2, 3, 64, 65])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
def test_banded_matvec_kernel_reads_x_in_its_type(cuda, n, half, m,
                                                  x_dtype):
    from morfem_tpu_torch.ops.kernels import (
        banded_matvec_padded,
        banded_matvec_padded_plain,
    )
    from morfem_tpu_torch.ops.kernels.banded_matvec import (
        bind_banded_matvec,
    )

    rng = np.random.default_rng(n + half + m)
    bw = 2 * half + 1
    band = _t(rng.standard_normal((n, bw)).astype(np.float32), cuda)
    padded = torch.zeros((1024, 128), dtype=torch.float32, device=cuda)
    padded[:n, :bw] = band
    xs = _t(rng.standard_normal((n + 1, m)), cuda).to(x_dtype)
    # x from a 16-byte boundary, and x one row further on (its halo's
    # ends then fall off the boundary)
    for x in (xs[:n], xs[1:]):
        for b in (band, padded):
            for out in (torch.float32, x_dtype):
                reset_launch_counts()
                got = banded_matvec_padded(b, n, bw, half, x, out_dtype=out)
                torch.cuda.synchronize()
                assert launch_counts()["banded_matvec_padded"] == -(-m // 64)
                ref = banded_matvec_padded_plain(b, n, bw, half, x,
                                                 out_dtype=out)
                assert got.dtype == out
                # diagonals accumulated in one order, products and sums
                # rounded alike, x rounded alike: bit for bit
                assert torch.equal(got, ref)
    # the bound closure: one launch per 64 columns and, within 64 columns,
    # no other work on the card than the output's allocation (no cast)
    mv = bind_banded_matvec(band, n, bw, half)
    x = xs[:n]
    with _AtenOps() as seen:
        reset_launch_counts()
        got = mv(x, x_dtype)
    assert launch_counts()["banded_matvec_padded"] == -(-m // 64)
    if m <= 64:
        assert seen.ops == ["empty.memory_format"], seen.ops
    assert torch.equal(got, banded_matvec_padded_plain(band, n, bw, half, x,
                                                       out_dtype=x_dtype))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
def test_banded_operator_bind_launches_once_per_matvec(cuda, x_dtype):
    import scipy.sparse as sp

    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.kernels import banded_matvec_padded_plain

    rng = np.random.default_rng(3)
    n, half = 700, 6
    mats = [sp.diags([rng.normal(size=n - abs(d)) for d in range(-half,
                                                                 half + 1)],
                     offsets=range(-half, half + 1)).tocsr()
            for _ in range(3)]
    op = BandedAffineOperator(*mats, device=cuda)
    c = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64, device=cuda)
    mv = op.bind(c)
    band_p = torch.tensordot(c, op.bands_p.double(), dims=1).float()
    for x in (_t(rng.standard_normal((n, 2)), cuda).to(x_dtype),
              _t(rng.standard_normal(n), cuda).to(x_dtype)):
        with _AtenOps() as seen:
            reset_launch_counts()
            y = mv(x)
        assert launch_counts()["banded_matvec_padded"] == 1
        assert not any(op.startswith(("_to_copy.", "copy_."))
                       for op in seen.ops), seen.ops
        x2 = x[:, None] if x.ndim == 1 else x
        ref = banded_matvec_padded_plain(band_p, n, op.bw, half, x2,
                                         out_dtype=x_dtype)
        assert y.dtype == x_dtype and y.shape == x.shape
        assert torch.equal(y, ref[:, 0] if x.ndim == 1 else ref)


@pytest.mark.parametrize("n,half,m", [(1000, 6, 2), (777, 0, 1), (300, 47, 3)])
def test_banded_matvec_kernel(cuda, n, half, m):
    from morfem_tpu_torch.ops.kernels import (
        banded_matvec_padded,
        banded_matvec_padded_plain,
    )

    rng = np.random.default_rng(n + half)
    bw = 2 * half + 1
    band = _t(rng.standard_normal((n, bw)).astype(np.float32), cuda)
    padded = torch.zeros((1024, 128), dtype=torch.float32, device=cuda)
    padded[:n, :bw] = band
    x = _t(rng.standard_normal((n, m)), cuda)
    reset_launch_counts()
    for b in (band, padded):
        got = banded_matvec_padded(b, n, bw, half, x)
        ref = banded_matvec_padded_plain(b, n, bw, half, x)
        # diagonals accumulated in one order, products and sums rounded
        # alike: bit for bit
        assert torch.equal(got, ref)
    assert launch_counts()["banded_matvec_padded"] == 2


@pytest.mark.parametrize("m", [1, 2, 11])
def test_block_sparse_kernel(cuda, m):
    import scipy.sparse as sp

    from morfem_tpu_torch.ops.block_sparse import bsr_from_scipy
    from morfem_tpu_torch.ops.kernels import (
        bsr_matmul_f32,
        bsr_matmul_f32_plain,
    )

    rng = np.random.default_rng(m)
    n = 700
    a = sp.random(n, n, density=0.01, random_state=m, format="csr")
    a = a + sp.eye(n)
    a = a.tolil()
    a[64:96, :] = 0.0  # an empty block row (a zero filler block is stored)
    vals, brows, bcols, nbr, nbc = bsr_from_scipy([a.tocsr()], n)
    vals2d = _t(vals[0].reshape(-1, 128).astype(np.float32), cuda)
    brows, bcols = _t(brows, cuda), _t(bcols, cuda)
    x = _t(rng.standard_normal((n, m)), cuda)
    reset_launch_counts()
    got = bsr_matmul_f32(vals2d, brows, bcols, nbr, nbc, n, 32, 128, x)
    ref = bsr_matmul_f32_plain(vals2d, brows, bcols, nbr, nbc, n, 32, 128, x)
    torch.cuda.synchronize()
    assert launch_counts()["bsr_matmul_f32"] == -(-m // 8)
    # f32 sums in another order than the batched product: 1e-5 of Σ|a||x|
    scale = bsr_matmul_f32_plain(vals2d.abs(), brows, bcols, nbr, nbc, n,
                                 32, 128, x.abs()).max()
    assert (got - ref).abs().max() <= 1e-5 * scale
    assert float(got[64:96].abs().max()) == 0.0
    got1 = bsr_matmul_f32(vals2d, brows, bcols, nbr, nbc, n, 32, 128, x[:, 0])
    assert got1.shape == (n,)


@pytest.mark.parametrize("pack_on", ["cpu", "cuda"])
def test_block_sparse_kernel_sectors_across_block_edges(cuda, pack_on):
    import scipy.sparse as sp

    from morfem_tpu_torch.ops.block_sparse import bsr_from_scipy
    from morfem_tpu_torch.ops.kernels import (
        bsr_matmul_f32,
        bsr_matmul_f32_plain,
    )
    from morfem_tpu_torch.ops.kernels.block_sparse import (
        SECTOR_WIDTH,
        bsr_pack_sectors,
    )

    rng = np.random.default_rng(8)
    n = 301  # ragged: the last sectors run past column N − 1
    a = sp.lil_matrix(sp.random(n, n, density=0.02, random_state=8))
    for r in range(0, n, 3):
        a[r, 126], a[r, 129] = 1.5, -2.5  # one sector over columns 126–133
        a[r, n - 2] = 0.5
    vals, brows, bcols, nbr, nbc = bsr_from_scipy([a.tocsr()], n)
    blocks32 = torch.from_numpy(vals[0].astype(np.float32))
    on_cpu = bsr_pack_sectors(blocks32, brows, bcols, n)
    # the packing made on the card is the one made on the CPU
    packing = bsr_pack_sectors(blocks32.to(pack_on), brows, bcols, n)
    for t, u in zip(packing, on_cpu):
        assert torch.equal(t.cpu(), u)
    starts = on_cpu.cols.long()
    assert bool(((starts < 128) & (starts + SECTOR_WIDTH > 128)).any())
    assert bool((starts + SECTOR_WIDTH > n).any())
    packing = type(packing)(*(t.to(cuda) for t in packing))
    vals2d = _t(vals[0].reshape(-1, 128).astype(np.float32), cuda)
    brows, bcols = _t(brows, cuda), _t(bcols, cuda)
    for m in (2, 11):
        x = _t(rng.standard_normal((n, m)), cuda)
        got = bsr_matmul_f32(vals2d, brows, bcols, nbr, nbc, n, 32, 128, x,
                             packing=packing)
        ref = bsr_matmul_f32_plain(vals2d, brows, bcols, nbr, nbc, n, 32,
                                   128, x)
        scale = bsr_matmul_f32_plain(vals2d.abs(), brows, bcols, nbr, nbc,
                                     n, 32, 128, x.abs()).max()
        assert (got - ref).abs().max() <= 1e-5 * scale


def _gj_pencil(k, i_pts, m, dev, seed):
    """Diagonally dominant R0, two inactive columns, as the reduced model
    leaves them; coefficients and right-hand sides per point."""
    rng = np.random.default_rng(seed)
    rs = [_t(rng.standard_normal((k, k)), dev) for _ in range(3)]
    rs[0] = rs[0] + 3 * k * torch.eye(k, dtype=torch.float64, device=dev)
    c = _t(rng.uniform(0.5, 2.0, (i_pts, 3)), dev)
    rhs = _t(rng.standard_normal((i_pts, k, m)), dev)
    inactive = torch.zeros(k, dtype=torch.float64, device=dev)
    inactive[k - 2:] = 1.0
    rhs[:, k - 2:] = 0.0
    return rs, c, rhs, inactive


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("k", [12, 32, 33, 40, 48, 64])
def test_reduced_sweep_warp_variant(cuda, k, m):
    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve,
        gauss_jordan_sweep_solve_plain,
    )
    from morfem_tpu_torch.ops.kernels.reduced_sweep import sweep_variant

    assert sweep_variant(k, m) == "warp"
    # 130 points: the last block of 4 warps holds 2
    rs, c, rhs, inactive = _gj_pencil(k, 130, m, cuda, seed=10 * k + m)
    for sym in (True, False):
        reset_launch_counts()
        got = gauss_jordan_sweep_solve(*rs, c, rhs, inactive, symmetrize=sym)
        ref = gauss_jordan_sweep_solve_plain(*rs, c, rhs, inactive,
                                             symmetrize=sym)
        torch.cuda.synchronize()
        assert launch_counts()["gauss_jordan_sweep_solve"] == 1
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("rows", [(5, 20), (3, 35), (33, 39)])
def test_reduced_sweep_warp_variant_pivot_tie(cuda, rows):
    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve,
        gauss_jordan_sweep_solve_plain,
    )

    # |10| twice in column 0, in two lanes, in one lane's two rows (3 and
    # 35) or in two lanes' second rows: the lower row wins
    k = 40
    rng = np.random.default_rng(sum(rows))
    a = rng.uniform(-1.0, 1.0, (k, k)) + 4.0 * np.eye(k)
    a[:, 0] = rng.uniform(-1.0, 1.0, k)
    a[rows[0], 0], a[rows[1], 0] = -10.0, 10.0
    a, zero = _t(a, cuda), torch.zeros((k, k), dtype=torch.float64,
                                       device=cuda)
    b = _t(rng.standard_normal((3, k, 2)), cuda)
    args = (a, zero, zero, _t(np.tile([1.0, 0.0, 0.0], (3, 1)), cuda), b,
            torch.zeros(k, dtype=torch.float64, device=cuda))
    got = gauss_jordan_sweep_solve(*args, symmetrize=False)
    ref = gauss_jordan_sweep_solve_plain(*args, symmetrize=False)
    assert torch.equal(got, ref)
    # the other row winning changes the f32 result
    swap = list(range(k))
    swap[rows[0]], swap[rows[1]] = rows[1], rows[0]
    other = gauss_jordan_sweep_solve(a[swap], zero, zero, args[3],
                                     b[:, swap], args[5], symmetrize=False)
    assert not torch.equal(other, got)


@pytest.mark.parametrize("where", ["column", "point"])
def test_reduced_sweep_warp_variant_nan(cuda, where):
    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve,
        gauss_jordan_sweep_solve_plain,
    )

    k = 40
    rs, c, rhs, inactive = _gj_pencil(k, 9, 2, cuda, seed=7)
    if where == "column":
        rs[1][:, 7] = float("nan")  # a NaN column at every point
    else:
        c[3, 0] = float("nan")  # one point's whole system
    got = gauss_jordan_sweep_solve(*rs, c, rhs, inactive, symmetrize=False)
    ref = gauss_jordan_sweep_solve_plain(*rs, c, rhs, inactive,
                                         symmetrize=False)
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref))
    # a NaN in a pivot column turns the point's whole solution NaN
    if where == "column":
        assert bool(nan.all())
    else:
        assert bool(nan[3].all()) and not bool(nan[:3].any() or nan[4:].any())


def test_reduced_sweep_kernel_pivot_tie(cuda):
    from morfem_tpu_torch.ops.kernels import (
        gauss_jordan_sweep_solve,
        gauss_jordan_sweep_solve_plain,
    )

    # |3| twice in column 0 (rows 0 and 1): the lowest row wins, in the
    # kernel as in the plain version (tests/test_torch_reduced_sweep.py
    # pins the plain version's choice against the JAX kernel)
    a = _t(np.array([[3.0, 8, 1, 1], [-3, 1, 5, -6], [-2, 0, 5, 0],
                     [0, -8, 0, 9]]), cuda)
    zero = torch.zeros_like(a)
    b = _t(np.array([-1.0, -9, 1, 5])[None, :, None], cuda)
    args = (a, zero, zero, _t(np.array([[1.0, 0.0, 0.0]]), cuda), b,
            torch.zeros(4, dtype=torch.float64, device=cuda))
    from morfem_tpu_torch.ops.kernels.reduced_sweep import sweep_variant

    assert sweep_variant(4, 1) == "warp"  # the tie is broken in registers
    got = gauss_jordan_sweep_solve(*args, symmetrize=False)
    ref = gauss_jordan_sweep_solve_plain(*args, symmetrize=False)
    assert torch.equal(got, ref)


def _same_factor(got, ref):
    """Pivots and availability exactly, fac (and C̃ where present) bit for
    bit: the kernels round every update as the plain version does."""
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    for a, b in zip(got[:2], ref[:2]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), float((a - b).abs().max())


def _panel_inputs(g, p, npl, dev, seed):
    rng = np.random.default_rng(seed)
    pt = _t(rng.standard_normal((g, p, npl)).astype(np.float32), dev)
    av = np.ones((g, npl), np.float32)
    if p < npl:
        av[:, rng.choice(npl, (npl - p) // 2, replace=False)] = 0.0
    return pt, _t(av, dev)


@pytest.mark.parametrize("g,p,npl,want_ct,variant", [
    (8, 384, 384, False, "cluster8"),  # the block-pivot diagonal blocks
    (8, 384, 384, True, "cluster8"),
    (3, 40, 77, True, "cluster8"),  # ragged lanes: the last CTA holds 7 of 10
    (2, 9, 9, False, "cluster8"),  # 2 lanes a CTA, the last ones 1 or none
    (1, 128, 3456, True, "cluster8"),  # full pivot with C̃, one solve
    (1, 128, 3456, False, "cluster8"),
    (6, 128, 3456, True, "cluster8"),  # the flagship step's 6 seeds
    (20, 128, 3456, True, "cluster8"),  # the bench's batch: two waves
    (1, 384, 1536, True, "cluster16"),  # panel 384 kept by full_pivot_panel
    (1, 384, 1201, True, "cluster16"),  # ragged lanes over 16 CTAs
    (1, 128, 8192, True, "cluster_global"),  # dense_cutoff: device memory
    (1, 128, 8192, False, "cluster_global"),
])
def test_panel_factor_kernels_equal_the_plain_version(cuda, g, p, npl,
                                                      want_ct, variant):
    from morfem_tpu_torch.ops.kernels.panel_factor import panel_factor_plan

    pt, av = _panel_inputs(g, p, npl, cuda, g * p + npl)
    reset_launch_counts()
    got = panel_factor(pt, av, want_ct=want_ct)
    ref = panel_factor_plain(pt, av, want_ct=want_ct)
    torch.cuda.synchronize()
    assert launch_counts()["panel_factor"] == 1
    assert panel_factor_plan(p, npl, want_ct).variant == variant
    _same_factor(got, ref)


@pytest.mark.parametrize("cluster,in_smem", [(8, True), (8, False),
                                             (16, True), (16, False)])
@pytest.mark.parametrize("want_ct", [True, False])
@pytest.mark.parametrize("threads", [256, 512])
def test_every_panel_factor_instance_equals_the_plain_version(
        cuda, cluster, in_smem, want_ct, threads):
    # each (cluster size, where the lanes live, C̃) instance of the kernel
    # at each block size, launched directly (the wrapper picks one per
    # shape), on ragged lanes
    import ctypes

    from morfem_tpu_torch.ops.kernels import _lib

    g, p, npl = 3, 40, 77
    pt, av = _panel_inputs(g, p, npl, cuda, 5)
    fac, piv = torch.empty_like(pt), torch.empty((g, p), dtype=torch.int32,
                                                 device=cuda)
    ct = torch.empty_like(pt) if want_ct else None
    av_out = torch.empty_like(av)
    lib = _lib.load()
    count = ctypes.c_int(0)
    lib.call("morfem_panel_factor_max_clusters", p, npl, int(want_ct),
             cluster, int(in_smem), threads, ctypes.byref(count))
    assert count.value > 0
    lib.call("morfem_panel_factor", pt.data_ptr(), av.data_ptr(),
             fac.data_ptr(), ct.data_ptr() if want_ct else None,
             piv.data_ptr(), av_out.data_ptr(), g, p, npl, int(want_ct),
             cluster, int(in_smem), threads, _lib.stream_handle(pt))
    ref = panel_factor_plain(pt, av, want_ct=want_ct)
    torch.cuda.synchronize()
    _same_factor((fac, ct, piv, av_out), ref)


@pytest.mark.parametrize("lanes", [(20, 100), (5, 9), (100, 20)])
def test_panel_factor_kernel_tie_goes_to_the_lowest_lane(cuda, lanes):
    # |2| at two lanes of column 0, in different CTAs of the cluster (16
    # lanes each at Npl=128) or in one: the lower lane pivots
    rng = np.random.default_rng(sum(lanes))
    pt = rng.uniform(-1.0, 1.0, (2, 16, 128)).astype(np.float32)
    pt[:, 0, lanes[0]] = -2.0
    pt[:, 0, lanes[1]] = 2.0
    pt, av = _t(pt, cuda), torch.ones((2, 128), device=cuda)
    for want_ct in (True, False):
        got = panel_factor(pt, av, want_ct=want_ct)
        ref = panel_factor_plain(pt, av, want_ct=want_ct)
        assert int(got[2][0, 0]) == min(lanes)
        _same_factor(got, ref)


@pytest.mark.parametrize("p,npl,lanes", [
    (128, 3456, (3000, 500)),   # CTAs 6 and 1 of 8
    (384, 1201, (1150, 100)),   # CTAs 15 and 1 of 16
    (128, 8192, (7000, 600)),   # lanes in device memory
])
def test_panel_factor_tie_across_ctas_with_coefficients(cuda, p, npl, lanes):
    # an exact tie in column 5, after C̃ has rows, between lanes owned by
    # two CTAs: the two lanes are negatives of each other and 0 in columns
    # 0-4 (so steps 0-4 leave them alone), 50 in column 5; the lower lane
    # pivots, and everything equals the plain version
    rng = np.random.default_rng(npl)
    pt = rng.uniform(-1.0, 1.0, (1, p, npl)).astype(np.float32)
    pt[:, :5, lanes[0]] = 0.0
    pt[:, 5, lanes[0]] = 50.0
    pt[:, :, lanes[1]] = -pt[:, :, lanes[0]]
    pt, av = _t(pt, cuda), torch.ones((1, npl), device=cuda)
    got = panel_factor(pt, av, want_ct=True)
    ref = panel_factor_plain(pt, av, want_ct=True)
    assert int(ref[2][0, 5]) == min(lanes)
    _same_factor(got, ref)


def _same_with_nans(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("p,npl", [(16, 128), (128, 3456), (384, 1201)])
@pytest.mark.parametrize("whole", [True, False])
def test_panel_factor_nan_column_pivots_at_lane_zero(cuda, p, npl, whole):
    # a NaN score anywhere in column 3 (the whole column, or one entry in
    # a CTA other than lane 0's) finds no maximum: the pivot is lane 0, as
    # in the plain version; with C̃
    rng = np.random.default_rng(p + npl)
    pt = rng.standard_normal((2, p, npl)).astype(np.float32)
    if whole:
        pt[:, 3, :] = np.nan
    else:
        pt[:, 3, npl - 2] = np.nan
    pt, av = _t(pt, cuda), torch.ones((2, npl), device=cuda)
    got = panel_factor(pt, av, want_ct=True)
    ref = panel_factor_plain(pt, av, want_ct=True)
    torch.cuda.synchronize()
    assert int(ref[2][0, 3]) == 0
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    for a, b in zip(got[:2], ref[:2]):
        assert _same_with_nans(a, b)


@pytest.mark.parametrize("m,k,n", [(70, 50, 90), (129, 384, 257),
                                   (384, 128, 200), (3, 1, 5)])
@pytest.mark.parametrize("sign", [1, -1])
def test_word_split_kernel_matches_both_plain_versions(cuda, m, k, n, sign):
    from morfem_tpu_torch.ops.kernels.fused_mm import mm_words_split_plain

    rng = np.random.default_rng(m * k + n)
    # the transposed coefficient view and a strided addend view, as the
    # panel LU passes them
    c = _t(rng.standard_normal((2, k, m)).astype(np.float32), cuda)
    c = c.transpose(1, 2)
    r = _t(rng.standard_normal((2, k, n + 7)).astype(np.float32), cuda)
    r = r[:, :, 7:]
    big = _t(rng.standard_normal((2, m + 3, n + 11)).astype(np.float32), cuda)
    for t in (None, big[:, 3:, 11:]):
        reset_launch_counts()
        got = mm_words(c, r, t, sign=sign)
        torch.cuda.synchronize()
        assert launch_counts()["mm_words"] == 1
        split = mm_words_split_plain(c, r, t, sign=sign)
        ref = mm_words_plain(c, r, t, sign=sign)
        # the same exact word products summed in another order (tensor
        # cores vs cuBLAS): f32 rounding, 1e-5 of the |c|·|r| (+|t|) scale
        scale = float((c.abs() @ r.abs()).max()) + (
            0.0 if t is None else float(t.abs().max()))
        assert float((got - split).abs().max()) <= 1e-5 * scale
        assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_word_split_kernel_propagates_nan(cuda):
    rng = np.random.default_rng(1)
    c = _t(rng.standard_normal((1, 130, 64)).astype(np.float32), cuda)
    r = _t(rng.standard_normal((1, 64, 140)).astype(np.float32), cuda)
    c[0, 5, 7] = float("nan")
    r[0, 3, 139] = float("inf")
    got = mm_words(c, r)
    ref = mm_words_plain(c, r)
    # a NaN in row 5 of c: a NaN row out; an inf in column 139 of r: a
    # non-finite column (NaN here, as in the reference's split, whose
    # lower words of inf are inf - inf; ±inf in the FP32 product)
    assert bool(torch.isnan(got[0, 5]).all())
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    assert float((got - ref)[fin].abs().max()) <= 1e-5 * float(
        ref[fin].abs().max())


@pytest.mark.parametrize("with_t", [False, True])
def test_word_split_kernel_is_as_accurate_as_an_fp32_product(cuda, with_t):
    # against the exact (f64) result: the tensor cores do not round their
    # accumulator to nearest, so a long wgmma chain drifts; K2 starts a
    # fresh partial every 16-wide K step and adds it with round-to-nearest,
    # which keeps it at least as close as cuBLAS's FP32 product
    rng = np.random.default_rng(23 + with_t)
    c = _t(rng.standard_normal((2, 512, 384)).astype(np.float32), cuda)
    r = _t(rng.standard_normal((2, 384, 640)).astype(np.float32), cuda)
    t = _t(rng.standard_normal((2, 512, 640)).astype(np.float32), cuda) if (
        with_t) else None
    exact = c.double() @ r.double()
    if t is not None:
        exact = t.double() - exact
    sign = -1 if with_t else 1
    err_k = (mm_words(c, r, t, sign=sign).double() - exact).abs()
    err_f = (mm_words_plain(c, r, t, sign=sign).double() - exact).abs()
    assert float(err_k.mean()) <= float(err_f.mean())
    assert float(err_k.max()) <= 2.0 * float(err_f.max())


def _complex_banded(n, half=5, seed=7):
    """A complex-symmetric banded pencil (a0, 0, −I) and complex b."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    diags = [(8.0 + rng.random(n)) + 1j * 0.4] + [
        (-0.3 + 0.05j) * np.ones(n - d) for d in range(1, half + 1)]
    a0 = sp.diags(diags, list(range(half + 1))).tocsr()
    a0 = ((a0 + a0.T) * 0.5).tocsr()
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    return (a0, sp.csr_matrix((n, n)), (sp.eye(n) * -1.0).tocsr()), b


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float64])
def test_banded_matvec_kernel_on_the_interleaved_embedding(cuda, x_dtype):
    """K5 at the embedded band (half-bandwidth 5 → 11, bw 23), bare and
    through the non-symmetric operator's `bind`: bit for bit."""
    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.complex_split import embed_sparse_interleaved
    from morfem_tpu_torch.ops.kernels import (
        banded_matvec_padded,
        banded_matvec_padded_plain,
    )

    mats, _ = _complex_banded(1501)
    op = BandedAffineOperator(*(embed_sparse_interleaved(m) for m in mats),
                              symmetrize=False, device=cuda)
    assert (op.n, op.half, op.bw) == (3002, 11, 23)
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((op.n, 2)), cuda).to(x_dtype)
    band = _t(rng.standard_normal((op.n, 23)).astype(np.float32), cuda)
    reset_launch_counts()
    got = banded_matvec_padded(band, op.n, 23, 11, x, out_dtype=x_dtype)
    assert launch_counts()["banded_matvec_padded"] == 1
    assert torch.equal(got, banded_matvec_padded_plain(
        band, op.n, 23, 11, x, out_dtype=x_dtype))
    c = torch.tensor([1.0, 0.0, 1.7], dtype=torch.float64, device=cuda)
    band_p = torch.tensordot(c, op.bands_p.double(), dims=1).float()
    reset_launch_counts()
    y = op.bind(c)(x)
    assert launch_counts()["banded_matvec_padded"] == 1
    assert torch.equal(y, banded_matvec_padded_plain(
        band_p, op.n, op.bw, op.half, x, out_dtype=x_dtype))


def test_complex_dense_morfem_skips_the_real_kernels(cuda):
    """The dense complex route on the card: complex128 throughout, no
    panel LU (K1–K3), and a complex model under the K4 sweep takes the
    batched LU (no K4 launch), equal to the CPU run."""
    from morfem_tpu_torch import MorfemConfig, morfem

    rng = np.random.default_rng(9)
    n = 200
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a0 = (g + g.T) * 0.5 + (6.0 + 1.5j) * np.eye(n)
    a1, a2 = np.zeros((n, n)), -np.eye(n)
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    domain = np.linspace(0.8, 1.6, 16)
    cfg = MorfemConfig(symmetrize=False, error_threshold=1e-14,
                       sweep_method="lu", use_pallas_reduced_sweep=True)
    reset_launch_counts()
    x, q, *_ = morfem(domain, a0, a1, a2, b, config=cfg, device=cuda)
    torch.cuda.synchronize()
    assert all(v == 0 for v in launch_counts().values()), launch_counts()
    assert x.is_complex() and x.device.type == "cuda"
    rec = torch.einsum("nk,ikm->inm", q, x).cpu().numpy()
    for i in (0, 8, 15):
        t = domain[i]
        ref = np.linalg.solve(a0 - t * t * np.eye(n), t * b)
        assert np.linalg.norm(rec[i] - ref) < 1e-9 * np.linalg.norm(ref)


def test_complex_matfree_morfem_on_the_card(cuda):
    """The matrix-free complex route on the card: the embedded real P=3
    model is built and not swept, so K4's flag launches no K4, and the
    complex model matches spsolve."""
    import scipy.sparse as sp
    import scipy.sparse.linalg  # noqa: F401

    from morfem_tpu_torch import MorfemConfig, morfem

    mats, b = _complex_banded(400)
    domain = np.linspace(0.8, 2.0, 16)
    cfg = MorfemConfig(symmetrize=False, dense_cutoff=128,
                       error_threshold=1e-11, sweep_method="lu",
                       use_pallas_reduced_sweep=True)
    reset_launch_counts()
    x, q, *_ = morfem(domain, *mats, b, config=cfg, device=cuda)
    torch.cuda.synchronize()
    assert launch_counts()["gauss_jordan_sweep_solve"] == 0
    qh, xh = q.cpu().numpy(), x.cpu().numpy()
    for i in (0, 8, 15):
        t = domain[i]
        ref = sp.linalg.spsolve((mats[0] - t * t * sp.eye(400)).tocsc(),
                                t * b)
        assert np.linalg.norm(qh @ xh[i] - ref) < 1e-8 * np.linalg.norm(ref)


def test_sweep_complex_reduced_defaults_to_the_card(cuda):
    """NumPy inputs are moved to the card by default; the sweep agrees
    with the CPU's."""
    from morfem_tpu_torch import sweep_complex_reduced

    rng = np.random.default_rng(4)
    k = 12
    r0, r1, r2 = (rng.standard_normal((k, k)) + 1j * rng.standard_normal(
        (k, k)) + 8 * np.eye(k) * (p == 0) for p in range(3))
    b_r = rng.standard_normal((k, 2)) + 1j * rng.standard_normal((k, 2))
    grid = np.linspace(0.5, 1.5, 64)
    fns = (lambda t: torch.ones_like(t), lambda t: t, lambda t: t ** 2,
           lambda t: t * torch.exp(1j * t))
    x = sweep_complex_reduced(r0, r1, r2, b_r, grid, *fns)
    assert x.device.type == "cuda" and x.dtype == torch.complex128
    x_cpu = sweep_complex_reduced(r0, r1, r2, b_r, grid, *fns, device="cpu")
    assert torch.linalg.norm(x.cpu() - x_cpu) < 1e-12 * torch.linalg.norm(
        x_cpu)


def _small_waveguide_system(dev, n=400, pts=40):
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, waveguide_system,
    )

    data = load_waveguide_data(n_fallback=n)
    return waveguide_system(np.linspace(3e9, 5e9, pts), data, device=dev)


def test_checkpoint_loads_onto_the_card_and_k4_sweeps_it(cuda, tmp_path):
    """A model saved from the card loads back onto it, and K4 sweeps the
    loaded model bit for bit as the in-memory one."""
    from morfem_tpu_torch import (
        MorfemConfig, build_reduced_model, load_reduced_model,
        save_reduced_model, sweep,
    )
    from morfem_tpu_torch.apps.waveguide import b_coefficient

    sys_ = _small_waveguide_system(cuda)
    rm = build_reduced_model(sys_, MorfemConfig(error_threshold=1e-10))[0]
    rm = rm.trim()
    path = str(tmp_path / "wg.npz")
    save_reduced_model(path, rm)
    loaded = load_reduced_model(path, t_b=b_coefficient, device=cuda)
    assert loaded.q.device == sys_.device and loaded.ncols == rm.ncols
    cfg = MorfemConfig(sweep_method="lu", use_pallas_reduced_sweep=True)
    ts = torch.linspace(3e9, 5e9, 1000, dtype=torch.float64, device=cuda)
    reset_launch_counts()
    x_loaded = sweep(loaded, cfg, ts)
    per_sweep = launch_counts()["gauss_jordan_sweep_solve"]
    x_mem = sweep(rm, cfg, ts)
    torch.cuda.synchronize()
    # K4 solves, then solves once more per f64 refinement pass
    assert per_sweep > 0
    assert launch_counts()["gauss_jordan_sweep_solve"] == 2 * per_sweep
    assert torch.equal(x_loaded, x_mem)


def test_spectral_full_sweep_on_the_card(cuda):
    from morfem_tpu_torch import prepare_spectral_full, spectral_full_sweep
    from morfem_tpu_torch.ops.assembly import assemble_at

    sys_ = _small_waveguide_system(cuda)
    fs = prepare_spectral_full(sys_)
    assert fs.back.device == sys_.device
    x = spectral_full_sweep(fs, chunk=16)
    for i in (0, 17, 39):
        a, b = assemble_at(sys_, sys_.domain[i])
        ref = torch.linalg.solve(a, b)
        assert torch.linalg.norm(x[i] - ref) < 1e-9 * torch.linalg.norm(ref)


def test_gj_and_cr_on_the_card(cuda):
    """The Gauss–Jordan solve and cyclic reduction run on the card and
    agree with the card's f64 solves."""
    from morfem_tpu_torch import gj_solve_refined
    from morfem_tpu_torch.ops.block_tridiag import (
        banded_direct_solve, banded_via_rcm,
    )
    from morfem_tpu_torch.utils.synthetic import banded_waveguide_system_2d

    rng = np.random.default_rng(6)
    a = _t(rng.standard_normal((300, 300)) + 30 * np.eye(300), cuda)
    b = _t(rng.standard_normal((300, 2)), cuda)
    x = gj_solve_refined(a, b, refine_iterations=25)
    ref = torch.linalg.solve(a, b)
    assert torch.linalg.norm(x - ref) < 1e-12 * torch.linalg.norm(ref)
    c_sp, t_sp, wp = banded_waveguide_system_2d(36, m=2, seed=1)
    op, perm = banded_via_rcm(c_sp, 0.0 * c_sp, -1e-16 * t_sp, device=cuda)
    rhs = _t(wp, cuda)[perm]
    cf = torch.tensor([1.0, 0.0, 4e9 ** 2], dtype=torch.float64,
                      device=cuda)
    x_cr = banded_direct_solve(op, cf, rhs, factorization="cr")[0]
    x_sc = banded_direct_solve(op, cf, rhs)[0]
    assert torch.linalg.norm(x_cr - x_sc) < 1e-10 * torch.linalg.norm(x_sc)


def test_studies_helpers_default_to_the_card(cuda):
    """`upscale_interpolate` resamples on the card by default and equals
    its CPU result; `equally_distributed_points` puts a NumPy grid there."""
    from morfem_tpu_torch.apps.studies import upscale_interpolate
    from morfem_tpu_torch.apps.waveguide import equally_distributed_points

    a = np.random.default_rng(4).standard_normal((60, 60))
    x = upscale_interpolate(a, 2.5)
    y = upscale_interpolate(a, 2.5, device="cpu")
    assert isinstance(x, np.ndarray) and x.shape == (150, 150)
    assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max()
    pts = equally_distributed_points(np.linspace(3e9, 5e9, 11), 4)
    assert pts.device.type == "cuda"


def test_two_gloo_ranks_on_the_card_match_one_rank(cuda):
    """Two spawned ranks share the card over gloo (CUDA tensors staged
    through host memory): the tp=2 projection and the sp=2 full-order
    sweep (K1–K3 on each rank) agree with the single-device functions,
    and a singular Schur block factors to non-finite values on the card."""
    from morfem_tpu_torch import AffineSystem, MorfemConfig, solve_sweep
    from morfem_tpu_torch.ops.block_tridiag import block_tridiag_factor
    from morfem_tpu_torch.ops.kernels import launch_counts
    from morfem_tpu_torch.parallel import (
        sharded_full_order_sweep, tp_operator_images_and_project,
    )
    from morfem_tpu_torch.parallel.launch import (
        MESH, Call, call_on_mesh, run_spmd,
    )
    from morfem_tpu_torch.utils.synthetic import random_affine_system

    arrays = random_affine_system(0, n=400, m=2, num_points=10, device="cpu")
    q = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(1).standard_normal((400, 12))))[0]
    cfg = MorfemConfig()
    sys_r = Call(AffineSystem.create, arrays, {"device": "cuda"})
    out_tp = run_spmd(call_on_mesh, 2, "gloo", "cuda", (1, 1, 2), [
        Call(tp_operator_images_and_project,
             (Call(AffineSystem.operators, (sys_r,)),
              Call(getattr, (sys_r, "b")), Call(torch.Tensor.cuda, (q,)),
              MESH))])
    out_sp = run_spmd(call_on_mesh, 2, "gloo", "cuda", (1, 2, 1), [
        Call(sharded_full_order_sweep, (sys_r, MESH, cfg)),
        Call(launch_counts)])
    sys_ = AffineSystem.create(*arrays, device=cuda)
    u, r, b_r = (x.to(cuda) for x in out_tp[0])
    qc = q.to(cuda)
    for p, a in enumerate(sys_.operators()):
        assert (u[p] - a @ qc).abs().max() <= 1e-12 * (a @ qc).abs().max()
        rp = qc.T @ a @ qc
        assert (r[p] - rp).abs().max() <= 1e-11 * rp.abs().max()
    x = out_sp[0].to(cuda)
    ref = solve_sweep(sys_, cfg)
    assert torch.linalg.norm(x - ref) <= 1e-10 * torch.linalg.norm(ref)
    assert all(out_sp[1][k] > 0 for k in ("panel_factor", "mm_words",
                                          "gather_rows"))
    d = torch.eye(128, device=cuda).repeat(2, 1, 1)
    d[0, 127, 127] = 0.0
    fac = block_tridiag_factor(torch.zeros_like(d), d, torch.zeros_like(d),
                               256)
    assert not bool(torch.isfinite(fac.g[0]).all())


@pytest.mark.parametrize("cfg_kw", [None, {"factorization": "panel",
                                           "panel_width": 128},
                                    {"factorization": "gj"}])
def test_flagship_step_captures_and_replays(cuda, cfg_kw):
    """entry()'s example captured as CUDA graphs (the thin SVD eager
    between two): the replay equals the eager step, and equals it again
    after new inputs are copied in; under factorization="panel" (panels
    of 128, so that N=256 takes two, and K2 runs) the seed solves launch
    K1–K3 in the warm-up and record as many in the graph; "gj" captures
    the Gauss–Jordan inverse's column loop."""
    from morfem_tpu_torch.entry import capture, entry, flagship_step

    _, args = entry(cuda)
    step = flagship_step(cfg_kw)
    eager = step(*args)
    reset_launch_counts()
    captured = capture(step, args)
    counts = launch_counts()
    out = captured()
    torch.cuda.synchronize()
    assert [(s.label, s.graph is not None) for s in captured.segments] == [
        ("seed solves", True), ("thin SVD", False),
        ("projection, reduced sweep and GSM", True)]
    for o, e in zip(out, eager):
        assert bool(torch.isfinite(o).all())
        assert float((o - e).abs().max()) <= 1e-12
    scaled = (args[0] * 1.001,) + tuple(args[1:])
    out = captured(*scaled)
    for o, e in zip(out, step(*scaled)):
        assert float((o - e).abs().max()) <= 1e-12
    kernels = ("panel_factor", "mm_words", "gather_rows", "tri_inverse")
    if cfg_kw is None or cfg_kw["factorization"] == "gj":
        assert all(counts[k] == 0 for k in kernels)
    else:
        assert all(counts[k] > 0 and counts[k] % 2 == 0 for k in kernels)


def _int_valued(shape, rng, dev):
    """f32 small integers: every K2 word product and sum is exact, so the
    kernel equals its plain versions bit for bit whatever the order."""
    return _t(rng.integers(-3, 4, size=shape).astype(np.float32), dev)


@pytest.mark.parametrize("g", [65_536, 70_001])
@pytest.mark.parametrize("case", ["k1", "k1_ct", "k2", "k2_t", "k3_int32",
                                  "k3_int64"])
def test_kernels_take_a_batch_past_the_grid_limit(cuda, g, case):
    """K1–K3 past 65,535 matrices a launch (a grid dimension's limit), at
    the smallest shapes they take: one wrapper call, one count, and the
    plain version's result bit for bit at every batch entry."""
    rng = np.random.default_rng(g)
    reset_launch_counts()
    if case.startswith("k1"):
        panel, av = _panel_inputs(g, 8, 16, cuda, g)
        got = panel_factor(panel, av, want_ct=case == "k1_ct")
        ref = panel_factor_plain(panel, av, want_ct=case == "k1_ct")
        kernel = "panel_factor"
    elif case.startswith("k2"):
        c = _int_valued((g, 64, 64), rng, cuda)
        r = _int_valued((g, 64, 64), rng, cuda)
        t = _int_valued((g, 64, 64), rng, cuda) if case == "k2_t" else None
        got = (mm_words(c, r, t, sign=-1),)
        ref = (mm_words_plain(c, r, t, sign=-1),)
        kernel = "mm_words"
    else:
        src = _t(rng.standard_normal((g, 8, 128)).astype(np.float32), cuda)
        dtype = np.int32 if case == "k3_int32" else np.int64
        idx = _t(rng.integers(0, 8, size=(g, 128)).astype(dtype), cuda)
        got, ref = (gather_rows(src, idx),), (gather_rows_plain(src, idx),)
        kernel = "gather_rows"
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == 1
    if kernel == "panel_factor":
        _same_factor(got, ref)
    else:
        assert torch.equal(got[0], ref[0])


def _sleep_cycles(ms):
    """`torch.cuda._sleep` cycles for about `ms` on this card (timed)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return int(cycles * ms / start.elapsed_time(end))


def test_phase_timer_waits_for_the_card(cuda):
    """A PhaseTimer() without a device synchronises the current card: a
    phase that only enqueues ~50 ms of device work records it."""
    from morfem_tpu_torch import PhaseTimer

    cycles = _sleep_cycles(50.0)
    timer = PhaseTimer()
    with timer.phase("sleep"):
        torch.cuda._sleep(cycles)
    assert timer.times["sleep"] >= 0.040, timer.times


def test_morfem_phases_add_up_to_its_wall_time(cuda):
    """morfem(..., timer=PhaseTimer()) on the card: the phases hold the
    device work they enqueue, so they sum to the call's synchronised wall
    time but for the host's few steps between them."""
    import time

    from morfem_tpu_torch import MorfemConfig, PhaseTimer, morfem

    rng = np.random.default_rng(4)
    n = 400
    g = rng.standard_normal((n, n))
    ops = [_t((g + g.T) * 0.5 + 6.0 * np.eye(n), cuda),
           torch.zeros((n, n), dtype=torch.float64, device=cuda),
           -torch.eye(n, dtype=torch.float64, device=cuda),
           _t(rng.standard_normal((n, 2)), cuda)]
    domain = torch.linspace(0.8, 1.6, 2000, dtype=torch.float64, device=cuda)
    cfg = MorfemConfig(error_threshold=1e-10)
    morfem(domain, *ops, config=cfg)  # warm-up
    timer = PhaseTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    morfem(domain, *ops, config=cfg, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = sum(timer.times.values())
    assert set(timer.times) == {"projection base", "projection",
                                "reduced sweep"}
    assert 0.0 <= wall - phases < 5e-3, (wall, timer.times)


# ----------------------------------------------------------------- K7


def _lu_blocks(b, p, dev, seed, shift=2.0):
    """Packed LU blocks [b, p, p] (partial pivoting, f32) of random
    matrices plus shift·√p·I."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((b, p, p), generator=gen, device=dev)
    a += shift * p**0.5 * torch.eye(p, device=dev)
    return torch.linalg.lu_factor(a).LU.contiguous()  # it is column-major


def _inverse_error(lu, linv, uinv):
    """max |L·linv − I| and max |U·uinv − I| in f64, over the batch."""
    lu = lu.double().reshape(-1, *lu.shape[-2:])
    eye = torch.eye(lu.shape[-1], dtype=torch.float64, device=lu.device)
    lo = torch.tril(lu, -1) + eye
    up = torch.triu(lu)
    el = (lo @ linv.double().reshape(lu.shape) - eye).abs().amax()
    eu = (up @ uinv.double().reshape(lu.shape) - eye).abs().amax()
    return float(el), float(eu)


def _check_k7(lu):
    """K7 on `lu` against its plain version: one launch, contiguous
    outputs shaped as lu, zero off the triangles, unit diagonal of linv,
    inverse errors within 4× the plain version's."""
    reset_launch_counts()
    linv, uinv = tri_inverse(lu)
    torch.cuda.synchronize()
    assert launch_counts()["tri_inverse"] == 1
    assert linv.shape == uinv.shape == lu.shape
    assert linv.is_contiguous() and uinv.is_contiguous()
    ref = tri_inverse_plain(lu)
    assert bool(torch.isfinite(linv).all() and torch.isfinite(uinv).all())
    assert torch.equal(torch.triu(linv, 1), torch.zeros_like(linv))
    assert torch.equal(torch.tril(uinv, -1), torch.zeros_like(uinv))
    assert bool((torch.diagonal(linv, dim1=-2, dim2=-1) == 1).all())
    got_l, got_u = _inverse_error(lu, linv, uinv)
    ref_l, ref_u = _inverse_error(lu, *ref)
    # FP32 substitution in another order than cuBLAS's trsm
    assert got_l <= 4 * ref_l + 1e-6, (got_l, ref_l)
    assert got_u <= 4 * ref_u + 1e-6, (got_u, ref_u)
    return linv, uinv, ref


@pytest.mark.parametrize("p", [384, 128])
@pytest.mark.parametrize("b", [8, 20, 6 * 27])
@pytest.mark.parametrize("layout", ["contiguous", "lug_view"])
def test_tri_inverse_kernel(cuda, p, b, layout):
    """K7 at the panel LU's shapes: the block-pivot factor's [G, 384, 384]
    (G = 8, the sweep's chunk, and 20, the bench's), the full-pivot
    factor's [G·27, 128, 128] (G = 6: the flagship step's seeds), both as
    contiguous blocks and as the diagonal-block view of a factor lug
    [G, nb·P, nb·P] that the full-pivot factor passes."""
    from morfem_tpu_torch.ops.panel_lu import _diagonal_blocks

    blocks = _lu_blocks(b, p, cuda, seed=b + p)
    if layout == "contiguous":
        lu = blocks
    else:
        g, nb = (6, 27) if (b, p) == (6 * 27, 128) else (b // 2, 2)
        gen = torch.Generator(device=cuda).manual_seed(b)
        lug = 0.1 * torch.randn((g, nb * p, nb * p), generator=gen,
                                device=cuda)
        lu = _diagonal_blocks(lug, p)
        lu.copy_(blocks.reshape(g, nb, p, p))
        assert not lu.is_contiguous()
    linv, uinv, ref = _check_k7(lu)
    # well conditioned blocks: the two routes agree closely
    for k, r in zip((linv, uinv), ref):
        assert float((k - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("b,p", [(3, 32), (5, 96), (2, 1472), (2, 1504)])
def test_tri_inverse_kernel_edge_shapes(cuda, b, p):
    """One tile a side; an odd number of tiles; the widest block whose
    column strip fits in shared memory (1472) and one past it, whose
    strip lives in the output in device memory."""
    _check_k7(_lu_blocks(b, p, cuda, seed=p, shift=4.0))


def _waveguide_chunk(dev, g=8):
    """The full-order sweep's first chunk A(t) [g, N, N] (f32) on the
    bundled N=3411 waveguide."""
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, waveguide_system,
    )

    data = load_waveguide_data(n_fallback=3411)
    sys_ = waveguide_system(np.linspace(3e9, 5e9, 100), data, device=dev)
    ops = torch.stack([o.to(torch.float32) for o in sys_.operators()])
    ops = (ops + ops.transpose(1, 2)) * 0.5
    c, _ = sys_.coefficients(sys_.domain[:g])
    return torch.einsum("gp,pij->gij", c.to(torch.float32), ops)


@pytest.mark.parametrize("pivot", ["block", "full"])
def test_tri_inverse_kernel_on_the_waveguide_factors(cuda, monkeypatch,
                                                     pivot):
    """K7 on the blocks that the waveguide's own chunk factors hand it:
    each block step's [8, 384, 384] of the block-pivot factor, and the
    full-pivot factor's [8, 27, 128, 128] view of lug."""
    from morfem_tpu_torch.ops import panel_lu as plu

    seen = []
    real = plu.tri_inverse

    def recorded(lu):
        seen.append(lu.clone())
        return real(lu)

    monkeypatch.setattr(plu, "tri_inverse", recorded)
    a = _waveguide_chunk(cuda)
    if pivot == "block":
        plu.panel_lu_factor_block(a, panel=384)
    else:
        plu.panel_lu_factor(a, panel=128)
    assert len(seen) == (9 if pivot == "block" else 1)
    for lu in seen:
        _check_k7(lu)


def _nonfinite_rows(x):
    return (~torch.isfinite(x)).any(dim=-1)


@pytest.mark.parametrize("p,rows", [(384, [200]), (384, [0, 383]),
                                    (128, [31, 32]), (128, [77])])
def test_tri_inverse_kernel_zero_pivot(cuda, p, rows):
    """A zero pivot makes U's inverse non-finite, as the triangular solve
    does, in the same rows; every entry that needs the pivot is
    non-finite (rows up to it, columns from it) and nothing below it.
    L's inverse stays finite."""
    lu = _lu_blocks(4, p, cuda, seed=p)
    for r in rows:
        lu[1, r, r] = 0.0
    linv, uinv = tri_inverse(lu)
    ref_l, ref_u = tri_inverse_plain(lu)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(linv).all())
    for i in (0, 2, 3):
        assert bool(torch.isfinite(uinv[i]).all())
    bad = ~torch.isfinite(uinv[1])
    r0 = max(rows)
    assert bool(bad[:r0 + 1, r0:].all())
    assert not bool(bad[r0 + 1:].any())
    assert torch.equal(_nonfinite_rows(uinv), _nonfinite_rows(ref_u))
    # K7 poisons only what needs the pivot: within the plain's set
    assert not bool((bad & torch.isfinite(ref_u[1])).any())


def test_tri_inverse_kernel_captures_in_a_cuda_graph(cuda):
    """K7 inside a CUDA graph: it synchronises nothing, the replay equals
    the eager call, and again after new blocks are copied in."""
    lu = _lu_blocks(8, 384, cuda, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tri_inverse(lu)  # warm-up on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reset_launch_counts()
    with torch.cuda.graph(graph):
        out = tri_inverse(lu)
    assert launch_counts()["tri_inverse"] == 1
    for seed in (1, 2):
        lu.copy_(_lu_blocks(8, 384, cuda, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        eager = tri_inverse(lu)
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def _traced_sweep(sys_, cfg):
    """solve_sweep_panel under a trace-mode timer → (x, its span counts,
    chunk_iterations, escalations, captures, replays)."""
    from morfem_tpu_torch.ops.panel_lu import (
        reset_sweep_counters, solve_sweep_panel,
    )
    from morfem_tpu_torch.utils.timing import PhaseTimer

    reset_sweep_counters()
    timer = PhaseTimer(trace=True)
    with timer.span("sweep_call"), timer.phase("full-order sweep"):
        x = solve_sweep_panel(sys_, cfg)
    torch.cuda.synchronize()
    f = solve_sweep_panel
    return (x, dict(timer.counts), list(f.chunk_iterations), f.escalations,
            f.captures, f.replays)


def _eager_sweep(monkeypatch, sys_, cfg):
    """The eager step's sweep on the card: the capture switched off."""
    from morfem_tpu_torch.ops import panel_lu as plu

    with monkeypatch.context() as m:
        m.setattr(plu, "_captures_on", lambda dev: False)
        return _traced_sweep(sys_, cfg)


def test_the_waveguide_sweep_replays_its_captured_step(cuda, monkeypatch):
    """N=3411, 100 points in 13 chunks of 8 (the last one padded): one
    capture, one replay an apply (each chunk's first apply and each step),
    and the eager step's x bit for bit, with the same steps, the same
    ``panel.apply`` and ``refine.step`` spans and the same host reads."""
    from morfem_tpu_torch.apps.waveguide import (
        load_waveguide_data, waveguide_system,
    )
    from morfem_tpu_torch.config import MorfemConfig

    data = load_waveguide_data(n_fallback=3411)
    sys_ = waveguide_system(np.linspace(3e9, 5e9, 100), data, device=cuda)
    cfg = MorfemConfig()
    x, counts, its, esc, captures, replays = _traced_sweep(sys_, cfg)
    x_e, counts_e, its_e, esc_e, captures_e, replays_e = _eager_sweep(
        monkeypatch, sys_, cfg)
    assert torch.equal(x, x_e)
    assert its == its_e and len(its) == 13 and esc == esc_e == 0
    assert (captures, replays) == (1, sum(its) + 13)
    assert captures_e == replays_e == 0
    assert counts.pop("panel.capture") == 1
    assert counts == counts_e
    assert counts["refine.step"] == sum(its)
    assert counts["panel.apply"] == 13


@pytest.mark.parametrize("n,panel", [(256, 128), (1800, 384)])
def test_a_singular_diagonal_block_still_escalates_on_the_card(
        cuda, monkeypatch, n, panel):
    """The leading diagonal block is singular, so every chunk escalates
    to the full-pivot factor, and the sweep equals the eager one bit for
    bit. At N=256 in panels of 128 the full-pivot factor has the block
    factor's shapes and replays too; at N=1800 in panels of 384 its
    panels are 128 wide (`full_pivot_panel`), so it takes the eager step
    and only the block factors' first applies replay (their residual is
    not finite: no step)."""
    from morfem_tpu_torch.compat import system_from_numpy
    from morfem_tpu_torch.config import MorfemConfig

    rng = np.random.default_rng(5)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    a0[:panel, :panel] = 0.0
    z = np.zeros((n, n))
    b = rng.standard_normal((n, 1))
    sys_ = system_from_numpy(np.array([1.0, 2.0, 3.0]), a0, z, z, b,
                             device=cuda)
    cfg = MorfemConfig(factorization="panel", panel_width=panel,
                       solve_chunk=2)
    x, counts, its, esc, captures, replays = _traced_sweep(sys_, cfg)
    x_e, counts_e, its_e, esc_e, _, _ = _eager_sweep(monkeypatch, sys_, cfg)
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x, x_e) and its == its_e
    assert esc == esc_e == counts["panel.escalate"] == 2
    assert captures == 1
    assert replays == (sum(its) + 4 if panel == 128 else 2)
    counts.pop("panel.capture")
    assert counts == counts_e


def test_the_captured_sweep_holds_no_memory_between_calls(cuda):
    """Each call captures its step anew and frees it on return: after the
    first call (the capture stream's cuBLAS workspace) the card's
    allocated memory is the same after every call."""
    from morfem_tpu_torch.compat import system_from_numpy
    from morfem_tpu_torch.config import MorfemConfig
    from morfem_tpu_torch.ops.panel_lu import solve_sweep_panel

    rng = np.random.default_rng(2)
    n = 300
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    sys_ = system_from_numpy(np.linspace(1.0, 2.0, 5), a0, np.zeros((n, n)),
                             -0.01 * np.eye(n), rng.standard_normal((n, 2)),
                             device=cuda)
    cfg = MorfemConfig(factorization="panel", panel_width=128, solve_chunk=2)
    after = []
    for _ in range(4):
        solve_sweep_panel(sys_, cfg)
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda))
    assert solve_sweep_panel.captures >= 4
    assert after[1] == after[2] == after[3], after


def test_the_batched_schur_inverses_on_the_tiled_waveguide(cuda):
    """The banded sweep's batched route (`_invert_points`: the panel LU's
    K1–K3 and K7, the substitutions on K2) on the [8, 3,456, 3,456] Schur
    complements that the first chunk of the tiled waveguide (N=34,110)
    inverts at block steps 0 and 5 (`chip_smoke.schur_complements`).
    Against the float64 inverse (`chip_smoke.inverse_quality`), each
    point's S⁻¹ is off by at most 0.02·κ_F(S)·ε relative to its norm
    (κ_F = ‖S‖_F·‖S⁻¹‖_F; measured ≤ 0.002·κ_F·ε here, 0.0093 on the CPU
    test's blocks), as `inv_ex`'s is, so the two lie within 0.04·κ_F·ε of
    each other; each 128-wide column panel of
    S·X − I and row panel of X·S − I stays within 4× `inv_ex`'s largest
    (measured ≤ 2.4×): one panel of X left wrong reads about 1 there."""
    import chip_smoke as cs
    from morfem_tpu_torch.ops import block_tridiag as bt

    sys_ = cs.tiled_waveguide_chunk(cuda)
    seen = cs.schur_complements(sys_, (0, 5))
    del sys_
    eps = torch.finfo(torch.float32).eps
    reset_launch_counts()
    for s in seen.values():
        assert s.shape == (8, 3456, 3456)
        x, x_ex = bt._invert_points(s), bt._inverse_each(s)
        got, each = cs.inverse_quality(s, (x, x_ex))
        limit = 0.02 * got["kappa"] * eps
        apart = (torch.linalg.norm((x - x_ex).double(), dim=(1, 2))
                 / torch.linalg.norm(x_ex.double(), dim=(1, 2)))
        print("kappa_F", got["kappa"].tolist(), "batched, inv_ex",
              {k: (got[k].tolist(), each[k].tolist())
               for k in ("err", "right", "left")}, "apart", apart.tolist())
        assert bool((got["err"] <= limit).all())
        assert bool((each["err"] <= limit).all())
        assert bool((apart <= 2 * limit).all())
        assert bool((got["right"] <= 4 * each["right"]).all())
        assert bool((got["left"] <= 4 * each["left"]).all())
    counts = launch_counts()
    assert counts["panel_factor"] == 2 * 27 and counts["tri_inverse"] == 2
    assert counts["mm_words"] > 0


def test_a_singular_schur_complement_poisons_its_point_alone_on_the_card(
        cuda):
    """Eight points a step at b = 3,456, the fourth point's first Schur
    complement exactly singular (a zero column: K1 meets a zero pivot in
    its eighth panel): through K1 and K7 that point's g turns non-finite
    from that block on (the blocks are coupled), and its apply; the other
    seven points' stay finite."""
    from morfem_tpu_torch.ops import block_tridiag as bt

    b = 3456
    gen = torch.Generator(device=cuda).manual_seed(4)
    d = (torch.randn((8, 2, b, b), generator=gen, device=cuda)
         + 4 * b ** 0.5 * torch.eye(b, device=cuda))
    d[3, 0, :, 1000] = 0.0
    l, u = torch.zeros_like(d), torch.zeros_like(d)
    u[:, 0, b - 1, 0] = l[:, 1, 0, b - 1] = 0.5
    reset_launch_counts()
    bt.reset_factor_counters()
    fac = bt.block_tridiag_factor(l, d, u, 2 * b)
    assert bt.block_tridiag_factor.batched_inverses == [8, 8]
    assert launch_counts()["panel_factor"] == 2 * 27
    finite = torch.isfinite(fac.g).all(dim=(-2, -1)).tolist()
    assert finite == [[p != 3] * 2 for p in range(8)]
    x = bt.block_tridiag_apply(fac, torch.ones((8, 2 * b, 1), device=cuda))
    assert torch.isfinite(x).all(dim=(1, 2)).tolist() == [
        p != 3 for p in range(8)]
