"""The port's kernel modules (K1-K3) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Inputs
are made with numpy from fixed seeds and fed to both. The CUDA kernels
themselves are held against the same plain versions on the card by
`chip_smoke.py` (no CUDA kernel runs here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morfem_tpu.ops.pallas.fused_mm import _split_words as jax_split_words
from morfem_tpu.ops.pallas.fused_mm import mm_words as jax_mm_words
from morfem_tpu.ops.pallas.panel_factor import panel_factor as jax_panel_factor
from morfem_tpu.ops.pallas.row_gather import gather_rows as jax_gather_rows
from morfem_tpu_torch.ops.kernels import (
    banded_matvec_padded,
    bsr_matmul_f32,
    gather_rows,
    gauss_jordan_sweep_solve,
    launch_counts,
    mm_words,
    panel_factor,
    panel_factor_plain,
    reset_launch_counts,
    tri_inverse,
)
from morfem_tpu_torch.ops.kernels.fused_mm import (
    mm_words_split_plain,
    split_words_plain,
)
from morfem_tpu_torch.ops.kernels.panel_factor import panel_factor_plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes on a shared CPU, and a full thread pool per process
    oversubscribes it (these are small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "g,p,npl,used", [(2, 16, 128, 0), (2, 128, 256, 64), (1, 8, 384, 100),
                     # lanes a multiple of neither 8 nor 16 (ragged CTAs)
                     (1, 32, 200, 40)]
)
def test_panel_factor_matches_pallas(g, p, npl, used):
    rng = np.random.default_rng(100 + p + used)
    pt = rng.standard_normal((g, p, npl)).astype(np.float32)
    av = np.ones((g, npl), np.float32)
    for i in range(g):
        av[i, rng.choice(npl, used, replace=False)] = 0.0
    ref = [np.asarray(x) for x in jax_panel_factor(pt, av, interpret=True)]
    got = [x.numpy() for x in panel_factor(torch.from_numpy(pt),
                                           torch.from_numpy(av))]
    # pivot sequences and availability must match exactly
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[3], ref[3])
    # the reference blocks the column steps by 8 with rank-8 updates, the
    # port eliminates one column at a time: the same algebra rounded in
    # another order, ~1e-6 of the entries' scale in f32 at these widths
    for a, b in ((got[0], ref[0]), (got[1], ref[1])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_panel_factor_lowest_index_wins_ties():
    # two available rows with the same |value|: the lower index pivots
    pt = np.zeros((1, 8, 128), np.float32)
    pt[0, :, :] = np.eye(8, 128, dtype=np.float32)
    pt[0, 0, 5] = -1.0  # |pt[0, 5]| == |pt[0, 0]|
    pt[0, 0, 3] = 1.0
    av = np.ones((1, 128), np.float32)
    ref = np.asarray(jax_panel_factor(pt, av, interpret=True)[2])
    got = panel_factor(torch.from_numpy(pt), torch.from_numpy(av))[2].numpy()
    assert got[0, 0] == 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("used", [0, 100])
def test_panel_factor_without_coefficients_is_the_same_factor(used):
    # want_ct=False skips C̃ (the block-pivot LU discards it); fac, pivots
    # and availability stay bit for bit those of want_ct=True
    rng = np.random.default_rng(40 + used)
    pt = torch.from_numpy(rng.standard_normal((2, 96, 384)).astype(np.float32))
    av = torch.ones((2, 384))
    av[:, torch.from_numpy(rng.choice(384, used, replace=False))] = 0.0
    fac, ct, piv, avn = panel_factor_plain(pt, av, want_ct=True)
    fac2, ct2, piv2, avn2 = panel_factor_plain(pt, av, want_ct=False)
    assert ct is not None and ct2 is None
    for a, b in ((fac, fac2), (piv, piv2), (avn, avn2)):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a,
                           b.view(torch.int32) if b.is_floating_point()
                           else b)
    assert panel_factor(pt, av, want_ct=False)[1] is None


@pytest.mark.parametrize("shape,want_ct,variant", [
    ((384, 384), False, "cluster8"),   # the block-pivot diagonal blocks
    ((384, 384), True, "cluster8"),    # one buffer: half of two
    ((128, 3456), True, "cluster8"),   # full pivot with C̃: 225 KB a CTA
    ((128, 3456), False, "cluster8"),
    ((24, 200), True, "cluster8"),
    ((384, 1536), True, "cluster16"),  # full_pivot_panel keeps 384 here
    ((128, 8192), True, "cluster_global"),  # dense_cutoff: 270 KB on 16
])
def test_panel_factor_picks_its_kernel_by_shape(shape, want_ct, variant):
    assert panel_factor_plan(*shape, want_ct).variant == variant


@pytest.mark.parametrize("shape,cluster,smem", [
    ((128, 3456), 8, 230_536),   # 432 lanes x 132 x 4 + mask, column, slots
    ((384, 384), 8, 76_424),     # two [P, L] buffers took 151,104
    ((384, 1536), 16, 151_304),  # 96 lanes x 388 x 4 + the rest
])
def test_panel_factor_keeps_one_buffer_per_cta(shape, cluster, smem):
    # C̃ and the live panel rows share one [P, L] buffer, so C̃ costs no
    # shared memory
    with_ct = panel_factor_plan(*shape, True)
    assert with_ct == panel_factor_plan(*shape, False)
    assert (with_ct.cluster, with_ct.smem) == (cluster, smem)
    assert with_ct.in_smem and with_ct.lanes * cluster >= shape[1]


def test_panel_factor_plan_without_16_cta_clusters():
    # where the card cannot place a 16-CTA cluster, such shapes keep their
    # lanes in device memory over 8 CTAs; nothing gets one CTA per entry
    def never(*_):
        return False

    assert panel_factor_plan(128, 3456, True, never).variant == "cluster8"
    for p, npl in ((384, 1536), (128, 8192)):
        plan = panel_factor_plan(p, npl, True, never)
        assert (plan.variant, plan.cluster) == ("cluster_global", 8)


def _bits(x):
    return np.asarray(x).view(np.uint16)


def test_split_words_match_the_reference_bit_for_bit():
    special = np.array([
        0x00000000, 0x80000000,              # ±0
        0x7F800000, 0xFF800000,              # ±inf
        0x3F808000, 0xBF808000,              # a tie rounds away from zero
        0x3F7F8000, 0x3FFFFFFF, 0x7F7FFFFF,  # mantissa carry into exponent
        0x7FFF8000, 0x7FFF7FFF, 0xFFFF8000,  # NaN payloads near the carry
        0x7FFFFFFF, 0x7F800001, 0xFFC00000,
        0x00000001, 0x807FFFFF, 0x00800000,  # subnormals, the smallest normal
    ], dtype=np.uint32)
    rng = np.random.default_rng(9)
    x = np.concatenate([
        special,
        rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32),
        (rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000))
        .astype(np.float32).view(np.uint32),
    ]).view(np.float32)
    ref = jax_split_words(jnp.asarray(x), 3)
    got = split_words_plain(torch.from_numpy(x.copy()))
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g.view(torch.int16).numpy()),
                                      _bits(r))
    # and the words sum back to x exactly, away from the flushed
    # subnormal residuals and the rounding overflow next to FLT_MAX
    fin = (np.abs(x) >= 2.0 ** -100) & (np.abs(x) <= 2.0 ** 100)
    total = sum(w.double() for w in got).numpy()
    np.testing.assert_array_equal(total[fin], x[fin].astype(np.float64))


@pytest.mark.parametrize("with_t,sign", [(False, 1), (True, -1)])
def test_word_split_product_matches_pallas(with_t, sign):
    rng = np.random.default_rng(17 + with_t)
    g, m, k, n = 2, 128, 384, 256
    c = rng.standard_normal((g, m, k)).astype(np.float32)
    r = (rng.standard_normal((g, k, n)) * 1e3).astype(np.float32)
    t = rng.standard_normal((g, m, n)).astype(np.float32) if with_t else None
    ref = np.asarray(jax_mm_words(c, r, t, sign=sign, interpret=True))
    got = mm_words_split_plain(
        torch.from_numpy(c), torch.from_numpy(r),
        None if t is None else torch.from_numpy(t), sign=sign).numpy()
    # the same six exact word products, summed in f32 over K=384 in
    # another order: f32 rounding, ~1e-7 of the |c|·|r| (+|t|) scale
    scale = np.abs(c).astype(np.float64) @ np.abs(r)
    if t is not None:
        scale = scale + np.abs(t)
    assert np.abs(got - ref).max() <= 1e-6 * scale.max()


@pytest.mark.parametrize("with_t,sign", [(False, 1), (True, 1), (True, -1)])
def test_mm_words_matches_pallas(with_t, sign):
    rng = np.random.default_rng(7 + sign + 2 * with_t)
    g, m, k, n = 2, 128, 256, 128
    c = rng.standard_normal((g, m, k)).astype(np.float32)
    r = rng.standard_normal((g, k, n)).astype(np.float32)
    t = rng.standard_normal((g, m, n)).astype(np.float32) if with_t else None
    ref = np.asarray(jax_mm_words(c, r, t, sign=sign, interpret=True))
    got = mm_words(
        torch.from_numpy(c), torch.from_numpy(r),
        None if t is None else torch.from_numpy(t), sign=sign,
    ).numpy()
    # both are f32-true products (3-word bf16 split vs FP32), summed over
    # K=256 in different orders: f32 rounding, ~1e-7 relative per term
    scale = np.abs(c).astype(np.float64) @ np.abs(r)
    if t is not None:
        scale = scale + np.abs(t)
    assert np.abs(got - ref).max() <= 1e-6 * scale.max()


def test_mm_words_strided_views_and_ragged_shapes():
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.standard_normal((2, 70, 50)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 50, 90)).astype(np.float32))
    out = mm_words(c.transpose(1, 2).contiguous().transpose(1, 2), r)
    ref = c.double() @ r.double()
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_mm_words_rejects_bad_shapes():
    c = torch.zeros((1, 128, 128))
    with pytest.raises(ValueError):
        mm_words(c, torch.zeros((1, 64, 128)))
    with pytest.raises(ValueError):
        mm_words(c, torch.zeros((1, 128, 128)), torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError):
        mm_words(c.double(), torch.zeros((1, 128, 128)).double())


# the source as the panel LU passes it: a contiguous block, a trailing
# sub-block view, and a view whose rows start off a 16-byte boundary
_GATHER_VIEWS = {
    "contiguous": (slice(None), slice(8, None), slice(4, 132)),
    "panel-LU view": (slice(None), slice(8, None), slice(128, 256)),
    "column offset 1": (slice(None), slice(8, None), slice(1, 129)),
}


@pytest.mark.parametrize("view", list(_GATHER_VIEWS))
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("p", [128, 256])
def test_gather_rows_matches_pallas(p, idx_dtype, view):
    # the port takes the indices in the caller's type (int32 as the panel
    # factor gives them, or int64) and a strided source; the reference is
    # given int32 and a contiguous copy
    rng = np.random.default_rng(p)
    g, n, w = 2, 256, 128
    big = rng.standard_normal((g, n + 8, 260)).astype(np.float32)
    src = torch.from_numpy(big)[_GATHER_VIEWS[view]]
    if view == "contiguous":
        src = src.contiguous()
    assert src.shape == (g, n, w)
    idx = np.stack([rng.permutation(n)[:p] for _ in range(g)]).astype(np.int32)
    ref = np.asarray(jax_gather_rows(src.contiguous().numpy(), idx,
                                     interpret=True))
    got = gather_rows(src, torch.from_numpy(idx.astype(idx_dtype))).numpy()
    np.testing.assert_array_equal(got, ref)  # a gather is exact


@pytest.mark.parametrize(
    "shape,idx_shape,dtype",
    [
        ((1, 256, 128), (1, 100), torch.float32),  # P % 128
        ((1, 252, 128), (1, 128), torch.float32),  # N % 8
        ((1, 256, 100), (1, 128), torch.float32),  # W % 128
        ((2, 256, 128), (1, 128), torch.float32),  # batch mismatch
        ((1, 256, 128), (1, 128), torch.float64),  # f32 only
    ],
)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_rejects_what_the_reference_rejects(shape, idx_shape,
                                                        dtype, idx_dtype):
    src = torch.zeros(shape, dtype=dtype)
    idx = torch.zeros(idx_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_rows(src, idx.to(idx_dtype))
    with pytest.raises(ValueError):
        jax_gather_rows(src.numpy(), idx.numpy(), interpret=True)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    reset_launch_counts()
    x = torch.ones((1, 128, 128))
    panel_factor(torch.eye(8, 128)[None].contiguous(), torch.ones((1, 128)))
    mm_words(x, x)
    gather_rows(x, torch.zeros((1, 128), dtype=torch.int32))
    eye = torch.eye(4)
    gauss_jordan_sweep_solve(eye, eye, eye, torch.ones((2, 3)),
                             torch.ones((2, 4, 1)), torch.zeros(4))
    banded_matvec_padded(torch.ones((5, 3)), 5, 3, 1, torch.ones((5, 2)))
    bsr_matmul_f32(torch.ones((32, 128)), torch.zeros(1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), 1, 1, 20, 32, 128,
                   torch.ones((20, 2)))
    tri_inverse(x)
    assert launch_counts() == {
        "panel_factor": 0, "mm_words": 0, "gather_rows": 0,
        "gauss_jordan_sweep_solve": 0, "banded_matvec_padded": 0,
        "bsr_matmul_f32": 0, "tri_inverse": 0,
    }
