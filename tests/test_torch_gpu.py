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

from morfem_tpu_torch.ops.kernels import (
    gather_rows,
    gather_rows_plain,
    launch_counts,
    mm_words,
    mm_words_plain,
    panel_factor,
    panel_factor_plain,
    reset_launch_counts,
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
