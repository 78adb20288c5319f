"""K7 `tri_inverse` (ops/kernels/tri_inverse.py) and its place in the panel
LU, on the CPU.

A CPU tensor takes the plain version, the port's earlier route (two
triangular solves against an identity), so these tests hold the wrapper's
contract, the plain version against the JAX package's inverses
(`_unit_lower_inv`, `_upper_inv`) on the same blocks, and the panel LU's
calls: one per block step of the block-pivot factor, one per full-pivot
factor, each inside a ``panel.invert`` span. The kernel itself is held
against the plain version on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl
import torch

from morfem_tpu.ops.panel_lu import _unit_lower_inv, _upper_inv
from morfem_tpu_torch.config import MorfemConfig
from morfem_tpu_torch.ops import panel_lu as panel_lu_mod
from morfem_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    tri_inverse,
    tri_inverse_plain,
)
from morfem_tpu_torch.ops.panel_lu import (
    panel_lu_factor,
    panel_lu_factor_block,
    reset_sweep_counters,
    solve_sweep_panel,
)
from morfem_tpu_torch.compat import system_from_numpy
from morfem_tpu_torch.utils.timing import PhaseTimer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed_lu(shape, seed=0, shift=0.0):
    """Packed LU factors with partial pivoting of random blocks (plus
    ``shift``·√P·I), f32."""
    rng = np.random.default_rng(seed)
    *batch, p, _ = shape
    a = rng.standard_normal((int(np.prod(batch, dtype=int)), p, p))
    a += shift * np.sqrt(p) * np.eye(p)
    out = np.empty_like(a)
    for i, blk in enumerate(a):
        _, l, u = sl.lu(blk)
        out[i] = np.tril(l, -1) + u
    return torch.from_numpy(out.reshape(shape).astype(np.float32))


def _jax_inverses(d):
    """The JAX package's inverses of the same packed blocks:
    `_unit_lower_inv(tril(d, -1) + I)` and `_upper_inv(triu(d))`."""
    a = jnp.asarray(d.numpy())
    eye = jnp.eye(d.shape[-1], dtype=jnp.float32)
    return (torch.from_numpy(np.array(_unit_lower_inv(jnp.tril(a, -1)
                                                      + eye))),
            torch.from_numpy(np.array(_upper_inv(jnp.triu(a)))))


def _assert_close_to_jax(d, linv, uinv, rtol):
    """Each inverse within ``rtol`` of the JAX package's, relative to
    the block's largest entry."""
    for got, ref in zip((linv, uinv), _jax_inverses(d)):
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        err = float(((got - ref).abs() / scale).max())
        assert err <= rtol, err


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((2, 64, 64), dtype=torch.float64), "f32-only"),
    (torch.zeros((2, 64, 96)), "square"),
    (torch.zeros((2, 48, 48)), "multiple of 32"),
    (torch.zeros((1, 0, 0)), "multiple of 32"),
    (torch.zeros((64, 64)), r"\[B, P, P\]"),
    (torch.zeros((1, 1, 1, 32, 32)), r"\[B, P, P\]"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        tri_inverse(bad)
    with pytest.raises(ValueError, match=match):
        tri_inverse_plain(bad)


@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 96, 96), (2, 3, 32, 32)])
def test_a_cpu_tensor_takes_the_plain_version(shape):
    lu = _packed_lu(shape, seed=len(shape))
    reset_launch_counts()
    linv, uinv = tri_inverse(lu)
    assert launch_counts()["tri_inverse"] == 0
    ref = tri_inverse_plain(lu)
    assert torch.equal(linv, ref[0]) and torch.equal(uinv, ref[1])
    assert linv.shape == uinv.shape == lu.shape


# random blocks: the JAX package's log-squaring loses ~3e-5 of the
# largest entry (the float64 inverse's error, not the plain version's);
# blocks plus 2·√P·I: both within 1e-7 of it
@pytest.mark.parametrize("shift,rtol", [(0.0, 1e-4), (2.0, 1e-6)])
@pytest.mark.parametrize("shape", [(8, 128, 128), (2, 384, 384)])
def test_the_plain_version_matches_the_jax_inverses(shape, shift, rtol):
    lu = _packed_lu(shape, seed=shape[-1], shift=shift)
    _assert_close_to_jax(lu, *tri_inverse_plain(lu), rtol)


def test_the_full_pivot_view_is_the_old_stacked_route_bit_for_bit():
    g, nb, p = 2, 3, 128
    lug = torch.randn((g, nb * p, nb * p), generator=torch.Generator()
                      .manual_seed(1)) + 2 * torch.eye(nb * p)
    view = panel_lu_mod._diagonal_blocks(lug, p)
    assert view.shape == (g, nb, p, p)
    assert view.untyped_storage().data_ptr() == (
        lug.untyped_storage().data_ptr())  # a view, no copy
    stacked = torch.stack([lug[:, k * p:(k + 1) * p, k * p:(k + 1) * p]
                           for k in range(nb)], dim=1)
    assert torch.equal(view, stacked)
    got = tri_inverse(view)
    ref = tri_inverse_plain(stacked)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_the_inverses_invert_and_keep_to_their_triangles():
    lu = _packed_lu((4, 128, 128), seed=7, shift=2.0).double()
    linv, uinv = tri_inverse_plain(lu.float())
    eye = torch.eye(128, dtype=torch.float64)
    lo = torch.tril(lu, -1) + eye
    assert float((lo @ linv.double() - eye).abs().max()) < 1e-4
    assert float((torch.triu(lu) @ uinv.double() - eye).abs().max()) < 1e-4
    assert torch.equal(torch.triu(linv, 1), torch.zeros_like(linv))
    assert torch.equal(torch.diagonal(linv, dim1=-2, dim2=-1),
                       torch.ones((4, 128)))
    assert torch.equal(torch.tril(uinv, -1), torch.zeros_like(uinv))


def test_a_zero_pivot_gives_a_non_finite_upper_inverse():
    lu = _packed_lu((2, 64, 64), seed=3, shift=2.0)
    lu[1, 40, 40] = 0.0
    linv, uinv = tri_inverse(lu)
    assert bool(torch.isfinite(linv).all())
    assert bool(torch.isfinite(uinv[0]).all())
    # every entry that needs the zero pivot (rows up to 40, columns from
    # 40) is non-finite; rows below it never see it. (A blocked solve may
    # also poison the rows' other columns: the CPU's does.)
    bad = ~torch.isfinite(uinv[1])
    assert bool(bad[:41, 40:].all())
    assert not bool(bad[41:].any())


def _count_k7(monkeypatch):
    shapes = []
    real = panel_lu_mod.tri_inverse

    def counted(lu):
        shapes.append(tuple(lu.shape))
        return real(lu)

    monkeypatch.setattr(panel_lu_mod, "tri_inverse", counted)
    return shapes


@pytest.mark.parametrize("n,panel", [(300, 128), (256, 256), (128, 128)])
def test_the_block_factor_inverts_once_per_block_step(monkeypatch, n, panel):
    shapes = _count_k7(monkeypatch)
    a = torch.randn((2, n, n), dtype=torch.float64) + 3 * n**0.5 * (
        torch.eye(n, dtype=torch.float64))
    f = panel_lu_factor_block(a, panel=panel)
    nb = -(-n // panel)
    assert shapes == [(2, panel, panel)] * nb
    assert f.linv.shape == f.uinv.shape == (2, nb, panel, panel)


@pytest.mark.parametrize("n,panel", [(300, 128), (256, 256)])
def test_the_full_factor_inverts_once(monkeypatch, n, panel):
    shapes = _count_k7(monkeypatch)
    a = torch.randn((3, n, n), dtype=torch.float64) + 3 * n**0.5 * (
        torch.eye(n, dtype=torch.float64))
    f = panel_lu_factor(a, panel=panel)
    nb = -(-n // panel)
    assert shapes == [(3, nb, panel, panel)]
    # the diagonal blocks of lug, stacked and inverted by the plain
    # version, and by the JAX package
    blocks = torch.stack([f.lug[:, k * panel:(k + 1) * panel,
                                k * panel:(k + 1) * panel]
                          for k in range(nb)], dim=1)
    ref = tri_inverse_plain(blocks)
    assert torch.equal(f.linv, ref[0]) and torch.equal(f.uinv, ref[1])
    _assert_close_to_jax(blocks, f.linv, f.uinv, 1e-6)


def _sweep_system(singular, n=256, seed=5):
    rng = np.random.default_rng(seed)
    a0 = rng.standard_normal((n, n))
    a0 = a0 + a0.T + 4 * np.sqrt(n) * np.eye(n)
    if singular:
        a0[:128, :128] = 0.0  # block pivoting must escalate
    z = np.zeros((n, n))
    b = rng.standard_normal((n, 1))
    return system_from_numpy(np.array([1.0, 2.0, 3.0]), a0, z, z, b,
                             device="cpu")


@pytest.mark.parametrize("singular", [False, True])
def test_each_inversion_is_one_panel_invert_span_in_its_factor(singular):
    cfg = MorfemConfig(factorization="panel", panel_width=128, solve_chunk=2)
    timer = PhaseTimer(trace=True)
    reset_sweep_counters()
    with timer.span("sweep_call"), timer.phase("full-order sweep"):
        solve_sweep_panel(_sweep_system(singular), cfg)
    chunks = timer.counts["panel.chunk"]
    escalations = solve_sweep_panel.escalations
    assert escalations == (chunks if singular else 0)
    # two blocks of 128 a block-pivot factor, one call a full-pivot one
    assert timer.counts["panel.invert"] == 2 * chunks + escalations
    for s in timer.spans:
        if s.name == "panel.invert":
            assert timer.spans[s.parent].name == "panel.factor"
