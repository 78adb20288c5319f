"""The port's studies and data tooling against the JAX package's, on the
CPU: `basis_size_study` (1e-8 relative on rel_error), `upscale_block_diag`
(exact), `upscale_interpolate` (1e-12) and the CSV converter (exact).
"""

import numpy as np
import pytest
import torch

from morfem_tpu.apps import studies as js
from morfem_tpu.apps import waveguide as jwg
from morfem_tpu.config import MorfemConfig as JConfig
from morfem_tpu.utils import data_convert as jdc

from morfem_tpu_torch import MorfemConfig, equally_distributed_basis, project
from morfem_tpu_torch.apps import studies as ts
from morfem_tpu_torch.apps import waveguide as twg
from morfem_tpu_torch.mor.reduced import sweep
from morfem_tpu_torch.ops.solve import solve_sweep
from morfem_tpu_torch.utils import data_convert as tdc

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(n=160, pts=41):
    data = twg.load_waveguide_data(n_fallback=n)
    freq = np.linspace(3e9, 5e9, pts)
    return (jwg.waveguide_system(freq, data),
            twg.waveguide_system(freq, data, device=CPU))


def test_basis_size_study_matches_the_jax_package():
    sys_j, sys_t = _systems()
    sizes = range(3, 10)
    st = ts.basis_size_study(sys_t, sizes, MorfemConfig())
    sj = js.basis_size_study(sys_j, sizes, JConfig())
    np.testing.assert_array_equal(st.sizes, sj.sizes)
    np.testing.assert_array_equal(st.ncols, sj.ncols)
    assert tuple(st.x.shape) == tuple(sj.x.shape)
    assert tuple(st.q.shape) == tuple(sj.q.shape)
    np.testing.assert_allclose(st.rel_error, sj.rel_error, rtol=1e-8)
    assert st.rel_error[-1] < st.rel_error[0]


def test_basis_size_study_equals_an_independent_recompute():
    """rel_error at a size = the equally-distributed basis of that many
    seeds, projected, swept and reconstructed (1e-10 relative)."""
    _, sys_t = _systems(n=120, pts=31)
    cfg = MorfemConfig()
    x_full = solve_sweep(sys_t, cfg)
    st = ts.basis_size_study(sys_t, [4, 7], cfg, x_full=x_full)
    for s, rel in zip(st.sizes, st.rel_error):
        q = equally_distributed_basis(sys_t, cfg, count=int(s))
        x = sweep(project(sys_t, q), cfg)
        rec = torch.einsum("nk,ikm->inm", q, x)
        ref = float(torch.linalg.norm(rec - x_full) / torch.linalg.norm(
            x_full))
        assert abs(rel - ref) <= 1e-10 * ref


def test_upscale_block_diag_is_exact():
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal((7, 7)) for _ in range(3)]
    b = rng.standard_normal((7, 2))
    out_t, b_t = ts.upscale_block_diag(mats, b, 3)
    out_j, b_j = js.upscale_block_diag(mats, b, 3)
    for x, y in zip(out_t, out_j):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b_t, b_j)


@pytest.mark.parametrize("n,rate", [(20, 2.5), (17, 3), (21, 1.7),
                                    (30, 0.5), (40, 0.3)])
def test_upscale_interpolate_matches_the_jax_package(n, rate):
    """Up- and down-sampling (the reference antialiases when shrinking)."""
    a = np.random.default_rng(n).standard_normal((n, n))
    x = ts.upscale_interpolate(a, rate, device=CPU)
    y = js.upscale_interpolate(a, rate)
    assert x.shape == y.shape == (round(n * rate),) * 2
    assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max()
    np.testing.assert_array_equal(x, x.T)


def test_bilinear_upsampling_agrees_with_torch_interpolate():
    """Where the edge handling agrees (upsampling, half-pixel centres,
    no antialiasing), the reference's resize equals PyTorch's bilinear
    interpolate."""
    a = np.random.default_rng(3).standard_normal((19, 19))
    t = torch.nn.functional.interpolate(
        torch.from_numpy(a)[None, None], size=(47, 47), mode="bilinear",
        align_corners=False, antialias=False)[0, 0].numpy()
    x = ts.upscale_interpolate(a, 47 / 19, device=CPU)
    assert np.abs(x - (t + t.T) / 2).max() <= 1e-12 * np.abs(x).max()


def test_convert_csv_matches_the_jax_package(tmp_path):
    a = np.random.default_rng(1).standard_normal((5, 3))
    src = tmp_path / "csv"
    src.mkdir()
    np.savetxt(src / "Ct.csv", a, delimiter=",")
    np.savetxt(src / "kTE1.csv", np.array([[54.6]]), delimiter=",")
    out_t = tdc.convert_csv_dir(str(src), str(tmp_path / "t"))
    out_j = jdc.convert_csv_dir(str(src), str(tmp_path / "j"))
    assert out_t == out_j == {"Ct": (5, 3), "kTE1": (1, 1)}
    for name in out_t:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f"{name}.npy"),
                                      np.load(tmp_path / "j" / f"{name}.npy"))
    arr = tdc.convert_csv_file(str(src / "Ct.csv"), str(tmp_path / "x.npy"))
    np.testing.assert_array_equal(arr, jdc.convert_csv_file(
        str(src / "Ct.csv"), str(tmp_path / "y.npy")))
    assert tdc.main([str(src), str(tmp_path / "m")]) == 0
    assert tdc.main(["only-one"]) == 2
