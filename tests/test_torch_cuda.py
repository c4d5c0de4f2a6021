"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the main path against numpy.  Every test here needs an
NVIDIA card and skips without one.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu_torch.models.fft import fft, fft_planes_fast
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err

# kernel vs plain version: same float32 ops, except nvcc's FMA contraction
FP32_TOL = 1e-6
# whole transform vs float64 numpy: the split3 budget
SPLIT3_TOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(seed, shape, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(device)
                 for _ in range(2))


@pytest.mark.parametrize("rows,tile", [(8, 128), (8, 1024), (64, 1 << 14)])
def test_tile_fft_kernel_vs_plain(cuda_device, rows, tile):
    xr, xi = _planes(31, (rows, tile), cuda_device)
    tw = twiddle.flat_tables(tile, cuda_device)
    before = cf.tile_fft.launches
    yk = cf.tile_fft(xr, xi, *tw)
    assert cf.tile_fft.launches == before + 1
    yp = cf.tile_fft_plain(xr, xi, *tw)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("batch,R,C,cb", [(1, 64, 1 << 14, 32),
                                         (3, 4, 1 << 14, 32),
                                         (2, 8, 512, 8)])
def test_long_range_kernel_vs_plain(cuda_device, batch, R, C, cb):
    xr, xi = _planes(32, (batch, R, C), cuda_device)
    fac = twiddle.device_factors(R, C, cuda_device)
    before = cf.long_range_sep.launches
    yk = cf.long_range_sep(xr, xi, *fac, cb=cb)
    assert cf.long_range_sep.launches == before + 1
    yp = cf.long_range_sep_plain(xr, xi, *fac)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("shape", [(1 << 20,), (64, 4096), (3, 1 << 16)])
def test_main_path_on_card_vs_numpy(cuda_device, shape):
    rng = np.random.default_rng(33)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    y = fft(x).cpu().numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    assert rel_err(y.real, y.imag, ref.real, ref.imag) <= SPLIT3_TOL
    yr, yi = fft_planes_fast(x.real, x.imag)
    assert yr.device.type == "cuda"
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL


def test_bad_launch_raises(cuda_device):
    # a tile kernel whose tables live on another device never launches
    xr, xi = _planes(34, (2, 256), cuda_device)
    twr, twi = twiddle.flat_tables(256, torch.device("cpu"))
    with pytest.raises(ValueError, match="operand on cpu"):
        cf.tile_fft(xr, xi, twr, twi)
