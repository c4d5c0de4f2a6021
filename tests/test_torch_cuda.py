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
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
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


@pytest.mark.parametrize("R,tile,cb", [(1024, 1 << 14, 16), (64, 4096, 64),
                                       (4, 512, 8), (2, 1 << 14, 4096)])
def test_fourstep_kernel_vs_plain(cuda_device, R, tile, cb):
    # (1024, 2^14, 16): 1024 column blocks and 1024 rows, both more than
    # the persistent grid of one block per SM
    xr, xi = _planes(35, (R, tile), cuda_device)
    args = (xr, xi, *twiddle.device_factors(R, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.fourstep.launches
    yk = cf.fourstep(*args, cb=cb)
    torch.cuda.synchronize()
    assert cf.fourstep.launches == before + 1
    assert rel_err(*yk, *cf.fourstep_plain(*args)) <= FP32_TOL


@pytest.mark.parametrize("R1,R2,tile,cb1,cb2", [
    (64, 32, 1 << 14, 256, 512),   # the n = 2^25 plan's blocking
    (256, 4, 4096, 32, 256),       # R1 != R2, 2048 outer blocks
    (2, 8, 1024, 8, 1024),         # R1 < R2
    (4, 4, 512, 512, 8)])
def test_sixstep_kernel_vs_plain(cuda_device, R1, R2, tile, cb1, cb2):
    xr, xi = _planes(36, (R1, R2, tile), cuda_device)
    args = (xr, xi, *twiddle.device_factors(R1, R2 * tile, cuda_device),
            *twiddle.device_factors(R2, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.sixstep.launches
    yk = cf.sixstep(*args, cb1=cb1, cb2=cb2)
    torch.cuda.synchronize()
    assert cf.sixstep.launches == before + 1
    assert rel_err(*yk, *cf.sixstep_plain(*args)) <= FP32_TOL


@pytest.mark.parametrize("n,variant", [(1 << 21, "fourstep"),
                                       (1 << 25, "sixstep")])
def test_large_n_path_on_card_vs_numpy(cuda_device, n, variant):
    rng = np.random.default_rng(37)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    kernel = getattr(cf, variant)
    before = (kernel.launches, cf.tile_fft.launches,
              cf.long_range_sep.launches)
    y = fft(x).cpu().numpy()
    assert (kernel.launches, cf.tile_fft.launches,
            cf.long_range_sep.launches) == (before[0] + 1, *before[1:])
    ref = np.fft.fft(x.astype(np.complex128))
    assert rel_err(y.real, y.imag, ref.real, ref.imag) <= SPLIT3_TOL


def test_bad_launch_raises(cuda_device):
    # a tile kernel whose tables live on another device never launches
    xr, xi = _planes(34, (2, 256), cuda_device)
    twr, twi = twiddle.flat_tables(256, torch.device("cpu"))
    with pytest.raises(ValueError, match="operand on cpu"):
        cf.tile_fft(xr, xi, twr, twi)


@pytest.mark.parametrize("batch,R,C,cb", [(1, 64, 1 << 14, 32),
                                         (3, 4, 1 << 14, 32),
                                         (2, 8, 512, 8)])
def test_long_range_dense_kernel_vs_plain(cuda_device, batch, R, C, cb):
    xr, xi = _planes(38, (batch, R, C), cuda_device)
    tables = twiddle.dense_long_range_tables(R, C, cuda_device)
    before = cf.long_range_dense.launches
    yk = cf.long_range_dense(xr, xi, *tables, cb=cb)
    torch.cuda.synchronize()
    assert cf.long_range_dense.launches == before + 1
    yp = cf.long_range_dense_plain(xr, xi, *tables)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("R,tile,cb", [(256, 1 << 14, 64), (8, 1024, 8)])
def test_dense_fourstep_kernel_vs_plain(cuda_device, R, tile, cb):
    xr, xi = _planes(39, (R, tile), cuda_device)
    args = (xr, xi, *twiddle.dense_long_range_tables(R, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.fourstep.launches
    yk = cf.fourstep(*args, cb=cb, separable=False)
    torch.cuda.synchronize()
    assert cf.fourstep.launches == before + 1
    yp = cf.fourstep_plain(*args, separable=False)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("R1,R2,tile", [(16, 16, 1 << 14), (4, 2, 512)])
def test_dense_sixstep_kernel_vs_plain(cuda_device, R1, R2, tile):
    xr, xi = _planes(40, (R1, R2, tile), cuda_device)
    args = (xr, xi,
            *twiddle.dense_long_range_tables(R1, R2 * tile, cuda_device),
            *twiddle.dense_long_range_tables(R2, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.sixstep.launches
    yk = cf.sixstep(*args, separable=False)
    torch.cuda.synchronize()
    assert cf.sixstep.launches == before + 1
    yp = cf.sixstep_plain(*args, separable=False)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("alias_io", [False, True])
@pytest.mark.parametrize("R,tile,qb", [(64, 1 << 14, 2), (64, 1 << 14, 1),
                                       (8, 1 << 14, 16), (4, 256, 2)])
def test_fused_kernel_vs_plain(cuda_device, R, tile, qb, alias_io):
    xr, xi = _planes(41, (R, tile), cuda_device)
    ops = (*twiddle.device_factors(R, tile, cuda_device),
           *twiddle.flat_tables(tile, cuda_device))
    yp = cf.fused_plain(xr, xi, *ops)
    before = cf.fused.launches
    yk = cf.fused(xr.clone(), xi.clone(), *ops, qb=qb, alias_io=alias_io)
    torch.cuda.synchronize()
    assert cf.fused.launches == before + 1
    assert rel_err(*yk, *yp) <= FP32_TOL
    # and again: a second launch meets the first one's carry lines gone
    yk = cf.fused(xr.clone(), xi.clone(), *ops, qb=qb, alias_io=alias_io)
    torch.cuda.synchronize()
    assert rel_err(*yk, *yp) <= FP32_TOL


def test_fused_alias_writes_over_its_input(cuda_device):
    R, tile = 64, 1 << 14
    xr, xi = _planes(42, (R, tile), cuda_device)
    ops = (*twiddle.device_factors(R, tile, cuda_device),
           *twiddle.flat_tables(tile, cuda_device))
    yr, yi = cf.fused(xr, xi, *ops, alias_io=True)
    assert yr.data_ptr() == xr.data_ptr() and yi.data_ptr() == xi.data_ptr()


def test_fused_raises_the_persisting_set_aside(cuda_device):
    # device state that outlives the launch: the set-aside stays raised
    # until restore_persisting_l2 (run at exit) puts back the value it
    # had before the process's first fused launch
    R, tile = 64, 1 << 14
    xr, xi = _planes(44, (R, tile), cuda_device)
    cf.fused(xr, xi, *twiddle.device_factors(R, tile, cuda_device),
             *twiddle.flat_tables(tile, cuda_device))
    torch.cuda.synchronize()
    assert cf.persisting_l2_set_aside(cuda_device) >= 2 * R * tile * 4
    cf.restore_persisting_l2()
    assert cf.persisting_l2_set_aside(cuda_device) == \
        cf._SET_ASIDE_BEFORE[xr.device.index]


def test_fused_alias_plan_serves_fft_and_keeps_x(cuda_device):
    # fft hands fused-alias its own plane split, never x's memory
    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.plans.core import Plan

    n = 1 << 20
    plan = Plan(key=plans.make_key(n), variant="fused-alias",
                params={"tile": 1 << 14, "qb": 2}, source="tuned")
    x = torch.complex(*_planes(45, (n,), cuda_device))
    keep = x.clone()
    before = cf.fused.launches
    y = fft(x, plan=plan)
    torch.cuda.synchronize()
    assert cf.fused.launches == before + 1 and torch.equal(x, keep)
    ref = np.fft.fft(keep.cpu().numpy().astype(np.complex128))
    assert rel_err(y.real, y.imag, ref.real, ref.imag) <= SPLIT3_TOL


def test_two_kernel_path_vs_numpy(cuda_device):
    n = 1 << 20
    xr, xi = _planes(43, (n,), cuda_device)
    before = (cf.long_range_dense.launches, cf.tile_fft.launches)
    yr, yi = cf.fft_pi_layout_cuda2(xr, xi)
    torch.cuda.synchronize()
    assert (cf.long_range_dense.launches, cf.tile_fft.launches) == \
        (before[0] + 1, before[1] + 1)
    x = xr.cpu().double().numpy() + 1j * xi.cpu().double().numpy()
    ref = np.fft.fft(x)[bit_reverse_indices(n)]
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL


def test_race_on_the_card_times_fused(cuda_device, tmp_path, monkeypatch):
    from cs87project_msolano2_tpu_torch import plans

    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    plans.cache.clear(memory=True, disk=False)
    key = plans.make_key(1 << 20, layout="pi")
    plan = plans.tune(key, verbose=False)
    fates = {(r.variant, r.status) for r in plan.tuning}
    for variant in ("fused", "fused-alias", "two-kernel"):
        assert any(v == variant and s in ("won", "lost")
                   for v, s in fates), (variant, plan.tuning)
    assert plan.source == "tuned" and plan.ms > 0
    assert plans.cache.disk_entries(key.device_kind)


# --- the matmul funnel and the gpu backend ----------------------------------

# the whole-path budget of each fp32-storage mode (ops/precision.py)
MODE_BUDGET = {"split3": 1e-5, "highest": 5e-6, "fp32": 5e-6,
               "default": 1e-2}


@pytest.mark.parametrize("mode", ["split3", "default", "highest", "fp32"])
@pytest.mark.parametrize("R,n,cb", [(16, 1 << 12, None),   # one K step
                                    (16, 1 << 14, 1024),
                                    (128, 1 << 14, None),
                                    (128, 1 << 20, None)])
def test_matmul_funnel_kernel_vs_plain(cuda_device, mode, R, n, cb):
    # the same bf16 planes and products in both, summed in another
    # order: float32 rounding of the accumulation
    xr, xi = _planes(40, (R, n // R), cuda_device)
    args = (xr, xi, *twiddle.device_funnel_b(R, cuda_device),
            *twiddle.device_funnel_factors(R, n, cuda_device))
    before = cf.matmul_funnel.launches
    yk = cf.matmul_funnel(*args, cb=cb, precision=mode)
    torch.cuda.synchronize()
    assert cf.matmul_funnel.launches == before + 1
    yp = cf.matmul_funnel_plain(*args, precision=mode)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("mode", ["split3", "default", "highest"])
def test_mf_path_on_card_vs_numpy(cuda_device, mode):
    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.plans.core import Plan

    n = 1 << 20
    rng = np.random.default_rng(41)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    plan = Plan(plans.make_key(n, precision=mode), "mf", {"R": 128})
    before = (cf.matmul_funnel.launches, cf.tile_fft.launches)
    yr, yi = plan.execute(x.real, x.imag)
    torch.cuda.synchronize()
    assert (cf.matmul_funnel.launches, cf.tile_fft.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = np.fft.fft(x.astype(np.complex128))
    assert rel_err(yr, yi, ref.real, ref.imag) <= MODE_BUDGET[mode]


@pytest.mark.parametrize("rows,n,block_rows", [
    (8, 2, None), (8, 2, 8), (8, 1 << 10, None), (8, 1 << 10, 8),
    (4, 1 << 14, None), (4, 1 << 15, None), (4, 1 << 15, 2),
    (2, 1 << 18, None)])
def test_gpu_rows_kernel_vs_plain(cuda_device, rows, n, block_rows):
    from cs87project_msolano2_tpu_torch.hw import lowering

    xr, xi = _planes(42, (rows, n), cuda_device)
    stack = lowering.device_twiddle_stack(n, cuda_device)
    before = cf.gpu_rows.launches
    yk = cf.gpu_rows(xr, xi, *stack, block_rows=block_rows)
    torch.cuda.synchronize()
    assert cf.gpu_rows.launches == before + 1
    assert rel_err(*yk, *cf.gpu_rows_plain(xr, xi, *stack)) <= FP32_TOL


@pytest.mark.parametrize("shape", [(64, 4096), (4, 1 << 18), (16, 8)])
def test_gpu_backend_plan_on_card_vs_numpy(cuda_device, shape):
    from cs87project_msolano2_tpu_torch import plans

    plan = plans.plan_for(shape, backend="gpu")
    assert plan.variant == "gpu-rows"
    rng = np.random.default_rng(43)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        .astype(np.complex64)
    before = cf.gpu_rows.launches
    yr, yi = plan.execute(x.real, x.imag)
    torch.cuda.synchronize()
    assert cf.gpu_rows.launches == before + 1
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL
