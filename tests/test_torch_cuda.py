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
from cs87project_msolano2_tpu_torch.ops.precision import rel_err, split_levels

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


#: (batch, R, C, cb) of the long-range kernels on their Hopper passes:
#: R from 2 to 8192 (every first-pass radix, passes of at most 3 or 4
#: levels, both KMAX), cb from 2 to 32, batches above 1
LONG_RANGE_HOPPER_SHAPES = [
    (1, 2, 4096, 32), (2, 4, 256, 2), (1, 16, 1024, 16),
    (4, 16, 1 << 14, 32),       # tube_cuda's segments at n = 2^20, p = 4
    (2, 32, 2048, 4), (1, 128, 1 << 14, 32),
    (1, 256, 1 << 14, 32),      # rql at n = 2^22
    (3, 512, 1024, 8), (1, 1024, 1 << 14, 16), (1, 2048, 1 << 12, 8),
    (1, 4096, 1 << 12, 4),
    (1, 8192, 2048, 2)]         # a 2^27-point tube segment's cb


@pytest.mark.parametrize("batch,R,C,cb", [(1, 64, 1 << 14, 32),
                                         (3, 4, 1 << 14, 32),
                                         (2, 8, 512, 8)]
                         + LONG_RANGE_HOPPER_SHAPES)
def test_long_range_dense_kernel_vs_plain(cuda_device, batch, R, C, cb):
    # the two-kernel entry's pass (1 x 64 x 2^14 at n = 2^20) and
    # long_range_sep's shapes: the same passes with the dense tables
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
                                       (8, 1 << 14, 16), (4, 256, 2),
                                       (2, 1 << 14, None),
                                       (256, 1 << 12, None)])
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
                                    (16, 1 << 14, 64),
                                    (32, 1 << 13, None),
                                    (64, 1 << 14, None),
                                    (128, 1 << 14, None),
                                    (128, 1 << 20, None),
                                    (128, 1 << 21, None),
                                    (256, 1 << 15, None),
                                    (256, 1 << 21, None)])
def test_matmul_funnel_kernel_vs_plain(cuda_device, mode, R, n, cb):
    # the same bf16 planes and products in both, summed in another
    # order: float32 rounding of the accumulation.  R < 64 pads the
    # 64-row unit with zero rows; at n = 2^21 the units outnumber the
    # persistent grid and are not a multiple of it
    xr, xi = _planes(40, (R, n // R), cuda_device)
    args = (xr, xi, twiddle.device_funnel_b_tiles(
                R, split_levels(mode), cuda_device),
            *twiddle.device_funnel_factors(R, n, cuda_device)[:2],
            twiddle.device_funnel_b2_tiles(R, n, cuda_device))
    if n == 1 << 21:
        units = (n // R // cf.MF_TILE_COLS) * -(-R // 64)
        grid = cf.mf_resident_blocks(cuda_device, mode)
        assert units > grid and units % grid, (units, grid)
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
    (8, 2, None), (8, 2, 8), (8, 1 << 4, None), (8, 1 << 4, 2),
    (8, 1 << 10, None), (8, 1 << 10, 8),
    (4, 1 << 14, None), (4, 1 << 14, 1), (4, 1 << 15, None),
    (4, 1 << 15, 2), (4, 1 << 16, None), (4, 1 << 16, 4),
    (2, 1 << 17, None), (2, 1 << 17, 2), (2, 1 << 18, None),
    (4, 1 << 18, 2)])
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


@pytest.mark.parametrize("alias_io", [False, True])
@pytest.mark.parametrize("R,tile,qb,cw", [
    (64, 1 << 14, 1, 1), (64, 1 << 14, 1, 2), (64, 1 << 14, 2, 4),
    (64, 1 << 14, 4, 8), (16, 1 << 10, 1, 8), (2, 1 << 12, 2, 4),
    (128, 1 << 13, 1, 2)])
def test_fused_cluster_widths_vs_plain(cuda_device, R, tile, qb, cw,
                                       alias_io):
    xr, xi = _planes(44, (R, tile), cuda_device)
    ops = (*twiddle.device_factors(R, tile, cuda_device),
           *twiddle.flat_tables(tile, cuda_device))
    yp = cf.fused_plain(xr, xi, *ops)
    before = cf.fused.launches
    yk = cf.fused(xr.clone(), xi.clone(), *ops, qb=qb, alias_io=alias_io,
                  cw=cw)
    torch.cuda.synchronize()
    assert cf.fused.launches == before + 1
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_gpu_rows_card_holds_every_cluster(cuda_device, n):
    # the long-row design needs a cluster of n / 2^14 blocks of 132 KB;
    # the wrapper raises where the card holds none
    assert cf.gpu_rows_max_clusters(cuda_device, n) >= 1


# --- the Hopper tile_fft and sixstep, and the race's slope timer ------------


@pytest.mark.parametrize("rows", [3, 64])
@pytest.mark.parametrize("log2_tile", range(1, 15))
def test_tile_fft_every_tile_vs_plain(cuda_device, log2_tile, rows):
    # every first-pass radix (1..4 levels), blocks of one row (3 rows)
    # and of several (64 short rows), and the automatic cluster of the
    # 2^13 / 2^14 rows at 64 rows
    tile = 1 << log2_tile
    xr, xi = _planes(45, (rows, tile), cuda_device)
    tw = twiddle.flat_tables(tile, cuda_device)
    before = cf.tile_fft.launches
    yk = cf.tile_fft(xr, xi, *tw)
    torch.cuda.synchronize()
    assert cf.tile_fft.launches == before + 1
    assert rel_err(*yk, *cf.tile_fft_plain(xr, xi, *tw)) <= FP32_TOL


@pytest.mark.parametrize("rows", [1, 5, 17, 33, 64, 100, 131, 256])
@pytest.mark.parametrize("tile", [1 << 13, 1 << 14])
def test_tile_fft_cluster_widths_vs_plain(cuda_device, rows, tile):
    # the row count picks the cluster width (tile_blocking): on 132 SMs
    # these rows of 2^14 take every width, 8 down to 1
    xr, xi = _planes(46, (rows, tile), cuda_device)
    tw = twiddle.flat_tables(tile, cuda_device)
    yk = cf.tile_fft(xr, xi, *tw)
    torch.cuda.synchronize()
    assert rel_err(*yk, *cf.tile_fft_plain(xr, xi, *tw)) <= FP32_TOL


def test_tile_fft_refuses_a_misaligned_view(cuda_device):
    flat = torch.zeros(4 * 1024 + 1, device=cuda_device)
    view = flat[1:].reshape(4, 1024)  # 4 bytes past a 16-byte boundary
    tw = twiddle.flat_tables(1024, cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cf.tile_fft(view, view, *tw)


@pytest.mark.parametrize("separable", [True, False])
@pytest.mark.parametrize("R1,R2,tile,cb1,cb2", [
    (64, 32, 1 << 14, None, None),   # n = 2^25, automatic (64, 128)
    (64, 32, 1 << 14, 32, 64),       # the race's halvings
    (16, 16, 1 << 13, None, None),   # phase B2 on clusters of 2
    (4, 4, 4096, None, 8),           # one block a row
    (8, 2, 256, None, None)])
def test_sixstep_hopper_blocking_vs_plain(cuda_device, R1, R2, tile, cb1,
                                          cb2, separable):
    xr, xi = _planes(47, (R1, R2, tile), cuda_device)
    lr = twiddle.device_factors if separable \
        else twiddle.dense_long_range_tables
    args = (xr, xi, *lr(R1, R2 * tile, cuda_device),
            *lr(R2, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.sixstep.launches
    yk = cf.sixstep(*args, cb1=cb1, cb2=cb2, separable=separable)
    torch.cuda.synchronize()
    assert cf.sixstep.launches == before + 1
    yp = cf.sixstep_plain(*args, separable=separable)
    assert rel_err(*yk, *yp) <= FP32_TOL


def test_default_timer_leaves_a_wrappers_host_time_out(cuda_device):
    # a wrapper that sleeps 1 ms on the host before each launch times
    # within noise of the bare one: the slope replays captured launches,
    # and the host work ran once, at capture (CUDA events around each
    # call would add the 1 ms to every call)
    import time

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.plans import autotune

    key = plans.make_key(1 << 20, layout="pi")

    def bare(xr, xi):
        return cf.fft_pi_layout_cuda_rql(xr, xi)

    def slow(xr, xi):
        time.sleep(1e-3)
        return cf.fft_pi_layout_cuda_rql(xr, xi)

    t_bare = autotune.default_timer(bare, key)
    t_slow = autotune.default_timer(slow, key)
    assert 0 < t_bare < 1.0
    assert abs(t_slow - t_bare) <= 0.15 * t_bare + 0.003, (t_bare, t_slow)


@pytest.mark.parametrize("separable", [True, False])
@pytest.mark.parametrize("log2_n,tile",
                         [(k, 1 << 14) for k in range(21, 26)]
                         + [(k, 1 << 13) for k in range(21, 25)])
def test_fourstep_hopper_blocking_vs_plain(cuda_device, log2_n, tile,
                                           separable):
    # every automatic blocking from 2^21 to 2^25 (tile 2^14, cb 32 .. 8,
    # phase-B rows on clusters of 4) and the race's half-tile entry
    # (ladder.fourstep_candidates) from 2^21 to 2^24 (tile 2^13, rows on
    # clusters of 2), both twiddle modes
    R = (1 << log2_n) // tile
    xr, xi = _planes(48, (R, tile), cuda_device)
    lr = twiddle.device_factors if separable \
        else twiddle.dense_long_range_tables
    args = (xr, xi, *lr(R, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    before = cf.fourstep.launches
    yk = cf.fourstep(*args, separable=separable)
    torch.cuda.synchronize()
    assert cf.fourstep.launches == before + 1
    yp = cf.fourstep_plain(*args, separable=separable)
    assert rel_err(*yk, *yp) <= FP32_TOL


@pytest.mark.parametrize("log2_n", range(21, 26))
def test_fourstep_resident_blocks_per_sm(cuda_device, log2_n):
    # the persistent grid the occupancy API gives at every automatic
    # blocking, in whole clusters of 4: more blocks than SMs to 2^24
    # (two a SM where the cluster placement allows; the 128 registers of
    # a thread cap it at two), at most one a SM at 2^25, whose 2048 x 8
    # phase-A block takes 135 KB (cb cannot go below one 32-byte sector
    # of a row)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    resident = cf.fourstep_resident_blocks(cuda_device, 1 << log2_n)
    assert resident % cf.row_cluster_width(cf.MAX_SMEM_TILE) == 0
    if log2_n < 25:
        assert sms < resident <= 2 * sms
    else:
        assert 0 < resident <= sms


@pytest.mark.parametrize("batch,R,C,cb", LONG_RANGE_HOPPER_SHAPES)
def test_long_range_sep_hopper_blocking_vs_plain(cuda_device, batch, R, C,
                                                 cb):
    # R from 2 to 8192 (every first-pass radix, passes of at most 3 or 4
    # levels), cb from 2 to 32, batches above 1
    xr, xi = _planes(49, (batch, R, C), cuda_device)
    fac = twiddle.device_factors(R, C, cuda_device)
    before = cf.long_range_sep.launches
    yk = cf.long_range_sep(xr, xi, *fac, cb=cb)
    torch.cuda.synchronize()
    assert cf.long_range_sep.launches == before + 1
    assert rel_err(*yk, *cf.long_range_sep_plain(xr, xi, *fac)) <= FP32_TOL


def _misaligned(seed, shape, device):
    # contiguous planes 4 bytes past a 16-byte boundary
    n = int(np.prod(shape))
    out = []
    for x in _planes(seed, shape, device):
        flat = torch.empty(n + 1, device=device)
        view = flat[1:].view(shape)
        view.copy_(x)
        out.append(view)
    return out


def test_long_range_sep_takes_a_misaligned_view(cuda_device):
    xr, xi = _misaligned(50, (2, 64, 1 << 12), cuda_device)
    assert xr.data_ptr() % 16
    fac = twiddle.device_factors(64, 1 << 12, cuda_device)
    yk = cf.long_range_sep(xr, xi, *fac, cb=32)
    torch.cuda.synchronize()
    assert rel_err(*yk, *cf.long_range_sep_plain(xr, xi, *fac)) <= FP32_TOL


def test_long_range_dense_takes_a_misaligned_view(cuda_device):
    xr, xi = _misaligned(52, (2, 64, 1 << 12), cuda_device)
    assert xr.data_ptr() % 16
    tables = twiddle.dense_long_range_tables(64, 1 << 12, cuda_device)
    yk = cf.long_range_dense(xr, xi, *tables, cb=32)
    torch.cuda.synchronize()
    assert rel_err(*yk, *cf.long_range_dense_plain(xr, xi, *tables)) \
        <= FP32_TOL


def test_matmul_funnel_takes_a_misaligned_view(cuda_device):
    # the kernel copies X 16 bytes at a time: a view off a 16-byte
    # boundary is copied to fresh memory first
    R, n = 128, 1 << 14
    xr, xi = _misaligned(53, (R, n // R), cuda_device)
    assert xr.data_ptr() % 16
    args = (xr, xi, twiddle.device_funnel_b_tiles(R, 2, cuda_device),
            *twiddle.device_funnel_factors(R, n, cuda_device)[:2],
            twiddle.device_funnel_b2_tiles(R, n, cuda_device))
    yk = cf.matmul_funnel(*args)
    torch.cuda.synchronize()
    assert rel_err(*yk, *cf.matmul_funnel_plain(*args)) <= FP32_TOL


def test_fourstep_takes_a_misaligned_view(cuda_device):
    R, tile = 256, 1 << 14
    xr, xi = _misaligned(51, (R, tile), cuda_device)
    assert xr.data_ptr() % 16
    args = (xr, xi, *twiddle.device_factors(R, tile, cuda_device),
            *twiddle.flat_tables(tile, cuda_device))
    yk = cf.fourstep(*args)
    torch.cuda.synchronize()
    assert rel_err(*yk, *cf.fourstep_plain(*args)) <= FP32_TOL


# --- the bf16 storage instantiations ---------------------------------------

# a bf16 kernel vs its plain version: both compute in float32 and round
# at the same points, so they differ only where a float32 difference of
# about 1e-7 crosses a bf16 rounding boundary (3.8e-4 at most on an H100
# at the main path's shapes)
BF16_TOL = 1e-3
BF16 = "bfloat16"


def _bf16_planes(seed, shape, device):
    return tuple(t.to(torch.bfloat16) for t in _planes(seed, shape, device))


def _bf16_case(kind, shape, device):
    """(wrapper, plain, args) of one bf16 kernel at one shape."""
    if kind == "tile_fft":
        rows, tile = shape
        return (cf.tile_fft, cf.tile_fft_plain,
                (*_bf16_planes(41, shape, device),
                 *twiddle.flat_tables(tile, device, BF16)))
    if kind == "long_range_sep":
        batch, R, C, cb = shape
        return (lambda *a: cf.long_range_sep(*a, cb=cb),
                cf.long_range_sep_plain,
                (*_bf16_planes(42, (batch, R, C), device),
                 *twiddle.device_factors(R, C, device, BF16)))
    if kind == "long_range_dense":
        batch, R, C, cb = shape
        return (lambda *a: cf.long_range_dense(*a, cb=cb),
                cf.long_range_dense_plain,
                (*_bf16_planes(47, (batch, R, C), device),
                 *twiddle.dense_long_range_tables(R, C, device, BF16)))
    if kind == "fused":
        # the wrapper writes over clones, so the planes stay the plain
        # version's input in either alias mode
        R, tile, qb, cw, alias_io = shape
        return (lambda xr, xi, *a: cf.fused(xr.clone(), xi.clone(), *a,
                                            qb=qb, alias_io=alias_io, cw=cw),
                cf.fused_plain,
                (*_bf16_planes(48, (R, tile), device),
                 *twiddle.device_factors(R, tile, device, BF16),
                 *twiddle.flat_tables(tile, device, BF16)))
    if kind.startswith("fourstep"):
        R, tile, cb = shape
        sep = kind == "fourstep"
        lr = twiddle.device_factors if sep \
            else twiddle.dense_long_range_tables
        return (lambda *a: cf.fourstep(*a, cb=cb, separable=sep),
                lambda *a: cf.fourstep_plain(*a, separable=sep),
                (*_bf16_planes(43, (R, tile), device),
                 *lr(R, tile, device, BF16),
                 *twiddle.flat_tables(tile, device, BF16)))
    R1, R2, tile = shape
    sep = kind == "sixstep"
    lr = twiddle.device_factors if sep else twiddle.dense_long_range_tables
    return (lambda *a: cf.sixstep(*a, separable=sep),
            lambda *a: cf.sixstep_plain(*a, separable=sep),
            (*_bf16_planes(44, (R1, R2, tile), device),
             *lr(R1, R2 * tile, device, BF16), *lr(R2, tile, device, BF16),
             *twiddle.flat_tables(tile, device, BF16)))


@pytest.mark.parametrize("kind,shape", [
    ("tile_fft", (8, 1024)), ("tile_fft", (64, 1 << 14)),
    ("long_range_sep", (2, 8, 512, 8)),
    ("long_range_sep", (1, 64, 1 << 14, 32)),
    ("long_range_dense", (2, 8, 512, 8)),
    ("long_range_dense", (1, 64, 1 << 14, 32)),
    ("long_range_dense", (1, 8192, 2048, 2)),
    ("fused", (64, 1 << 14, 1, 4, False)), ("fused", (64, 1 << 14, 2, 8, True)),
    ("fused", (64, 1 << 14, 1, 1, True)), ("fused", (4, 256, 2, 4, False)),
    # segments of 32 bf16 values, under one 128-byte line: no discard
    ("fused", (2, 256, 1, 8, True)),
    ("fourstep", (64, 4096, 64)), ("fourstep", (1024, 1 << 14, 16)),
    ("fourstep-dense", (8, 1024, 8)), ("fourstep-dense", (256, 1 << 14, 64)),
    ("sixstep", (4, 2, 512)), ("sixstep", (16, 16, 1 << 14)),
    ("sixstep-dense", (4, 2, 512)), ("sixstep-dense", (16, 16, 1 << 14))])
def test_bf16_kernel_vs_plain(cuda_device, kind, shape):
    kernel, plain, args = _bf16_case(kind, shape, cuda_device)
    name = kind.split("-")[0]
    wrapper = getattr(cf, name)
    before = (wrapper.launches, wrapper.launches_bf16)
    yk = kernel(*args)
    # the bf16 instantiation ran, counted apart from the float32 one
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0],
                                                         before[1] + 1)
    assert yk[0].dtype == torch.bfloat16 and yk[0].shape == args[0].shape
    yp = plain(*args)
    torch.cuda.synchronize()
    assert rel_err(*yk, *yp) <= BF16_TOL


@pytest.mark.parametrize("kind", ["tile_fft", "long_range_sep", "fourstep",
                                  "sixstep", "long_range_dense", "fused"])
def test_bf16_wrappers_raise_on_a_dtype_that_does_not_match(cuda_device,
                                                             kind):
    shape = {"tile_fft": (8, 1024), "long_range_sep": (2, 8, 512, 8),
             "fourstep": (64, 4096, 64), "sixstep": (4, 2, 512),
             "long_range_dense": (2, 8, 512, 8),
             "fused": (4, 256, 2, 4, False)}[kind]
    kernel, _, args = _bf16_case(kind, shape, cuda_device)
    # float32 tables beside bf16 planes, bf16 tables beside float32
    # planes, and half planes: refused before any launch, never converted
    for bad in ((*args[:2], *(t.float() for t in args[2:])),
                (*(t.float() for t in args[:2]), *args[2:]),
                (*(t.half() for t in args[:2]), *args[2:])):
        with pytest.raises((TypeError, ValueError)):
            kernel(*bad)


def test_fused_bf16_sizes_its_carry_window(cuda_device):
    # the bf16 carry is 2 n bf16 values (4 MB at 2^20): the set-aside the
    # launch raises, and the window, cover that many bytes, not 2 n floats
    R, tile = 64, 1 << 14
    kernel, plain, args = _bf16_case("fused", (R, tile, 1, 4, False),
                                     cuda_device)
    before = cf.persisting_l2_set_aside(cuda_device)
    kernel(*args)  # a first launch records the card's own set-aside
    torch.cuda.synchronize()
    try:
        cf.set_persisting_l2_set_aside(cuda_device, 0)
        yk = kernel(*args)
        torch.cuda.synchronize()
        raised = cf.persisting_l2_set_aside(cuda_device)
    finally:
        cf.set_persisting_l2_set_aside(cuda_device, before)
    carry = 2 * R * tile * 2
    assert carry <= raised < 2 * carry
    assert rel_err(*yk, *plain(*args)) <= BF16_TOL


def test_fused_bf16_alias_alignment_follows_its_copy_width(cuda_device):
    # bf16 planes are copied 8 bytes at a time: a view 8 bytes into its
    # storage is served in place, one 4 bytes in is refused
    R, tile = 4, 256
    _, plain, args = _bf16_case("fused", (R, tile, 2, 4, True), cuda_device)
    base = [torch.empty(R * tile + 4, dtype=torch.bfloat16,
                        device=cuda_device) for _ in range(2)]
    views = [b[4:].view(R, tile) for b in base]
    for v, a in zip(views, args[:2]):
        v.copy_(a)
    yr, yi = cf.fused(*views, *args[2:], alias_io=True)
    torch.cuda.synchronize()
    assert yr.data_ptr() == views[0].data_ptr()
    assert rel_err(yr, yi, *plain(*args)) <= BF16_TOL
    odd = [b[2:2 + R * tile].view(R, tile) for b in base]
    with pytest.raises(ValueError, match="8-byte aligned"):
        cf.fused(*odd, *args[2:], alias_io=True)


def test_fp32_instantiations_count_apart(cuda_device):
    # float32 planes still launch the float32 kernels (the parent's SASS:
    # tools/sass_diff.py), counted on `launches` only
    xr, xi = _planes(45, (64, 1 << 14), cuda_device)
    tw = twiddle.flat_tables(1 << 14, cuda_device)
    before = (cf.tile_fft.launches, cf.tile_fft.launches_bf16)
    yk = cf.tile_fft(xr, xi, *tw)
    assert (cf.tile_fft.launches, cf.tile_fft.launches_bf16) == (
        before[0] + 1, before[1])
    assert yk[0].dtype == torch.float32
    assert rel_err(*yk, *cf.tile_fft_plain(xr, xi, *tw)) <= FP32_TOL


@pytest.mark.parametrize("shape", [(1 << 20,), (64, 4096), (1 << 21,),
                                   (1 << 25,)])
def test_bf16_path_on_card_vs_numpy(cuda_device, shape):
    rng = np.random.default_rng(46)
    amp = 1 / np.sqrt(shape[-1])
    x = (rng.uniform(-amp, amp, shape)
         + 1j * rng.uniform(-amp, amp, shape)).astype(np.complex64)
    before = cf.launch_counts()
    y = fft(x, precision="bf16")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in cf.launch_counts().items()
                if v != before[k]}
    assert y.dtype == torch.complex64
    assert launched and all(k.endswith("_bf16") for k in launched)
    y = y.cpu().numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    assert 1e-4 < rel_err(y.real, y.imag, ref.real, ref.imag) <= 3e-2
