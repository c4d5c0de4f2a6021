"""The tuned path's kernels on the CPU (plain versions): the dense
long-range tables and pass against the JAX package's long_range_grid
and fft_pi_layout_pallas2 (interpret mode), the fused composition
against numpy float64 and the reference rql (the reference fused kernel
does not run on this jax), the dense fourstep/sixstep modes against
their separable versions, the Hopper budget of the fused kernel, and
the new executors.  The kernels themselves run in
``test_torch_cuda.py``."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu.ops.twiddle import twiddle_tables as ref_tables
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.ops.bits import ilog2
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
# split3 budget: the reference's MXU tail is ~4e-6 from exact, the
# port's fp32 butterflies ~2e-7
SPLIT3_TOL = 1e-5
# the same float32 levels in another order or with other twiddle values
# (dense tables vs separable factors: one rounding each)
FP32_TOL = 1e-6


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _numpy_pi(xr, xi):
    y = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    return pi_layout_to_natural(y)  # bit reversal is an involution


@lru_cache(maxsize=None)
def _reference_rql(n, tile):
    xr, xi = _planes(n, n)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(jnp.asarray(xr),
                                             jnp.asarray(xi), tile=tile)
    return np.asarray(rr) + 1j * np.asarray(ri)


# ------------------------------------------------------- dense tables


@pytest.mark.parametrize("R,C", [(2, 128), (8, 512), (64, 256),
                                 (16, 1 << 12)])
def test_dense_tables_bit_equal_the_reference(R, C):
    wr, wi = twiddle.dense_long_range_tables(R, C, CPU)
    assert wr.shape == wi.shape == (R - 1, C) and wr.dtype == torch.float32
    for l, (rr, ri) in enumerate(ref_tables(R * C)[:ilog2(R)]):
        half = R >> (l + 1)
        o = R - (R >> l)
        # long_range_grid's level-l operand (pallas_fft.py:651-657)
        assert np.array_equal(wr[o:o + half].numpy(), rr.reshape(half, C))
        assert np.array_equal(wi[o:o + half].numpy(), ri.reshape(half, C))


def _long_range_float64(xr, xi, R, C):
    """The first log2(R) DIF levels in float64 with exact twiddles: the
    oracle of the long-range pass alone."""
    x = (xr.astype(np.float64) + 1j * xi.astype(np.float64)).reshape(R, C)
    n = R * C
    for l in range(ilog2(R)):
        half = R >> (l + 1)
        w = np.exp(-2j * np.pi * np.arange(half * C) / (n >> l))
        x4 = x.reshape(-1, 2, half, C)
        top, bot = x4[:, 0] + x4[:, 1], (x4[:, 0] - x4[:, 1]) * \
            w.reshape(half, C)
        x = np.stack((top, bot), axis=1).reshape(R, C)
    return x


@pytest.mark.parametrize("n,tile", [(1 << 14, 1 << 10), (1 << 16, 1 << 12)])
def test_long_range_dense_vs_reference_grid(n, tile):
    R = n // tile
    xr, xi = _planes(11, (R, tile))
    tables = twiddle.dense_long_range_tables(R, tile, CPU)
    yr, yi = cf.long_range_dense(*_t(xr[None], xi[None]), *tables, cb=32)
    assert yr.shape == (1, R, tile)
    rr, ri = ref_pf.long_range_grid(jnp.asarray(xr), jnp.asarray(xi),
                                    separable=False, interpret=True)
    assert rel_err(yr[0], yi[0], rr, ri) <= 1e-5
    exact = _long_range_float64(xr, xi, R, tile)
    assert rel_err(yr[0], yi[0], exact.real, exact.imag) <= 1e-5


@pytest.mark.parametrize("n,tile", [(1 << 14, 1 << 10), (1 << 16, 1 << 12)])
def test_two_kernel_vs_reference_pallas2(n, tile):
    xr, xi = _planes(12, n)
    yr, yi = cf.fft_pi_layout_cuda2(*_t(xr, xi), tile=tile)
    assert yr.shape == (n,) and yr.dtype == torch.float32
    rr, ri = ref_pf.fft_pi_layout_pallas2(jnp.asarray(xr), jnp.asarray(xi),
                                          tile=tile, interpret=True)
    assert rel_err(yr, yi, rr, ri) <= 1e-5
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= 1e-5


def test_two_kernel_batches_rows_and_matches_rql():
    xr, xi = _t(*_planes(13, (3, 1 << 12)))
    two = cf.fft_pi_layout_cuda2(xr, xi, tile=256, cb=16)
    rql = cf.fft_pi_layout_cuda_rql(xr, xi, tile=256, cb=16)
    assert two[0].shape == (3, 1 << 12)
    assert rel_err(*two, *rql) <= FP32_TOL


def test_long_range_dense_rejects_bad_operands():
    xr, xi = _t(*_planes(14, (1, 8, 256)))
    wr, wi = twiddle.dense_long_range_tables(8, 256, CPU)
    with pytest.raises(ValueError, match="operand shape"):
        cf.long_range_dense(xr, xi, wr[:3].contiguous(), wi)
    with pytest.raises(ValueError, match="limit 232448"):
        cf.long_range_dense(xr, xi, wr, wi, cb=1 << 13)
    with pytest.raises(ValueError, match="must divide"):
        cf.long_range_dense(xr, xi, wr, wi, cb=512)


# ----------------------------------------------------------- fused


FUSED_CASES = [(1 << 13, 1 << 9, None), (1 << 13, 1 << 9, 1),
               (1 << 14, 1 << 10, 2), (1 << 15, 1 << 11, None)]


@pytest.mark.parametrize("n,tile,qb", FUSED_CASES)
def test_fused_vs_numpy_and_reference_rql(n, tile, qb):
    xr, xi = _planes(n, n)
    yr, yi = cf.fft_pi_layout_cuda_fused(*_t(xr, xi), tile=tile, qb=qb)
    assert yr.shape == (n,) and yr.dtype == torch.float32
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL
    # the reference's fused kernel does not run on this jax (ROADMAP
    # Queue C); its rql gives the same pi-layout array at equal n
    ref = _reference_rql(n, tile)
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("n,tile,qb", FUSED_CASES)
def test_fused_plain_is_the_fourstep_arithmetic(n, tile, qb):
    xr, xi = _t(*_planes(n + 1, n))
    fused = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile, qb=qb)
    four = cf.fft_pi_layout_cuda_fourstep(xr, xi, tile=tile)
    assert torch.equal(fused[0], four[0]) and torch.equal(fused[1], four[1])


def test_fused_alias_writes_over_the_input_planes():
    n, tile = 1 << 12, 1 << 8
    xr, xi = _t(*_planes(15, n))
    want = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile)
    yr, yi = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile, alias_io=True)
    assert yr.data_ptr() == xr.data_ptr() and yi.data_ptr() == xi.data_ptr()
    assert torch.equal(xr, want[0]) and torch.equal(xi, want[1])


def test_fused_single_row_takes_the_tile_kernel():
    n = 1 << 10
    xr, xi = _planes(16, n)
    assert cf.fused_blocking(n) == (n, 1, None, None)
    yr, yi = cf.fft_pi_layout_cuda_fused(*_t(xr, xi))
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


def test_fused_blocking_on_hopper():
    # the headline n: 64 rows of 2^14; qb counts 32-column groups, so the
    # default phase-A block is 64 x 32 (512 work items), and each tile
    # row goes on a cluster of 4 blocks of 4096 points (256 blocks)
    assert cf.fused_blocking(1 << 20) == (1 << 14, 64, 1, 4)
    assert cf.fused_blocking(1 << 20, qb=2) == (1 << 14, 64, 2, 4)
    assert cf.fused_blocking(1 << 17) == (1 << 14, 8, 1, 4)
    assert cf.fused_blocking(1 << 20, 1 << 13) == (1 << 13, 128, 1, 4)
    assert cf.fused_blocking(1 << 20, 1 << 12, cw=1) == (1 << 12, 256, 1, 1)
    # a 64 x 8192 block needs 4.3 MB, past the block's 227 KB
    with pytest.raises(ValueError, match=r"R=64 x qb=256 .*limit 232448"):
        cf.fused_blocking(1 << 20, qb=256)
    with pytest.raises(ValueError, match="FUSED_MAX_N"):
        cf.fused_blocking(1 << 21)
    with pytest.raises(ValueError, match="qb=3 must be a power of two"):
        cf.fused_blocking(1 << 20, qb=3)
    with pytest.raises(ValueError, match="multiple of 32"):
        cf.fused_blocking(1 << 10, tile=16)
    with pytest.raises(ValueError, match="limit 232448"):
        cf.fused_blocking(1 << 20, tile=1 << 15)


@pytest.mark.parametrize("n,tile,cw,want", [
    (1 << 20, 1 << 14, None, 4),   # the default cluster width
    (1 << 20, 1 << 14, 1, 1),      # a whole tile row in one block
    (1 << 20, 1 << 14, 8, 8),      # Hopper's portable cluster size
    (1 << 12, 1 << 7, None, 4),    # 128-point rows: 32-point segments
    (1 << 11, 1 << 6, None, 2),    # 64-point rows: halved to keep 32
    (1 << 10, 1 << 5, None, 1)])   # 32-point rows: one block a row
def test_fused_cluster_width_choice(n, tile, cw, want):
    assert cf.fused_blocking(n, tile, cw=cw)[3] == want
    # the plain version ignores where rows live: equal for every cw
    xr, xi = _t(*_planes(n + 7, n))
    got = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile, cw=cw)
    base = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile, cw=1)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


@pytest.mark.parametrize("kw,match", [
    ({"cw": 16}, r"cw=16 must be one of \(1, 2, 4, 8\)"),
    ({"cw": 3}, r"cw=3 must be one of"),
    ({"tile": 1 << 7, "cw": 8}, r"tile=128 / cw=8 leaves segments of 16 "
                                r"points"),
    ({"qb": 1024}, r"qb=1024 must be a power of two dividing tile/32=512")])
def test_fused_blocking_names_the_limiting_pair(kw, match):
    with pytest.raises(ValueError, match=match):
        cf.fused_blocking(1 << 20, **kw)


def test_fused_rejects_bad_operands():
    R, tile = 8, 256
    xr, xi = torch.zeros(R, tile), torch.zeros(R, tile)
    fac = list(twiddle.device_factors(R, tile, CPU))
    tw = twiddle.flat_tables(tile, CPU)
    with pytest.raises(ValueError, match="operand shape"):
        cf.fused(xr, xi, fac[0][:2].contiguous(), *fac[1:], *tw)
    with pytest.raises(ValueError, match="R=6"):
        cf.fused(torch.zeros(6, tile), torch.zeros(6, tile), *fac, *tw)


def test_cpu_fused_leaves_the_l2_set_aside_alone():
    # the plain version touches no card: nothing to put back at exit,
    # and the set-aside helpers refuse a device that is not a card
    R, tile = 8, 256
    xr, xi = _t(*_planes(17, (R, tile)))
    cf.fused(xr, xi, *twiddle.device_factors(R, tile, CPU),
             *twiddle.flat_tables(tile, CPU))
    assert cf._SET_ASIDE_BEFORE == {}
    cf.restore_persisting_l2()
    for call in (lambda: cf.persisting_l2_set_aside(CPU),
                 lambda: cf.set_persisting_l2_set_aside(CPU, 0)):
        with pytest.raises(RuntimeError, match="is not a card"):
            call()


# -------------------------------------------- dense fourstep / sixstep


@pytest.mark.parametrize("n,tile,cb", [(1 << 13, 1 << 9, None),
                                       (1 << 14, 1 << 8, 16),
                                       (1 << 15, 1 << 10, None)])
def test_dense_fourstep_vs_separable_and_numpy(n, tile, cb):
    xr, xi = _t(*_planes(n + 2, n))
    dense = cf.fft_pi_layout_cuda_fourstep(xr, xi, tile, cb, separable=False)
    sep = cf.fft_pi_layout_cuda_fourstep(xr, xi, tile, cb)
    assert rel_err(*dense, *sep) <= FP32_TOL
    exact = _numpy_pi(xr.numpy(), xi.numpy())
    assert rel_err(*dense, exact.real, exact.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("n,tile,r2", [(1 << 13, 1 << 9, None),
                                       (1 << 14, 1 << 8, 4),
                                       (1 << 15, 1 << 10, 2)])
def test_dense_sixstep_vs_separable_and_numpy(n, tile, r2):
    xr, xi = _t(*_planes(n + 3, n))
    dense = cf.fft_pi_layout_cuda_sixstep(xr, xi, tile, r2, separable=False)
    sep = cf.fft_pi_layout_cuda_sixstep(xr, xi, tile, r2)
    assert rel_err(*dense, *sep) <= FP32_TOL
    exact = _numpy_pi(xr.numpy(), xi.numpy())
    assert rel_err(*dense, exact.real, exact.imag) <= SPLIT3_TOL


def test_dense_plain_versions_compose_long_range_dense():
    R, tile = 8, 256
    xr, xi = _t(*_planes(17, (R, tile)))
    tables = twiddle.dense_long_range_tables(R, tile, CPU)
    tw = twiddle.flat_tables(tile, CPU)
    yr, yi = cf.fourstep(xr, xi, *tables, *tw, cb=32, separable=False)
    lr, li = cf.long_range_dense(xr[None], xi[None], *tables, cb=32)
    tr, ti = cf.tile_fft(lr[0], li[0], *tw)
    assert torch.equal(yr, tr) and torch.equal(yi, ti)


def test_dense_modes_count_their_operands():
    R, tile = 8, 256
    fac = twiddle.device_factors(R, tile, CPU)
    tw = twiddle.flat_tables(tile, CPU)
    z = torch.zeros(R, tile)
    # separable factors handed to the dense mode: four operands, not two
    with pytest.raises(ValueError, match="expected 4 twiddle operands"):
        cf.fourstep(z, z, *fac, *tw, separable=False)
    with pytest.raises(ValueError, match="expected 6 twiddle operands"):
        cf.sixstep(torch.zeros(2, 4, tile), torch.zeros(2, 4, tile),
                   *twiddle.dense_long_range_tables(2, 4 * tile, CPU), *tw,
                   separable=False)


# ------------------------------------------------------ plans, ladder


def test_launch_counts_cover_every_kernel():
    assert [k.__name__ for k in cf.KERNELS] == [
        "tile_fft", "long_range_sep", "long_range_dense", "fourstep",
        "sixstep", "fused", "matmul_funnel", "gpu_rows"]
    for k in cf.KERNELS:
        k.launches = 5
    cf.reset_launch_counts()
    assert all(k.launches == 0 for k in cf.KERNELS)
    # CPU tensors take the plain versions, which count nothing
    cf.fft_pi_layout_cuda_fused(*_t(*_planes(18, 1 << 12)), tile=256)
    cf.fft_pi_layout_cuda2(*_t(*_planes(19, 1 << 12)), tile=256)
    cf.fft_pi_layout_cuda_mf(*_t(*_planes(20, 1 << 14)))
    from cs87project_msolano2_tpu_torch.hw.lowering import fft_rows_gpu

    fft_rows_gpu(*_t(*_planes(21, (8, 256))))
    assert all(k.launches == 0 for k in cf.KERNELS)


def test_only_mf_is_unported():
    # mf is served since the matmul funnel's kernel, and the any-length
    # family since its own slice: every variant of the reference's
    # ladder builds
    from cs87project_msolano2_tpu_torch.ops.anylen import ANYLEN_VARIANTS

    assert ANYLEN_VARIANTS == ("bluestein", "rader", "mixedradix")
    for variant in ANYLEN_VARIANTS:
        assert callable(ladder.build_executor(
            plans.make_key(8191 if variant == "rader" else 1000,
                           device="cpu"), variant, {}))
    key = plans.make_key(1 << 20, device="cpu")
    for variant, params in (("fused", {"tile": 1 << 14, "qb": 2}),
                            ("fused-alias", {"tile": 1 << 14, "qb": 1}),
                            ("two-kernel", {"tile": 1 << 14, "cb": 32}),
                            ("fourstep", {"tile": 1 << 14,
                                          "separable": False}),
                            ("mf", {"R": 128})):
        assert callable(ladder.build_executor(key, variant, params))


@pytest.mark.parametrize("shape,want", [
    ((4096, 4096), "rows"), ((1 << 17,), "rql"), ((1 << 20,), "rql"),
    ((1 << 21,), "fourstep"), ((1 << 24,), "fourstep"),
    ((1 << 25,), "sixstep"), ((1 << 27,), "sixstep"), ((64,), "stages"),
    ((2, 1 << 17), "stages")])
def test_static_default_is_unchanged(shape, want):
    # the tuned path adds raced variants; the untuned answer stays
    key = plans.make_key(shape[-1], shape[:-1], device="cpu")
    assert ladder.static_default(key)[0] == want


EXECUTOR_CASES = [
    ("fused", {"tile": 256, "qb": 1}),
    ("fused-alias", {"tile": 256, "qb": 2}),
    ("two-kernel", {"tile": 256, "cb": 32}),
    ("fourstep", {"tile": 256, "cb": None, "separable": False}),
    ("sixstep", {"tile": 256, "r2": None, "cb1": None, "cb2": None,
                 "separable": False}),
]


@pytest.mark.parametrize("layout", ["pi", "natural"])
@pytest.mark.parametrize("variant,params", EXECUTOR_CASES)
def test_new_executors_leave_the_callers_planes_unchanged(variant, params,
                                                          layout):
    # through the plan, as a caller reaches an executor: fused-alias
    # writes over its input, so the plan hands it copies of the caller's
    from cs87project_msolano2_tpu_torch.plans.core import Plan

    n = 1 << 12
    key = plans.make_key(n, layout=layout, device="cpu")
    plan = Plan(key=key, variant=variant, params=params, source="tuned")
    xr, xi = _t(*_planes(20, n))
    keep = xr.clone(), xi.clone()
    yr, yi = plan.execute(xr, xi)
    assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])
    exact = np.fft.fft(xr.double().numpy() + 1j * xi.double().numpy())
    if layout == "pi":
        exact = pi_layout_to_natural(exact)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("variant,params", EXECUTOR_CASES)
def test_only_fused_alias_writes_over_its_input(variant, params):
    n = 1 << 12
    key = plans.make_key(n, layout="pi", device="cpu")
    run = ladder.build_executor(key, variant, params)
    assert run.consumes_input == (variant == "fused-alias")
    xr, xi = _t(*_planes(23, n))
    keep = xr.clone(), xi.clone()
    yr, yi = run(xr, xi)
    assert (yr.data_ptr() == xr.data_ptr()) == run.consumes_input
    assert torch.equal(xr, keep[0]) != run.consumes_input
    exact = _numpy_pi(*(k.numpy() for k in keep))
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_copies_only_planes_the_caller_still_holds(inverse):
    # fft's own split of x goes to fused-alias as it is; planes that are
    # the caller's are copied first
    from cs87project_msolano2_tpu_torch.plans.core import Plan

    n = 1 << 12
    key = plans.make_key(n, device="cpu")
    plan = Plan(key=key, variant="fused-alias",
                params={"tile": 256, "qb": 1}, source="tuned")
    x = torch.complex(*_t(*_planes(24, n)))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    pr, pi = plan._planes(xr, xi, x, both=not inverse)
    assert pr is xr and pi is xi
    pr, pi = plan._planes(xr, xi, None, both=not inverse)
    assert pr.data_ptr() != xr.data_ptr() and torch.equal(pr, xr)
    assert (pi is xi) == inverse
    # numpy on the CPU shares memory through torch.from_numpy: copied
    ar, ai = _planes(24, n)
    pr, _ = plan._planes(ar, ai, None, both=True)
    assert not np.shares_memory(pr.numpy(), ar)


def test_tuned_fused_plan_serves_fft_on_the_cpu():
    # a stored fused winner serves the API end to end
    from cs87project_msolano2_tpu_torch.models.fft import fft
    from cs87project_msolano2_tpu_torch.plans.core import Plan

    n = 1 << 12
    key = plans.make_key(n, device="cpu")
    plan = Plan(key=key, variant="fused-alias",
                params={"tile": 256, "qb": 1}, source="cache")
    rng = np.random.default_rng(21)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    y = fft(x, plan=plan, device="cpu").numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    assert rel_err(y.real, y.imag, ref.real, ref.imag) <= SPLIT3_TOL
