"""The port's fourstep path on the CPU (plain versions): the
composition against numpy float64, the JAX package's rql (interpret
mode) and the port's own rql at equal n; the Hopper budget helpers and
their errors; the ladder's crossovers and executors; a round trip
through a fourstep plan.  The kernel itself runs in
``test_torch_cuda.py``."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.models import fft as F
from cs87project_msolano2_tpu_torch.ops import bits
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import Plan
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
# split3 budget: the reference's MXU tail is ~4e-6 from exact, the
# port's fp32 butterflies ~2e-7
SPLIT3_TOL = 1e-5
# the port's fourstep and rql run the same float32 levels
FP32_TOL = 1e-6


def _planes(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _numpy_pi(xr, xi):
    y = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    return pi_layout_to_natural(y)  # bit reversal is an involution


@lru_cache(maxsize=None)
def _reference_rql(n, tile):
    # the reference's fourstep does not run on this jax; its rql
    # produces the same pi-layout array and runs in interpret mode
    xr, xi = _planes(n, n)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(jnp.asarray(xr),
                                             jnp.asarray(xi), tile=tile)
    return np.asarray(rr) + 1j * np.asarray(ri)


CASES = [(1 << 13, 1 << 9, None), (1 << 13, 1 << 9, 8),
         (1 << 13, 1 << 9, 512), (1 << 14, 1 << 8, None),
         (1 << 14, 1 << 8, 16), (1 << 15, 1 << 10, None)]


@pytest.mark.parametrize("n,tile,cb", CASES)
def test_fourstep_vs_numpy_and_reference_rql(n, tile, cb):
    xr, xi = _planes(n, n)
    yr, yi = cf.fft_pi_layout_cuda_fourstep(*_t(xr, xi), tile=tile, cb=cb)
    assert yr.shape == (n,) and yr.dtype == torch.float32
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL
    ref = _reference_rql(n, tile)
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("n,tile,cb", CASES)
def test_fourstep_vs_port_rql(n, tile, cb):
    xr, xi = _t(*_planes(n + 1, n))
    four = cf.fft_pi_layout_cuda_fourstep(xr, xi, tile=tile, cb=cb)
    rql = cf.fft_pi_layout_cuda_rql(xr, xi, tile=tile)
    assert rel_err(*four, *rql) <= FP32_TOL


def test_fourstep_plain_is_the_rql_composition():
    R, tile = 8, 256
    xr, xi = _t(*_planes(3, (R, tile)))
    fac = twiddle.device_factors(R, tile, CPU)
    tw = twiddle.flat_tables(tile, CPU)
    yr, yi = cf.fourstep(xr, xi, *fac, *tw, cb=32)
    lr, li = cf.long_range_sep(xr[None], xi[None], *fac, cb=32)
    tr, ti = cf.tile_fft(lr[0], li[0], *tw)
    assert torch.equal(yr, tr) and torch.equal(yi, ti)


def test_single_row_takes_the_tile_kernel():
    n = 1 << 10
    xr, xi = _planes(4, n)
    cf.reset_launch_counts()
    yr, yi = cf.fft_pi_layout_cuda_fourstep(*_t(xr, xi))
    exact = _numpy_pi(xr, xi)
    assert cf.fourstep_blocking(n) == (n, 1, None)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


def test_plain_paths_do_not_count_launches():
    cf.reset_launch_counts()
    cf.fft_pi_layout_cuda_fourstep(*_t(*_planes(5, 1 << 12)), tile=256)
    cf.fft_pi_layout_cuda_sixstep(*_t(*_planes(6, 1 << 12)), tile=256)
    assert (cf.fourstep.launches, cf.sixstep.launches) == (0, 0)


@pytest.mark.parametrize("n,variant", [
    (1 << 17, "rql"), (1 << 20, "rql"), (1 << 21, "fourstep"),
    (1 << 22, "fourstep"), (1 << 24, "fourstep"), (1 << 25, "sixstep"),
    (1 << 26, "sixstep"), (1 << 27, "sixstep")])
def test_static_default_crossovers(n, variant):
    # keys only: nothing executes
    got, params = ladder.static_default(plans.make_key(n, device="cpu"))
    assert got == variant
    assert params["tile"] == cf.MAX_SMEM_TILE
    if variant != "rql":
        assert params["separable"] is True


def test_static_default_params_match_the_reference_shape():
    four = ladder.static_default(plans.make_key(1 << 22, device="cpu"))
    six = ladder.static_default(plans.make_key(1 << 25, device="cpu"))
    assert four == ("fourstep", {"tile": 1 << 14, "cb": None,
                                 "separable": True})
    assert six == ("sixstep", {"tile": 1 << 14, "r2": None, "cb1": None,
                               "cb2": None, "separable": True})
    assert (ladder.FOURSTEP_MIN_N, ladder.SIXSTEP_MIN_N) == (1 << 21,
                                                             1 << 25)


def test_fourstep_feasibility_bounds():
    assert ladder._fourstep_feasible(1 << 25)
    assert not ladder._fourstep_feasible(1 << 26)
    assert ladder._sixstep_feasible(1 << 27)
    assert not ladder._sixstep_feasible(1 << 15)  # R < 4 at tile 2^14


# (n, cb, bytes of one block): FOURSTEP_BLOCK_POINTS / R, never below
# one 32-byte sector a row.  A 4096-point block (33,792 bytes padded, as
# a phase-B segment) from 2^21 to 2^23, 1024 x 8 at 2^24, 2048 x 8 at
# 2^25.  The blocks an SM holds are the occupancy API's answer, which
# the card test test_fourstep_resident_blocks_per_sm checks
@pytest.mark.parametrize("n,cb,smem", [(1 << 21, 32, 33792),
                                       (1 << 22, 16, 33792),
                                       (1 << 23, 8, 33792),
                                       (1 << 24, 8, 67584),
                                       (1 << 25, 8, 135168)])
def test_fourstep_auto_cb_policy(n, cb, smem):
    tile = cf.MAX_SMEM_TILE
    assert cf.fourstep_auto_cb(n, tile) == cb
    R = n // tile
    assert cb == max(cf.MIN_AUTO_CB, cf.FOURSTEP_BLOCK_POINTS // R)
    assert cf.fourstep_smem_bytes(R, cb, tile) == smem <= cf.SMEM_LIMIT_BYTES


def test_fourstep_smem_follows_the_kernels_build():
    # fourstep_smem_bytes counts csrc/fourstep.cu's Layout: the larger of
    # phase A's block and a phase-B segment (tile / row_cluster_width),
    # two padded planes, rounded to 16 bytes
    tile = cf.MAX_SMEM_TILE
    assert {R: cf.fourstep_smem_bytes(R, 8, tile)
            for R in (2, 512, 1024, 2048)} == {
        2: 33792, 512: 33792, 1024: 67584, 2048: 135168}
    assert cf.fourstep_smem_bytes(64, 64, 1 << 10) == 33792
    assert cf.fourstep_smem_bytes(2, 8, 256) == 2112
    assert cf.fourstep_smem_bytes(256, 16, 1 << 13) == 33792


def test_fourstep_auto_cb_infeasible_names_the_block():
    with pytest.raises(ValueError,
                       match=r"R=4096 x cb=8 needs 270336 .*limit 232448"):
        cf.fourstep_auto_cb(1 << 26, 1 << 14)


@pytest.mark.parametrize("cb", [64, 2048])
def test_over_budget_cb_raises_at_build(cb):
    key = plans.make_key(1 << 24, device="cpu")
    with pytest.raises(ValueError, match=f"R=1024 x cb={cb}.*limit 232448"):
        ladder.build_executor(key, "fourstep", {"tile": 1 << 14, "cb": cb,
                                                "separable": True})


@pytest.mark.parametrize("cb", [3, 1 << 15])
def test_bad_cb_raises_at_build(cb):
    key = plans.make_key(1 << 22, device="cpu")
    with pytest.raises(ValueError, match="must be a power of two dividing"):
        ladder.build_executor(key, "fourstep", {"tile": 1 << 14, "cb": cb})


@pytest.mark.parametrize("variant", ["fourstep", "sixstep"])
def test_dense_twiddles_not_ported(variant):
    # dense long-range tables (separable=False) are ported now: the
    # entry builds, and an over-budget block still fails before launch
    key = plans.make_key(1 << 25, device="cpu")
    assert callable(ladder.build_executor(key, variant, {
        "tile": 1 << 14, "separable": False}))
    big = {"cb": 2048} if variant == "fourstep" else {"cb1": 2048}
    with pytest.raises(ValueError, match="limit 232448"):
        ladder.build_executor(key, variant, {"tile": 1 << 14,
                                             "separable": False, **big})


def test_batched_key_refuses_whole_transform_variants():
    key = plans.make_key(1 << 21, (2,), device="cpu")
    with pytest.raises(ValueError, match="1-D whole-transform"):
        ladder.build_executor(key, "fourstep", {"tile": 1 << 14})


@pytest.mark.parametrize("bad", ["R", "factors", "tables", "ndim", "cb"])
def test_fourstep_rejects_bad_operands(bad):
    R, tile, cb = 8, 256, 32
    fac = list(twiddle.device_factors(R, tile, CPU))
    tw = list(twiddle.flat_tables(tile, CPU))
    shape = (R, tile)
    if bad == "R":
        shape = (6, tile)
    elif bad == "factors":
        fac[3] = fac[3][:2].contiguous()
    elif bad == "tables":
        tw[0] = tw[0][:100].contiguous()
    elif bad == "ndim":
        shape = (1, R, tile)
    else:
        cb = 7
    with pytest.raises(ValueError):
        cf.fourstep(torch.zeros(shape), torch.zeros(shape), *fac, *tw, cb=cb)


def test_fourstep_composition_wants_one_transform():
    with pytest.raises(ValueError, match="one 1-D transform"):
        cf.fft_pi_layout_cuda_fourstep(torch.zeros(2, 1024),
                                       torch.zeros(2, 1024), tile=256)


def test_round_trip_through_a_fourstep_plan():
    n, tile = 1 << 13, 1 << 9
    key = plans.make_key(n, device="cpu")
    pl = Plan(key=key, variant="fourstep",
              params={"tile": tile, "cb": None, "separable": True},
              device="cpu")
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    y = F.fft(x, plan=pl, device="cpu")
    exact = np.fft.fft(x.astype(np.complex128))
    assert rel_err(y.real, y.imag, exact.real, exact.imag) <= SPLIT3_TOL
    back = F.ifft(y, plan=pl).numpy()
    assert rel_err(back.real, back.imag, x.real, x.imag) <= SPLIT3_TOL
    br, bi = pl.execute_inverse(*pl.execute(x.real, x.imag))
    assert rel_err(br, bi, x.real, x.imag) <= SPLIT3_TOL


def test_fft_at_2_21_rides_the_fourstep_plan():
    n = 1 << 21
    assert plans.plan_for((n,), device="cpu").variant == "fourstep"
    rng = np.random.default_rng(8)
    x = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)) \
        .astype(np.complex64)
    y = F.fft(x, device="cpu").numpy()
    exact = np.fft.fft(x.astype(np.complex128))
    assert y.shape == (n,) and y.dtype == np.complex64
    assert rel_err(y.real, y.imag, exact.real, exact.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("n", [1, 2, 8, 1 << 12])
def test_device_gather_index_matches_bit_reverse_indices(n):
    assert np.array_equal(bits._index_tensor(n, CPU).numpy(),
                          bits.bit_reverse_indices(n))
