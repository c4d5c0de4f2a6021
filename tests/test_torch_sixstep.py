"""The port's sixstep path on the CPU (plain versions): the composition
against numpy float64, the JAX package's rql (interpret mode) and the
port's own rql at equal n for several splits and column blocks; the
split and column-block helpers against the reference's; the separable
factors of both long-range phases bit-identical to the reference's; the
budget errors; a round trip through a sixstep plan.  The kernel itself
runs in ``test_torch_cuda.py``."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.models import fft as F
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import Plan
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
# split3 budget: the reference's MXU tail is ~4e-6 from exact
SPLIT3_TOL = 1e-5
# sixstep and rql run float32 levels whose twiddles are rebuilt from
# different separable factors: float rounding apart
FP32_TOL = 1e-6


def _planes(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@lru_cache(maxsize=None)
def _reference_rql(n, tile):
    # the reference's sixstep does not run on this jax; its rql
    # produces the same pi-layout array and runs in interpret mode
    xr, xi = _planes(n, n)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(jnp.asarray(xr),
                                             jnp.asarray(xi), tile=tile)
    return np.asarray(rr) + 1j * np.asarray(ri)


# (n, tile, r2, cb1, cb2)
CASES = [(1 << 14, 1 << 8, None, None, None), (1 << 14, 1 << 8, 2, None, None),
         (1 << 14, 1 << 8, 4, 8, 16), (1 << 14, 1 << 8, 32, None, None),
         (1 << 13, 1 << 9, None, None, None), (1 << 13, 1 << 9, 8, 64, 8),
         (1 << 15, 1 << 9, 4, None, None)]


@pytest.mark.parametrize("n,tile,r2,cb1,cb2", CASES)
def test_sixstep_vs_numpy_and_reference_rql(n, tile, r2, cb1, cb2):
    xr, xi = _planes(n, n)
    yr, yi = cf.fft_pi_layout_cuda_sixstep(*_t(xr, xi), tile=tile, r2=r2,
                                           cb1=cb1, cb2=cb2)
    assert yr.shape == (n,) and yr.dtype == torch.float32
    exact = pi_layout_to_natural(
        np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64)))
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL
    ref = _reference_rql(n, tile)
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("n,tile,r2,cb1,cb2", CASES)
def test_sixstep_vs_port_rql_and_fourstep(n, tile, r2, cb1, cb2):
    xr, xi = _t(*_planes(n + 2, n))
    six = cf.fft_pi_layout_cuda_sixstep(xr, xi, tile, r2, cb1, cb2)
    assert rel_err(*six, *cf.fft_pi_layout_cuda_rql(xr, xi, tile=tile)) \
        <= FP32_TOL
    assert rel_err(*six, *cf.fft_pi_layout_cuda_fourstep(xr, xi, tile)) \
        <= FP32_TOL


@pytest.mark.parametrize("tile", [1 << k for k in range(7, 17)])
def test_auto_split_matches_reference(tile):
    for k in range(10, 31):
        n = 1 << k
        if n // tile < 4:
            for split in (cf.sixstep_auto_split, ref_pf.sixstep_auto_split):
                if n >= tile:
                    with pytest.raises(ValueError, match="R = n/tile >= 4"):
                        split(n, tile)
            continue
        assert cf.sixstep_auto_split(n, tile) == \
            ref_pf.sixstep_auto_split(n, tile)


@pytest.mark.parametrize("n,tile", [(1 << 14, 1 << 8), (1 << 15, 1 << 9),
                                    (1 << 25, 1 << 14)])
@pytest.mark.parametrize("r2", [None, 4])
def test_factors_bit_identical_to_reference(n, tile, r2):
    R1, R2 = (cf.sixstep_auto_split(n, tile) if r2 is None
              else (n // tile // r2, r2))
    for rows, cols in ((R1, R2 * tile), (R2, tile)):
        ours = twiddle.long_range_factors(rows, cols)
        ref = ref_pf._long_range_factors(rows, cols)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,want", [
    (1 << 25, (256, 512)), (1 << 26, (256, 256)), (1 << 27, (128, 256))])
def test_auto_cbs_policy(n, want):
    tile = cf.MAX_SMEM_TILE
    assert cf.sixstep_auto_cbs(n, tile) == want
    R1, R2 = cf.sixstep_auto_split(n, tile)
    assert cf.sixstep_smem_bytes(R1, want[0], R2, want[1], tile) \
        <= cf.SMEM_LIMIT_BYTES
    assert cf.sixstep_blocking(n) == (tile, R1, R2, *want)


def test_auto_cbs_follow_an_explicit_split():
    # a deeper inner radix narrows the inner block, widens the outer one
    assert cf.sixstep_auto_cbs(1 << 25, 1 << 14, r2=256) == (2048, 64)


@pytest.mark.parametrize("r2", [1, 3, 2048, 4096])
def test_bad_r2_raises_at_build(r2):
    key = plans.make_key(1 << 25, device="cpu")
    with pytest.raises(ValueError, match=f"r2={r2} must be a power of two"):
        ladder.build_executor(key, "sixstep", {"tile": 1 << 14, "r2": r2})


@pytest.mark.parametrize("cbs,pair", [({"cb1": 1024}, "R1=64 x cb1=1024"),
                                      ({"cb2": 4096}, "R2=32 x cb2=4096")])
def test_over_budget_cbs_raise_at_build(cbs, pair):
    key = plans.make_key(1 << 25, device="cpu")
    with pytest.raises(ValueError, match=f"{pair}.*limit 232448"):
        ladder.build_executor(key, "sixstep", {"tile": 1 << 14, **cbs})


@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
def test_sixstep_needs_two_radices(n):
    xr, xi = torch.zeros(n), torch.zeros(n)
    with pytest.raises(ValueError, match="R = n/tile >= 4"):
        cf.fft_pi_layout_cuda_sixstep(xr, xi)


@pytest.mark.parametrize("bad", ["outer", "inner", "tables", "split", "cb"])
def test_sixstep_rejects_bad_operands(bad):
    R1, R2, tile, cb1, cb2 = 4, 4, 256, 32, 32
    outer = list(twiddle.device_factors(R1, R2 * tile, CPU))
    inner = list(twiddle.device_factors(R2, tile, CPU))
    tw = list(twiddle.flat_tables(tile, CPU))
    shape = (R1, R2, tile)
    if bad == "outer":
        outer[2] = outer[2][:, :tile].contiguous()
    elif bad == "inner":
        inner[0] = inner[0][:1].contiguous()
    elif bad == "tables":
        tw[1] = tw[1][:10].contiguous()
    elif bad == "split":
        shape = (1, R1 * R2, tile)
    else:
        cb2 = 5
    with pytest.raises(ValueError):
        cf.sixstep(torch.zeros(shape), torch.zeros(shape), *outer, *inner,
                   *tw, cb1=cb1, cb2=cb2)


def test_round_trip_through_a_sixstep_plan():
    n, tile = 1 << 14, 1 << 8
    key = plans.make_key(n, device="cpu")
    pl = Plan(key=key, variant="sixstep",
              params={"tile": tile, "r2": 4, "cb1": None, "cb2": None,
                      "separable": True}, device="cpu")
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    y = F.fft(x, plan=pl, device="cpu")
    exact = np.fft.fft(x.astype(np.complex128))
    assert rel_err(y.real, y.imag, exact.real, exact.imag) <= SPLIT3_TOL
    back = F.ifft(y, plan=pl).numpy()
    assert rel_err(back.real, back.imag, x.real, x.imag) <= SPLIT3_TOL


def test_pi_layout_sixstep_plan():
    n, tile = 1 << 13, 1 << 9
    key = plans.make_key(n, layout="pi", device="cpu")
    run = ladder.build_executor(key, "sixstep", {"tile": tile})
    xr, xi = _planes(n, n)
    yr, yi = run(*_t(xr, xi))
    ref = _reference_rql(n, tile)
    assert rel_err(yr, yi, ref.real, ref.imag) <= SPLIT3_TOL
