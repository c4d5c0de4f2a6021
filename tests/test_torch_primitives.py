"""Port primitives against the JAX package: bit utilities, twiddle
tables and long-range factors (bit-identical copies), precision tables,
verification oracles, and the butterfly stages (float32 rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import bits as ref_bits
from cs87project_msolano2_tpu.ops import butterfly as ref_bf
from cs87project_msolano2_tpu.ops import precision as ref_prec
from cs87project_msolano2_tpu.ops.pallas_fft import _long_range_factors
from cs87project_msolano2_tpu.ops.twiddle import twiddle_tables as ref_tw
from cs87project_msolano2_tpu.utils import verify as ref_verify
from cs87project_msolano2_tpu_torch.ops import bits, butterfly, precision
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.utils import verify

# float32 rounding: both sides do the same float32 ops in the same
# order; the bound only admits a different fused/contracted rounding
STAGE_TOL = 1e-6


def _planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel_l2(ar, ai, br, bi):
    return precision.rel_err(ar, ai, br, bi)


@pytest.mark.parametrize("n", [1, 2, 8, 1024, 1 << 16])
def test_bits_match_reference(n):
    assert bits.ilog2(n) == ref_bits.ilog2(n)
    assert np.array_equal(bits.bit_reverse_indices(n),
                          ref_bits.bit_reverse_indices(n))
    for v in (0, 1, n - 1, n // 3):
        b = bits.ilog2(n)
        assert bits.bit_reverse(v, b) == ref_bits.bit_reverse(v, b)


def test_bits_reject_non_power_of_two():
    with pytest.raises(ValueError):
        bits.ilog2(12)


@pytest.mark.parametrize("n", [2, 8, 128, 4096, 1 << 17])
def test_twiddle_tables_bit_identical(n):
    ours, ref = twiddle.twiddle_tables(n), ref_tw(n)
    assert len(ours) == len(ref)
    for (wr, wi), (rr, ri) in zip(ours, ref):
        assert wr.dtype == rr.dtype == np.float32
        assert np.array_equal(wr, rr) and np.array_equal(wi, ri)


@pytest.mark.parametrize("R,C", [(2, 128), (8, 512), (64, 1 << 14)])
def test_long_range_factors_bit_identical(R, C):
    for ours, ref in zip(twiddle.long_range_factors(R, C),
                         _long_range_factors(R, C)):
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        assert np.array_equal(ours, ref)


def test_tables_from_reference_carry_over():
    n = 256
    tabs = twiddle.tables_from_reference(ref_tw(n), "cpu")
    for (wr, wi), (rr, ri) in zip(tabs, ref_tw(n)):
        assert wr.dtype == torch.float32 and wr.device.type == "cpu"
        assert np.array_equal(wr.numpy(), rr)
        assert np.array_equal(wi.numpy(), ri)
    flat_r, flat_i = twiddle.flat_tables(n, torch.device("cpu"))
    assert np.array_equal(flat_r.numpy(),
                          np.concatenate([t[0] for t in ref_tw(n)]))
    assert np.array_equal(flat_i.numpy(),
                          np.concatenate([t[1] for t in ref_tw(n)]))


def test_factors_from_reference_carry_over():
    R, C = 16, 256
    ar, ai, br, bi = twiddle.factors_from_reference(
        *_long_range_factors(R, C), "cpu")
    assert ar.shape == (R - 1,) and br.shape == (4, C)
    own = twiddle.device_factors(R, C, torch.device("cpu"))
    for a, b in zip((ar, ai, br, bi), own):
        assert torch.equal(a, b) and a.is_contiguous()


def test_precision_tables_match_reference():
    assert precision.STORAGE_DTYPES == ref_prec.STORAGE_DTYPES
    assert precision.ERROR_BUDGETS == ref_prec.ERROR_BUDGETS
    assert precision.PRECISIONS == ref_prec.PRECISIONS
    assert precision.PROMOTE_CHAIN == ref_prec.PROMOTE_CHAIN
    for mode in precision.PRECISIONS:
        assert precision.storage_dtype(mode) == ref_prec.storage_dtype(mode)
    with pytest.raises(ValueError):
        precision.storage_dtype("tf32")


@pytest.mark.parametrize("mode", ["split3", "highest", "fp32", "default"])
def test_fp32_storage_modes_are_served(mode):
    assert precision.ported_storage(mode) == "float32"


def test_bf16_storage_not_ported():
    with pytest.raises(NotImplementedError, match="bf16 storage"):
        precision.ported_storage("bf16")


def test_rel_err_matches_reference():
    rng = np.random.default_rng(3)
    a = _planes(rng, (64,))
    b = _planes(rng, (64,))
    assert precision.rel_err(*a, *b) == ref_prec.rel_err(*a, *b)
    assert precision.rel_err(torch.from_numpy(a[0]), a[1], *b) == \
        ref_prec.rel_err(*a, *b)


def test_verify_oracles_match_reference():
    assert np.array_equal(verify.golden_input(), ref_verify.golden_input())
    assert np.array_equal(verify.golden_expected(),
                          ref_verify.golden_expected())
    rng = np.random.default_rng(4)
    x = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    assert np.array_equal(verify.naive_dft(x), ref_verify.naive_dft(x))
    assert np.array_equal(verify.pi_layout_to_natural(x),
                          ref_verify.pi_layout_to_natural(x))
    y = x + 1e-3
    assert verify.rel_err(x, y) == ref_verify.rel_err(x, y)
    assert verify.max_abs_err(x, y) == ref_verify.max_abs_err(x, y)


@pytest.mark.parametrize("shape,half", [((64,), 32), ((4, 256), 32),
                                        ((3, 2, 512), 128)])
def test_stage_full_matches_reference(shape, half):
    rng = np.random.default_rng(5)
    xr, xi = _planes(rng, shape)
    wr, wi = _planes(rng, (half,))
    ours = butterfly.stage_full(*(torch.from_numpy(a)
                                  for a in (xr, xi, wr, wi)))
    ref = ref_bf.stage_full(*(jnp.asarray(a) for a in (xr, xi, wr, wi)))
    assert ours[0].shape == shape
    assert _rel_l2(*ours, *ref) <= STAGE_TOL


@pytest.mark.parametrize("p", [1, 2, 8])
def test_stage_half_matches_reference(p):
    rng = np.random.default_rng(6)
    xr, xi = _planes(rng, (p, 256))
    wr, wi = _planes(rng, (128,))
    bottom = (np.arange(p) & 1)[:, None].astype(np.int32)
    ours = butterfly.stage_half(
        *(torch.from_numpy(a) for a in (xr, xi, wr, wi)),
        torch.from_numpy(bottom))
    ref = ref_bf.stage_half(*(jnp.asarray(a) for a in (xr, xi, wr, wi)),
                            jnp.asarray(bottom))
    assert ours[0].shape == (p, 128)
    assert _rel_l2(*ours, *ref) <= STAGE_TOL


@pytest.mark.parametrize("bottom", [0, 1])
def test_stage_half_scalar_bottom(bottom):
    rng = np.random.default_rng(7)
    xr, xi = _planes(rng, (64,))
    wr, wi = _planes(rng, (32,))
    ours = butterfly.stage_half(
        *(torch.from_numpy(a) for a in (xr, xi, wr, wi)), bottom)
    ref = ref_bf.stage_half(*(jnp.asarray(a) for a in (xr, xi, wr, wi)),
                            jnp.int32(bottom))
    assert _rel_l2(*ours, *ref) <= STAGE_TOL


def test_to_natural_is_bit_reverse_gather():
    rng = np.random.default_rng(8)
    yr, yi = _planes(rng, (3, 64))
    nr, ni = bits.to_natural(torch.from_numpy(yr), torch.from_numpy(yi))
    idx = ref_bits.bit_reverse_indices(64)
    assert np.array_equal(nr.numpy(), yr[:, idx])
    assert np.array_equal(ni.numpy(), yi[:, idx])
