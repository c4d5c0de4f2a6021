"""The plain reference and the readings that decide ``correct``."""

import math
import os

import numpy as np
import pytest

from benchlib import check, spec

REF = spec.load_module(os.path.join(spec.BENCH_DIR, "reference",
                                    "numpy_fft.py"))


def direct_dft(x):
    n = x.shape[-1]
    k = np.arange(n)
    return x.astype(np.complex128) @ np.exp(-2j * np.pi * np.outer(k, k) / n)


def test_pi_order_is_the_direct_dft_bit_reversed_at_16():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    want = direct_dft(x)
    got = REF.transform(x, "c2c", "pi")
    for j in range(16):
        natural = int(format(j, "04b")[::-1], 2)
        assert abs(got[j] - want[natural]) < 1e-12


def test_bit_reversal_is_an_involution():
    ref = REF.transform
    x = np.arange(64, dtype=np.complex128)
    pi = ref(np.fft.ifft(x), "c2c", "pi")
    assert np.allclose(ref(np.fft.ifft(pi), "c2c", "pi"), x)


@pytest.mark.parametrize("shape", [(16,), (3, 32)])
def test_natural_and_real_match_the_direct_dft(shape):
    rng = np.random.default_rng(1)
    ref = REF.transform
    x = rng.standard_normal(shape)
    assert np.allclose(ref(x, "c2c", "natural"), direct_dft(x))
    assert np.allclose(ref(x, "r2c", "natural"),
                       direct_dft(x)[..., :shape[-1] // 2 + 1])


def test_pi_order_refused_for_real_input():
    with pytest.raises(ValueError):
        REF.transform(np.zeros(16), "r2c", "pi")


def test_planes_are_taken_as_re_plus_i_im():
    rng = np.random.default_rng(3)
    re, im = rng.standard_normal((2, 4, 32)).astype(np.float32)
    got = REF.expected((re, im), domain="c2c", order="natural")
    assert np.allclose(got, direct_dft(re.astype(np.float64) + 1j * im))
    assert np.array_equal(REF.expected((re,), domain="r2c", order="natural"),
                          np.fft.rfft(re.astype(np.float64), axis=-1))


def test_readings():
    ref = np.fft.fft(np.arange(8.0))
    assert check.readings(ref.copy(), ref) == {"rel_l2": 0.0, "max_err": 0.0}
    bent = ref.copy()
    bent[3] += 1.0
    rms = np.linalg.norm(ref) / math.sqrt(8)
    assert math.isclose(check.readings(bent, ref)["max_err"], 1.0 / rms)
    assert check.readings(ref[:4], ref)["rel_l2"] == math.inf


def test_compare_fails_nan_missing_samples_and_passes_within_limits():
    ref = REF.expected
    args = {"domain": "c2c", "order": "natural"}
    x = np.random.default_rng(2).standard_normal(32).astype(np.complex64)
    y = np.fft.fft(x).astype(np.complex64)
    limits = {"rel_l2": 1e-6, "max_err": 1e-5}
    ok = check.compare([((x,), y)], ref, args, limits)
    assert ok["passed"] and ok["failed"] == 0
    short = check.compare([((x,), y)], ref, args, limits, planned=3)
    assert not short["passed"] and short["failed"] == 2
    y[0] = np.nan
    bad = check.compare([((x,), y)], ref, args, limits)
    assert not bad["passed"] and bad["failed"] == 1
    assert math.isnan(bad["checks"]["rel_l2"]["value"])
    assert not check.compare([], ref, args, limits)["passed"]
