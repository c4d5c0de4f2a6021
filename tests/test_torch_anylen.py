"""The port's any-length plans on the CPU (plain versions), mirroring the
reference's tests/test_anylen.py for the modules ported: the pad policy,
variant routing and primitive roots against the reference, the host
tables bit for bit against the reference's, numpy parity across the
Bluestein/Rader/mixed-radix matrix (forward and inverse, c2c and the
odd real domains, batched), the mixed pads' one-level recursion, the
table cache's hits and its device key, and the race's candidates and
static defaults against the reference's.  The comparisons against the
reference run its CPU path on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import plans as ref_plans
from cs87project_msolano2_tpu.ops import anylen as ref_anylen
from cs87project_msolano2_tpu.plans import cache as ref_cache
from cs87project_msolano2_tpu.plans import ladder as ref_ladder
from cs87project_msolano2_tpu.plans.core import PlanKey as RefPlanKey
from cs87project_msolano2_tpu_torch import obs, plans
from cs87project_msolano2_tpu_torch.models.fft import fft, ifft
from cs87project_msolano2_tpu_torch.obs import metrics as obs_metrics
from cs87project_msolano2_tpu_torch.models.real import (
    irfft_planes_fast,
    rfft_planes_fast,
)
from cs87project_msolano2_tpu_torch.ops import anylen
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import PlanKey

#: the split3 forward budget, and the round trip's (two transforms)
TOL = 1e-5
RT_TOL = 1e-4
#: lengths of the pad and routing comparisons: primes around RADER_MIN_N,
#: odd parts on both sides of MIXEDRADIX_MAX_ODD, the slice's card sizes
NS = (2, 3, 5, 7, 63, 67, 100, 127, 513, 700, 719, 720, 999, 1000, 1025,
      3072, 4097, 8190, 8191, 327680, 1048573, 1594323)


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    plan_cache.clear(memory=True, disk=False)
    ref_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)
    ref_cache.clear(memory=True, disk=False)


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _planes(rng, n, batch=()):
    return (rng.standard_normal(batch + (n,)).astype(np.float32),
            rng.standard_normal(batch + (n,)).astype(np.float32))


def _c(yr, yi):
    return np.asarray(yr) + 1j * np.asarray(yi)


# --- host policy, against the reference ----------------------------------


def test_pad_candidates_properties():
    for n in (3, 5, 7, 63, 100, 127, 719, 720, 999, 1000, 4097, 8190):
        cands = anylen.pad_candidates(n)
        lo = max(2 * n - 1, 2)
        naive = anylen.next_pow2(lo)
        assert cands == sorted(cands)
        assert 1 <= len(cands) <= 3
        assert naive in cands
        for p in cands:
            assert naive >= p >= lo
            assert anylen.odd_split(p)[1] in (1, 3, 5)
        assert anylen.default_pad(n) == cands[0]


def test_host_policy_matches_the_reference():
    assert (anylen.MIXEDRADIX_MAX_ODD, anylen.RADER_MIN_N,
            anylen.ANYLEN_VARIANTS) == (ref_anylen.MIXEDRADIX_MAX_ODD,
                                        ref_anylen.RADER_MIN_N,
                                        ref_anylen.ANYLEN_VARIANTS)
    for n in NS + tuple(range(1, 200)):
        assert anylen.pad_candidates(n) == ref_anylen.pad_candidates(n)
        assert anylen.default_pad(n) == ref_anylen.default_pad(n)
        assert anylen.is_pow2(n) == ref_anylen.is_pow2(n)
        assert anylen.next_pow2(n) == ref_anylen.next_pow2(n)
        assert anylen.odd_split(n) == ref_anylen.odd_split(n)
        assert anylen.is_prime(n) == ref_anylen.is_prime(n)
        if not anylen.is_pow2(n):
            assert anylen.plan_variant(n) == ref_anylen.plan_variant(n)
    for p in (3, 7, 67, 127, 8191, 1048573):
        assert anylen.primitive_root(p) == ref_anylen.primitive_root(p)


def test_plan_variant_routing():
    assert anylen.plan_variant(127) == "rader"
    assert anylen.plan_variant(8191) == "rader"
    assert anylen.plan_variant(1048573) == "rader"
    assert anylen.plan_variant(7) == "mixedradix"
    assert anylen.plan_variant(720) == "mixedradix"
    assert anylen.plan_variant(1000) == "mixedradix"
    assert anylen.plan_variant(5 << 16) == "mixedradix"
    assert anylen.plan_variant(999) == "bluestein"
    assert anylen.plan_variant(3 ** 13) == "bluestein"
    with pytest.raises(ValueError):
        anylen.plan_variant(1024)


def test_primitive_root_generates():
    for p in (7, 127, 8191):
        g = anylen.primitive_root(p)
        assert {pow(g, q, p) for q in range(p - 1)} == set(range(1, p))


# --- host tables, bit for bit --------------------------------------------


@pytest.mark.parametrize("n,pad", [(7, 16), (999, 2048), (700, 1536),
                                   (3 ** 7, 5 * 2 ** 10)])
def test_bluestein_tables_match_the_reference(n, pad):
    got = anylen.bluestein_host_tables(n, pad)
    ref = ref_anylen.bluestein_tables(n, pad)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("p,pad", [(67, 256), (127, 256), (8191, 16384),
                                   (8191, 3 << 13)])
def test_rader_tables_match_the_reference(p, pad):
    got = anylen.rader_host_tables(p, pad)
    ref = ref_anylen.rader_tables(p, pad)
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))
    assert got[0].dtype == np.int32 and got[2].dtype == np.float32


@pytest.mark.parametrize("n,m,n2", [(1000, 125, 8), (720, 45, 16),
                                    (7, 7, 1), (5 << 16, 5, 1 << 16)])
def test_mixedradix_tables_match_the_reference(n, m, n2):
    got = anylen.mixedradix_host_tables(n, m, n2)
    ref = ref_anylen.mixedradix_tables(n, m, n2)
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))


def test_table_pads_are_checked():
    with pytest.raises(ValueError, match="2n-1"):
        anylen.bluestein_host_tables(999, 1024)
    with pytest.raises(ValueError, match=r"2\(p-1\)-1"):
        anylen.rader_host_tables(127, 128)


# --- parity: the matrix, against numpy -----------------------------------


@pytest.mark.parametrize("n", [2, 7, 127, 720, 999, 3072])
def test_c2c_forward_and_inverse_parity(n):
    rng = np.random.default_rng(n)
    xr, xi = _planes(rng, n)
    p = plans.plan(n, device="cpu")
    yr, yi = p.execute(xr, xi)
    ref = np.fft.fft(xr.astype(np.complex128) + 1j * xi.astype(np.complex128))
    assert _rel(_c(yr, yi), ref) <= TOL
    ir, ii = p.execute_inverse(yr, yi)
    assert _rel(_c(ir, ii), xr + 1j * xi) <= RT_TOL
    if n != 2:
        assert p.variant == anylen.plan_variant(n)
    # the user entry points go through the same plan
    y = fft(xr + 1j * xi, device="cpu")
    assert _rel(y.numpy(), ref) <= TOL
    assert _rel(ifft(y).numpy(), xr + 1j * xi) <= RT_TOL


def test_rader_large_prime_parity():
    n = 8191
    rng = np.random.default_rng(13)
    xr, xi = _planes(rng, n)
    p = plans.plan(n, device="cpu")
    assert (p.variant, p.params) == ("rader", {"pad": 16384})
    ref = np.fft.fft(xr.astype(np.complex128) + 1j * xi.astype(np.complex128))
    assert _rel(_c(*p.execute(xr, xi)), ref) <= TOL


@pytest.mark.parametrize("n", [7, 720, 999, 1000])
def test_real_domain_parity(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    hr, hi = rfft_planes_fast(x, device="cpu")
    assert hr.shape[-1] == n // 2 + 1
    assert _rel(_c(hr, hi), np.fft.rfft(x.astype(np.float64))) <= TOL
    back = irfft_planes_fast(hr, hi, n=n)
    assert back.shape == (n,)
    assert _rel(back.numpy(), x.astype(np.float64)) <= RT_TOL
    # odd n takes the any-length variant at n, even n the c2c plan at n/2
    served = plans.plan_for((n,), domain="r2c", device="cpu").variant
    assert served == plans.plan(n if n % 2 else n // 2, device="cpu").variant


def test_batched_any_length():
    n = 1000
    rng = np.random.default_rng(5)
    xr, xi = _planes(rng, n, batch=(3,))
    p = plans.plan_for((3, n), device="cpu")
    yr, yi = p.execute(xr, xi)
    ref = np.fft.fft(xr.astype(np.complex128)
                     + 1j * xi.astype(np.complex128), axis=-1)
    assert _rel(_c(yr, yi), ref) <= TOL


@pytest.mark.parametrize("n", [127, 720, 999])
def test_c2c_matches_the_reference(n):
    # the same seeded input through the reference's any-length plan on
    # its CPU path: the same variant and pad, the same answer
    rng = np.random.default_rng(n + 1)
    xr, xi = _planes(rng, n, batch=(2,))
    rp = ref_plans.plan_for((2, n), layout="natural")
    p = plans.plan_for((2, n), device="cpu")
    assert (p.variant, p.params) == (rp.variant, rp.params)
    ref = _c(*rp.execute(xr, xi))
    got = _c(*p.execute(xr, xi))
    exact = np.fft.fft(xr.astype(np.complex128)
                       + 1j * xi.astype(np.complex128), axis=-1)
    assert _rel(got, exact) <= TOL and _rel(ref, exact) <= TOL
    assert _rel(got, ref) <= TOL


def test_mixed_pads_recurse_one_level():
    # a 3 * 2^j pad's subplan is a mixedradix split over a batched power
    # of two, which the rows kernel (its plain version) serves
    n, pad = 700, 1536
    assert anylen.pad_candidates(n) == [1536, 2048]
    key = plans.make_key(n, device="cpu")
    sub = plans.plan(pad, device="cpu")
    assert (sub.variant, sub.params) == ("mixedradix", {})
    assert ladder.static_default(plans.make_key(512, (3,), device="cpu")) \
        == ("rows", {})
    rng = np.random.default_rng(17)
    xr, xi = _planes(rng, n)
    ref = np.fft.fft(xr.astype(np.complex128) + 1j * xi.astype(np.complex128))
    for p in anylen.pad_candidates(n):
        fn = ladder.build_executor(key, "bluestein", {"pad": p})
        got = _c(*fn(torch.from_numpy(xr), torch.from_numpy(xi)))
        assert _rel(got, ref) <= TOL


def test_chirp_cache_hits():
    """The table cache's lookups on
    ``pifft_anylen_chirp_cache_total{result}``, obs armed around exactly
    the counted calls."""
    def count(result):
        return obs_metrics.counter_value("pifft_anylen_chirp_cache_total",
                                         result=result)

    anylen.chirp_cache_clear()
    obs.enable()
    try:
        a = anylen.bluestein_tables(999, 2048, device="cpu")
        b = anylen.bluestein_tables(999, 2048, device="cpu")
        assert a is b
        assert count("miss") == 1
        assert count("hit") == 1
        # the device is part of the key: no table crosses devices
        c = anylen.bluestein_tables(999, 2048, device="meta")
        assert c is not a and c[0].device.type == "meta"
        assert count("miss") == 2
        # an executor resolves its tables once per device, not per call
        key = plans.make_key(999, device="cpu")
        fn = ladder.build_executor(key, "bluestein", {"pad": 2048})
        x = torch.zeros(999)
        hits = count("hit")
        fn(x, x)
        fn(x, x)
        assert count("hit") - hits == 1
    finally:
        obs.disable()
        obs_metrics.reset()


# --- ladder routing, against the reference -------------------------------


def test_candidates_race_pads():
    key = plans.make_key(999, device="cpu")
    cands = ladder.candidates(key)
    assert {p["pad"] for v, p in cands if v == "bluestein"} >= \
        set(anylen.pad_candidates(999))
    assert all(v in anylen.ANYLEN_VARIANTS for v, _ in cands)


@pytest.mark.parametrize("n", [7, 127, 700, 720, 999, 1000, 8191,
                               1048573, 3 ** 13, 5 << 16])
@pytest.mark.parametrize("precision", ["split3", "bf16"])
def test_candidates_and_static_default_match_the_reference(n, precision):
    key = plans.make_key(n, precision=precision, device="cpu")
    ref = RefPlanKey(device_kind="cpu-interpret", n=n, batch=(),
                     layout="natural", precision=precision,
                     backend="cpu-interpret")
    assert ladder.candidates(key) == ref_ladder.candidates(ref)
    assert ladder.static_default(key) == ref_ladder.static_default(ref)


def test_tune_races_the_pads():
    # the race of an any-length key times every pad; the fastest wins
    # and is stored with its pad
    key = PlanKey(device_kind="NVIDIA H100", n=700)
    assert ladder.candidates(key) == [("mixedradix", {}),
                                      ("bluestein", {"pad": 1536}),
                                      ("bluestein", {"pad": 2048})]
    times = iter([0.3, 0.1, 0.2])
    plan = plans.tune(key, timer=lambda fn, k: next(times),
                      allow_offline=True, persist=False, verbose=False)
    assert (plan.variant, plan.params) == ("bluestein", {"pad": 1536})
    assert [r.status for r in plan.tuning] == ["lost", "won", "lost"]


def test_static_default_variants():
    for n, want in ((127, "rader"), (1000, "mixedradix"),
                    (999, "bluestein")):
        variant, params = ladder.static_default(plans.make_key(n,
                                                               device="cpu"))
        assert variant == want
        if want == "rader":
            assert params["pad"] == anylen.default_pad(n - 1)
        if want == "bluestein":
            assert params["pad"] == anylen.default_pad(n)


def test_pi_layout_still_requires_pow2():
    with pytest.raises(ValueError):
        PlanKey(device_kind="cpu", n=1000, layout="pi")
    PlanKey(device_kind="cpu", n=1024, layout="pi")
    key = PlanKey(device_kind="cpu", n=1024, layout="pi")
    with pytest.raises(ValueError, match="natural order only"):
        ladder.build_executor(key, "bluestein", {"pad": 2048})


def test_real_domain_any_n_keys():
    for n in (999, 1000):
        PlanKey(device_kind="cpu", n=n, domain="r2c")
    with pytest.raises(ValueError):
        PlanKey(device_kind="cpu", n=1, domain="r2c")


def test_gpu_backend_refuses_any_length():
    # as the reference's static default: the gpu family is power-of-two
    with pytest.raises(ValueError, match="power-of-two"):
        plans.plan(1000, device="cpu", backend="gpu")
    with pytest.raises(ValueError, match="power-of-two"):
        plans.plan(999, domain="r2c", device="cpu", backend="gpu")
