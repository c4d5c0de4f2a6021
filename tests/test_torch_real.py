"""The port's half-spectrum real-input transforms on the CPU (plain
versions), mirroring the reference's tests/test_real.py for the modules
ported: rfft/irfft parity and round trips against numpy, Hermitian
symmetry, the complex-input refusal, the pack/merge building blocks,
the r2c path riding rql at 2^18 and fourstep at 2^22, the domain
PlanKey (tokens, validation, io shapes), riding a cached c2c winner,
the inverse refused on real domains, the gpu backend's real keys, the
pad-aware byte model and ``plan warm --domain``.  The comparisons
against the reference run its CPU path on the same seeded numpy
inputs."""

import importlib
import json

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import plans as ref_plans
from cs87project_msolano2_tpu.cli import main as ref_cli_main
from cs87project_msolano2_tpu.plans import cache as ref_cache
from cs87project_msolano2_tpu.plans.core import Plan as RefPlan
from cs87project_msolano2_tpu.plans.core import PlanKey as RefPlanKey
from cs87project_msolano2_tpu.utils import roofline as ref_roofline
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.models import irfft, rfft
from cs87project_msolano2_tpu_torch.models.fft import fft
from cs87project_msolano2_tpu_torch.models.real import (
    _half_twiddles,
    half_twiddles_host,
    hermitian_merge,
    irfft_planes_fast,
    pack_real_planes,
    rfft_planes_fast,
)
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import Plan, PlanKey
from cs87project_msolano2_tpu_torch.utils import roofline

ref_real = importlib.import_module("cs87project_msolano2_tpu.models.real")

#: the split3 forward budget, and the round trip's (two transforms)
TOL = 1e-5
RT_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    plan_cache.clear(memory=True, disk=False)
    ref_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)
    ref_cache.clear(memory=True, disk=False)


def real_input(n, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(batch + (n,)).astype(np.float32)


def rel_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# --- parity and properties, against numpy -------------------------------


@pytest.mark.parametrize("n", [2, 4, 64, 1024, 4096, 16384])
def test_rfft_parity_vs_numpy(n):
    x = real_input(n, seed=1)
    y = rfft(x, device="cpu")
    assert y.shape == (n // 2 + 1,) and y.dtype == torch.complex64
    assert rel_err(y, np.fft.rfft(x.astype(np.float64))) < TOL


def test_rfft_batched_parity():
    x = real_input(512, seed=2, batch=(3, 5))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert rel_err(rfft(x, device="cpu"), ref) < TOL


def test_rfft_hermitian_symmetry_property():
    """The full spectrum of real input is conjugate-symmetric, DC and
    Nyquist are real, and rfft is its non-redundant prefix."""
    n = 2048
    x = real_input(n, seed=3)
    full = fft(x, device="cpu").numpy().astype(np.complex128)
    half = rfft(x, device="cpu").numpy().astype(np.complex128)
    scale = np.max(np.abs(full))
    k = np.arange(1, n)
    assert np.max(np.abs(full[n - k] - np.conj(full[k]))) / scale < TOL
    assert abs(full[0].imag) / scale < TOL
    assert abs(full[n // 2].imag) / scale < TOL
    assert np.max(np.abs(half - full[:n // 2 + 1])) / scale < TOL
    assert half.shape == (n // 2 + 1,)


@pytest.mark.parametrize("n", [4, 256, 4096])
def test_rfft_irfft_roundtrip(n):
    x = real_input(n, seed=4)
    back = irfft(rfft(x, device="cpu"))
    assert back.shape == (n,) and back.dtype == torch.float32
    assert float(np.max(np.abs(back.numpy() - x))) < RT_TOL


def test_irfft_parity_vs_numpy():
    n = 1024
    spec = np.fft.rfft(real_input(n, seed=5).astype(np.float64))
    ref = np.fft.irfft(spec, n=n)
    assert rel_err(irfft(spec.astype(np.complex64), device="cpu"),
                   ref) < RT_TOL


def test_rfft_refuses_complex_input():
    with pytest.raises(ValueError, match="real"):
        rfft(np.zeros(8, np.complex64), device="cpu")
    with pytest.raises(ValueError, match="real"):
        rfft(torch.zeros(8, dtype=torch.complex64))


def test_pack_merge_building_blocks():
    """The O(n) passes alone: pack deinterleaves; merge of an exact
    packed FFT gives numpy.fft.rfft."""
    n = 256
    x = real_input(n, seed=6)
    zr, zi = pack_real_planes(torch.from_numpy(x))
    assert zr.is_contiguous() and zi.is_contiguous()
    assert np.array_equal(zr.numpy(), x[0::2])
    assert np.array_equal(zi.numpy(), x[1::2])
    z = np.fft.fft(x[0::2].astype(np.float64)
                   + 1j * x[1::2].astype(np.float64))
    yr, yi = hermitian_merge(torch.from_numpy(z.real.astype(np.float32)),
                             torch.from_numpy(z.imag.astype(np.float32)), n)
    got = yr.numpy() + 1j * yi.numpy()
    assert rel_err(got, np.fft.rfft(x.astype(np.float64))) < 1e-6


@pytest.mark.parametrize("n", [8, 1024, 4097])
def test_half_twiddles_match_the_reference(n):
    # the float64 table cast once is bit for bit the reference's table
    c, s = half_twiddles_host(n)
    assert c.dtype == np.float64 and c.shape == (n // 2 + 1,)
    rc, rs = ref_real._half_twiddles(n)
    assert np.array_equal(c.astype(np.float32), np.asarray(rc))
    assert np.array_equal(s.astype(np.float32), np.asarray(rs))
    tc, ts = _half_twiddles(n, torch.device("cpu"))
    assert np.array_equal(tc.numpy(), np.asarray(rc))
    assert np.array_equal(ts.numpy(), np.asarray(rs))


# --- the ladder, wrapped ------------------------------------------------


@pytest.mark.parametrize("n,variant", [(1 << 18, "rql"),
                                       (1 << 22, "fourstep")])
def test_rfft_rides_the_large_n_ladder(n, variant):
    """r2c at 2^18 rides rql (c2c at 2^17: long_range_sep + tile_fft)
    and at 2^22 fourstep (c2c at 2^21), on the plain versions."""
    plan = plans.plan_for((n,), domain="r2c", device="cpu")
    assert plan.variant == variant
    assert plan.params == ladder.static_default(
        plans.make_key(n // 2, device="cpu"))[1]
    x = real_input(n, seed=7)
    yr, yi = rfft_planes_fast(x, device="cpu")
    ref = np.fft.rfft(x.astype(np.float64))
    assert rel_err(yr.numpy() + 1j * yi.numpy(), ref) < TOL
    back = irfft_planes_fast(yr, yi)
    assert rel_err(back, x.astype(np.float64)) < RT_TOL


def test_rfft_matches_the_reference():
    # the same seeded input through the reference's CPU path (its rows
    # plan at n/2 = 512, interpret mode)
    x = real_input(1024, seed=8, batch=(2,))
    ref_r, ref_i = ref_real.rfft_planes_fast(x)
    ref = np.asarray(ref_r) + 1j * np.asarray(ref_i)
    yr, yi = rfft_planes_fast(x, device="cpu")
    got = yr.numpy() + 1j * yi.numpy()
    exact = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert rel_err(got, exact) < TOL and rel_err(ref, exact) < TOL
    assert rel_err(got, ref) < TOL
    back = irfft_planes_fast(yr, yi).numpy()
    ref_back = np.asarray(ref_real.irfft_planes_fast(ref_r, ref_i))
    assert rel_err(back, ref_back) < RT_TOL
    assert rel_err(back, x.astype(np.float64)) < RT_TOL


# --- plan-key domains ----------------------------------------------------


def test_plan_key_domain_token_round_trip():
    for key in (plans.make_key(1024, domain="r2c",
                               device_kind="NVIDIA H100"),
                plans.make_key(4096, (8,), domain="c2r",
                               device_kind="NVIDIA H100"),
                plans.make_key(999, domain="r2c", device="cpu"),
                plans.make_key(512, device="cpu")):
        assert PlanKey.from_token(key.token()) == key
    assert plans.make_key(512, device="cpu").domain == "c2c"


def test_plan_key_real_domain_refusals():
    # the reference's plans/core.py:198-205: a real domain takes natural
    # layout only and n >= 2 (the parent port accepted both)
    with pytest.raises(ValueError, match="domain"):
        plans.make_key(512, domain="half", device="cpu")
    with pytest.raises(ValueError, match="natural"):
        plans.make_key(512, layout="pi", domain="r2c", device="cpu")
    with pytest.raises(ValueError, match="natural"):
        PlanKey(device_kind="cpu", n=512, layout="pi", domain="c2r")
    with pytest.raises(ValueError, match="n >= 2"):
        plans.make_key(1, domain="r2c", device="cpu")
    with pytest.raises(ValueError, match="n >= 2"):
        plans.make_key(1, domain="c2r", device="cpu")
    assert plans.make_key(9, domain="r2c", device="cpu").n == 9
    assert plans.make_key(1, device="cpu").n == 1


def test_plan_key_io_shapes():
    # the parent port gave a c2r key the signal's shape; its executor
    # takes the half-spectrum
    k = plans.make_key(1024, (4,), domain="r2c", device="cpu")
    assert k.input_shape() == (4, 1024) and k.output_width() == 513
    k = plans.make_key(1024, domain="c2r", device="cpu")
    assert k.input_shape() == (513,) and k.output_width() == 1024
    k = plans.make_key(999, domain="c2r", device="cpu")
    assert k.input_shape() == (500,) and k.output_width() == 999
    k = plans.make_key(1024, device="cpu")
    assert k.input_shape() == (1024,) and k.output_width() == 1024


@pytest.mark.parametrize("n,batch,layout,domain", [
    (1024, (), "natural", "r2c"), (1024, (4,), "natural", "c2r"),
    (999, (), "natural", "r2c"), (999, (2,), "natural", "c2r"),
    (2, (), "natural", "c2r"), (1000, (), "natural", "c2c"),
    (1024, (), "pi", "r2c"), (1, (), "natural", "r2c"),
    (1, (), "natural", "c2c"), (1000, (), "pi", "c2c")])
def test_plan_key_matches_the_reference(n, batch, layout, domain):
    # the same validation, token fields and io shapes as the reference
    def make(cls):
        return cls(device_kind="NVIDIA H100", n=n, batch=batch,
                   layout=layout, domain=domain)
    try:
        ref = make(RefPlanKey)
    except ValueError:
        with pytest.raises(ValueError):
            make(PlanKey)
        return
    key = make(PlanKey)
    assert key.input_shape() == ref.input_shape()
    assert key.output_width() == ref.output_width()
    tok, ref_tok = json.loads(key.token()), json.loads(ref.token())
    for field in ("n", "batch", "layout", "dtype", "precision", "domain"):
        assert tok[field] == ref_tok[field]


def test_r2c_plan_rides_cached_c2c_winner():
    """A c2c winner at n/2 serves the r2c key at n: same variant and
    params, no race, ms not carried, memoized under its own domain
    token — as in the reference."""
    inner = plans.make_key(2048, device="cpu")
    plan_cache.memoize(Plan(key=inner, variant="rql",
                            params={"tile": 256, "cb": None},
                            source="tuned", ms=0.1))
    key = plans.make_key(4096, domain="r2c", device="cpu")
    plan = plans.get_plan(key, "cpu")
    assert (plan.variant, plan.params, plan.source, plan.ms) == \
        ("rql", {"tile": 256, "cb": None}, "tuned", None)
    assert plan_cache.lookup(key) is plan
    # the reference, the same way
    kind = ref_plans.current_device_kind()
    ref_cache.memoize(RefPlan(key=ref_plans.make_key(2048, device_kind=kind),
                              variant="rql", params={"tile": 256},
                              source="tuned", ms=0.1))
    rp = ref_plans.get_plan(ref_plans.make_key(4096, domain="r2c",
                                               device_kind=kind))
    assert (rp.variant, rp.source, rp.ms) == ("rql", "tuned", None)
    # and the executor serves it
    x = real_input(4096, seed=9)
    yr, yi = plan.execute(x, x)
    assert rel_err(yr.numpy() + 1j * yi.numpy(),
                   np.fft.rfft(x.astype(np.float64))) < TOL


def test_r2c_static_default_and_execute():
    plan = plans.plan_for((1024,), domain="r2c", device="cpu")
    assert (plan.source, plan.variant) == ("static", "rows")
    x = real_input(1024, seed=9)
    yr, yi = plan.execute(x, np.zeros_like(x))
    assert yr.shape == (513,)
    assert rel_err(yr.numpy() + 1j * yi.numpy(),
                   np.fft.rfft(x.astype(np.float64))) < TOL


def test_execute_inverse_refused_on_real_domains():
    z = np.zeros(513, np.float32)
    plan = plans.plan_for((1024,), domain="r2c", device="cpu")
    with pytest.raises(ValueError, match="directional"):
        plan.execute_inverse(z, z)
    ref = ref_plans.plan_for((1024,), layout="natural", domain="r2c")
    with pytest.raises(ValueError, match="directional"):
        ref.execute_inverse(z, z)


def test_r2c_candidates_mirror_half_length_c2c():
    key = PlanKey(device_kind="NVIDIA H100", n=1 << 21, domain="r2c")
    sub = ladder.c2c_subkey(key)
    assert (sub.n, sub.domain, sub.layout) == (1 << 20, "c2c", "natural")
    assert ladder.candidates(key) == ladder.candidates(sub)
    assert ladder.static_default(key) == ladder.static_default(sub)
    # odd n races the any-length entries directly
    odd = PlanKey(device_kind="NVIDIA H100", n=999, domain="c2r")
    assert ladder.candidates(odd) == [("bluestein", {"pad": 2048})]


@pytest.mark.parametrize("shape", [(8, 1024), (1 << 16,)])
def test_gpu_backend_serves_even_real_keys(shape):
    # the reference's hw/lowering.py:242-311: the half-length c2c subkey
    r2c = plans.plan_for(shape, domain="r2c", device="cpu", backend="gpu")
    sub = plans.plan_for(shape[:-1] + (shape[-1] // 2,), device="cpu",
                         backend="gpu")
    assert (r2c.variant, r2c.params) == (sub.variant, sub.params)
    x = real_input(shape[-1], seed=10, batch=shape[:-1])
    yr, yi = rfft_planes_fast(x, plan=r2c, device="cpu")
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert rel_err(yr.numpy() + 1j * yi.numpy(), ref) < TOL
    c2r = plans.plan_for(shape, domain="c2r", device="cpu", backend="gpu")
    back = irfft_planes_fast(yr, yi, plan=c2r)
    assert rel_err(back, x.astype(np.float64)) < RT_TOL


def test_tune_r2c_races_the_half_length_ladder():
    # the race of an r2c key: the c2c subkey's entries, each built as
    # the real path, the winner stored under the r2c token
    key = PlanKey(device_kind="NVIDIA H100", n=1 << 21, domain="r2c")
    seen = []

    def timer(fn, k):
        seen.append(k)
        return 1.0 + len(seen)

    plan = plans.tune(key, timer=timer, allow_offline=True, persist=False,
                      verbose=False)
    sub = ladder.candidates(ladder.c2c_subkey(key))
    assert [(r.variant, r.params) for r in plan.tuning] == sub
    assert (plan.key, plan.source) == (key, "tuned")
    assert (plan.variant, plan.params) == sub[0]
    assert all(k == key for k in seen)
    assert plan_cache.lookup(key) is plan


def test_default_timer_takes_the_half_spectrum():
    # a c2r key's executor is timed on half-spectrum planes
    from cs87project_msolano2_tpu_torch.plans.autotune import default_timer

    key = plans.make_key(256, domain="c2r", device="cpu")
    shapes = set()

    def fn(xr, xi):
        shapes.add((tuple(xr.shape), tuple(xi.shape)))
        return xr, xi

    assert default_timer(fn, key, device="cpu") > 0
    assert shapes == {((129,), (129,))}


# --- roofline and CLI ----------------------------------------------------


@pytest.mark.parametrize("n,passes,domain,sb,pad", [
    (1 << 20, 0, "c2c", 4, None), (1 << 20, 1, "r2c", 4, None),
    (999, 2, "c2c", 4, 2048), (999, 0, "c2c", 4, 2048),
    (1000, 2, "r2c", 2, 1536), (1048573, 1, "c2c", 4, 1 << 21)])
def test_fft_hbm_bytes_matches_the_reference(n, passes, domain, sb, pad):
    got = roofline.fft_hbm_bytes(n, passes, domain, sb, pad_n=pad)
    assert got == ref_roofline.fft_hbm_bytes(n, passes, domain, sb,
                                             pad_n=pad)
    # carries at the pad, the floor at n
    assert got == roofline.fft_min_hbm_bytes(n, domain, sb) \
        + passes * roofline.fft_min_hbm_bytes(pad or n, domain, sb)


def test_cli_plan_warm_domain_validation(capsys):
    for main in (cli_main, ref_cli_main):
        # pi layout + r2c is a key-validation error, reported not raised
        assert main(["plan", "warm", "-n", "2^10", "--domain", "r2c"]) == 2
        assert "natural" in capsys.readouterr().err
        # a valid key still refuses offline tuning (exit 2, like c2c)
        assert main(["plan", "warm", "-n", "2^10", "--layout", "natural",
                     "--domain", "r2c"]) == 2
        assert "offline" in capsys.readouterr().err
