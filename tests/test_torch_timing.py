"""The port's loop-slope timer (``utils/timing.py``) and the race's
``default_timer`` on the CPU: the slope arithmetic and the window
widening with an injected clock, the reference's (k1, k2) windows by
input size, the cold-L2 rotation, the restore of planes an executor
writes over, and a race with an injected timer.  The card's side (the
CUDA-graph runs, and a wrapper's host time staying out of the slope) is
in ``test_torch_cuda.py``."""

import time

import pytest
import torch

import cs87project_msolano2_tpu.utils.timing as ref_timing
from cs87project_msolano2_tpu.plans import autotune as ref_autotune
from cs87project_msolano2_tpu.plans import make_key as ref_make_key
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.plans import autotune, ladder
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.utils import timing


def linear_clock(a, b, calls=None):
    """measure(k) = a + b k, recording each k asked for."""
    def measure(k):
        if calls is not None:
            calls.append(k)
        return a + b * k

    return measure


@pytest.mark.parametrize("a,b,k1,k2", [(3.0, 0.25, 64, 1024),
                                       (120.0, 1.5, 16, 256),
                                       (0.0, 0.125, 1, 4)])
def test_slope_of_a_linear_clock_is_its_rate(a, b, k1, k2):
    # T(k) = a + b k: the fixed cost a cancels and the slope is b exactly
    assert timing.slope_from(linear_clock(a, b), k1, k2,
                             min_delta_ms=0.0) == b


def test_slope_widens_the_window_below_the_floor():
    calls = []
    # delta at (64, 1024) is 0.96 ms, under the 2 ms floor: k2 quadruples
    # once, and T(64) is measured again beside T(4096)
    got = timing.slope_from(linear_clock(1.0, 0.001, calls), 64, 1024,
                            min_delta_ms=2.0)
    assert calls == [64, 1024, 64, 4096]
    assert got == pytest.approx(0.001, rel=1e-12)


def test_slope_unresolved_past_the_widest_window():
    with pytest.raises(timing.SlopeUnresolved, match="below the floor"):
        timing.slope_from(linear_clock(5.0, 0.0), 16, 256, min_delta_ms=1.0,
                          max_k=1024)


@pytest.mark.parametrize("elements,want", [
    (1 << 20, (64, 1024)), ((1 << 22) - 1, (64, 1024)),
    (1 << 22, (16, 256)), (1 << 27, (16, 256))])
def test_slope_window_by_size(elements, want):
    assert timing.slope_window(elements) == want


@pytest.mark.parametrize("n", [1 << 20, 1 << 22])
def test_windows_match_the_reference_default_timer(monkeypatch, n):
    # the reference's race timer picks its (k1, k2) by the input's size
    seen = {}

    def ref_slope(body, args, k1, k2, **kw):
        seen["ref"] = (k1, k2)
        return 1.0

    def port_slope(fn, arg_sets, k1, k2, **kw):
        seen["port"] = (k1, k2)
        return 1.0

    monkeypatch.setattr(ref_timing, "loop_slope_ms", ref_slope)
    monkeypatch.setattr(timing, "loop_slope_ms", port_slope)
    ref_autotune.default_timer(lambda xr, xi: (xr, xi),
                               ref_make_key(n, layout="pi",
                                            device_kind="cpu"))
    autotune.default_timer(lambda xr, xi: (xr, xi),
                           plans.make_key(n, layout="pi", device="cpu"),
                           device="cpu")
    assert seen["port"] == seen["ref"] == timing.slope_window(n)


@pytest.mark.parametrize("plane_bytes,l2,want", [
    (8 << 20, 50 << 20, 8),     # n = 2^20: 8 copies, 64 MB
    (32 << 20, 50 << 20, 3),    # n = 2^22
    (64 << 20, 50 << 20, 2),    # n = 2^23
    (128 << 20, 50 << 20, 1),   # n = 2^24: one call moves 256 MB
    (1 << 30, 50 << 20, 1),     # n = 2^27
    (8 << 20, None, 1)])        # no card
def test_rotation_copies(plane_bytes, l2, want):
    got = timing.rotation_copies(plane_bytes, l2)
    assert got == want
    if got > 1:
        # between two uses of one copy the others move at least the L2
        assert (got - 1) * 2 * plane_bytes >= l2


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_host_slope_times_k_calls_and_restores_before_each_run(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    seen, restores = [], []
    x = torch.zeros(4)

    def fn(a, b):
        seen.append(float(a[0]))
        a.add_(1.0)
        clock.now += 0.5e-3  # 0.5 ms of host time per call

    def before():
        restores.append(len(seen))
        x.zero_()

    got = timing.loop_slope_ms(fn, [(x, x)], 4, 12, reps=2,
                               min_delta_ms=1.0, before=before)
    assert got == pytest.approx(0.5, rel=1e-9)
    # every run starts from restored planes: its first call sees zeros
    assert restores == [0, 4, 8, 20]
    assert [seen[i] for i in restores] == [0.0] * 4
    assert len(seen) == 2 * (4 + 12)


def test_host_slope_rotates_over_its_arg_sets(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    used = []

    def fn(a, b):
        used.append(int(a[0]))
        clock.now += 1e-3

    sets = [(torch.full((2,), float(i)), None) for i in range(3)]
    assert timing.loop_slope_ms(fn, sets, 2, 8, reps=1,
                                min_delta_ms=1.0) == pytest.approx(1.0)
    assert used == [0, 1] + [0, 1, 2, 0, 1, 2, 0, 1]


def test_default_timer_restores_planes_an_executor_consumes(monkeypatch):
    firsts = []

    def consume(xr, xi):
        firsts.append(xr.clone())
        xr.mul_(2.0)
        return xr, xi

    consume.consumes_input = True
    captured = {}

    def fake_slope(fn, arg_sets, k1, k2, before=None, **kw):
        captured.update(k=(k1, k2), copies=len(arg_sets))
        for _ in range(2):
            before()
            fn(*arg_sets[0])
        return 0.25

    monkeypatch.setattr(timing, "loop_slope_ms", fake_slope)
    key = plans.make_key(1 << 10, layout="pi", device="cpu")
    assert autotune.default_timer(consume, key, device="cpu") == 0.25
    assert captured == {"k": (64, 1024), "copies": 1}
    assert torch.equal(firsts[0], firsts[1])


def test_race_with_an_injected_timer_never_reaches_default_timer(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the injected timer was bypassed")

    monkeypatch.setattr(autotune, "default_timer", refuse)
    plan_cache.clear(memory=True, disk=False)
    key = plans.make_key(1 << 20, layout="pi", device="cpu")
    cands = ladder.candidates(key)
    # each entry's canned time: the last rql entry is the fastest
    times = {i: 1.0 + i for i in range(len(cands))}
    fastest = max(i for i, (v, _) in enumerate(cands) if v == "rql")
    times[fastest] = 0.5
    order = iter(range(len(cands)))
    plan = plans.tune(key, timer=lambda fn, key: times[next(order)],
                      verbose=False, allow_offline=True, persist=False)
    plan_cache.clear(memory=True, disk=False)
    assert (plan.variant, plan.params) == cands[fastest]
    assert plan.ms == 0.5 and plan.source == "tuned"
    assert [r.status for r in plan.tuning].count("won") == 1
    assert len(plan.tuning) == len(cands)


def test_time_ms_is_unchanged_on_the_host():
    ms, out = timing.time_ms(lambda: time.sleep(0.001) or 7, reps=3,
                             warmup=1)
    assert out == 7 and ms >= 1.0


@pytest.mark.parametrize("elements,want", [
    (1 << 20, (64, 1024)), (1 << 24, (16, 256)), ((1 << 24) + 1, (8, 128)),
    (1 << 25, (8, 128)), (1 << 26, (4, 64)), (1 << 27, (2, 32))])
def test_race_window_by_size(elements, want):
    # the reference's windows up to 2^24 elements, halved per doubling
    # past it; one window per key, whatever the candidate
    assert timing.race_window(elements) == want


@pytest.mark.parametrize("plane_bytes,window,want", [
    (8 << 20, (64, 1024), 8), (8 << 20, (1, 4), 4), (8 << 20, (1, 2), 2),
    (1 << 30, (2, 32), 1)])
def test_window_copies_are_the_rotation_at_most_k2(plane_bytes, window,
                                                   want):
    assert timing.window_copies(plane_bytes, 50 << 20, window) == want


def test_fitted_slope_ms_fits_the_window_and_restores_the_probe(
        monkeypatch):
    """One timed call (50 ms, injected) fits the window; the probe of an
    fn that writes over its planes runs on copies, so the slope gets the
    caller's planes unchanged."""
    captured = {}

    def fake_time_ms(fn, *args, before=None, **kw):
        before()
        fn(*args)
        return 50.0, None

    def fake_slope(fn, arg_sets, k1, k2, reps, before):
        captured.update(window=(k1, k2), copies=len(arg_sets),
                        first=arg_sets[0][0].clone())
        return 0.5

    monkeypatch.setattr(timing, "time_ms", fake_time_ms)
    monkeypatch.setattr(timing, "loop_slope_ms", fake_slope)
    x = torch.ones(1 << 10)

    def consume(a):
        a.mul_(2.0)
        return a

    assert timing.fitted_slope_ms(consume, x, consumes=True) == 0.5
    # k2: FITTED_RUN_MS (100 ms) over the 50 ms call
    assert captured["window"] == timing.fitted_window(50.0, 1 << 10) \
        == (1, 2)
    assert captured["copies"] == 1  # no L2 on the CPU
    assert torch.equal(x, torch.ones(1 << 10))
    assert torch.equal(captured["first"], x)
