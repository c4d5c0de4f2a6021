"""The port's resilience layer on the CPU, mirroring the reference's
tests/test_resilience.py for what the port has (the watchdog, tube-plan
resolution and the sharded path come with the parallel configs): the
taxonomy of injected faults, the retry schedule against a mock clock,
fault specs and scoped/env injection, the degradation chain against
numpy under injected faults (sticky, transient re-raised, records, the
disk store untouched), the journal, and parity with the reference:
KNOWN_SITES and KINDS, FaultSpec.parse, the retry schedule,
``_rungs_after`` (jnp-fft as torch-fft), ``error_budget`` and
``promote_precision``.  What the port must never demote — a kernel that
did not build, a sticky CUDA error — re-raises."""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import plans as ref_plans
from cs87project_msolano2_tpu.ops import precision as ref_precision
from cs87project_msolano2_tpu.resilience import degrade as ref_degrade
from cs87project_msolano2_tpu.resilience import journal as ref_journal
from cs87project_msolano2_tpu.resilience import retry as ref_retry
from cs87project_msolano2_tpu.resilience import taxonomy as ref_taxonomy
from cs87project_msolano2_tpu_torch import obs, plans
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.ops import precision
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.resilience import (
    DEGRADE_CHAIN,
    KINDS,
    KNOWN_SITES,
    CapacityError,
    CollectiveTimeout,
    FaultKind,
    FaultSpec,
    HostDesyncError,
    InjectedFault,
    Journal,
    KernelBuildError,
    LoweringError,
    RetryPolicy,
    TransientBackendError,
    call_with_retry,
    classify,
    inject,
    maybe_fault,
    promote_precision,
    with_retry,
)
from cs87project_msolano2_tpu_torch.resilience import degrade
from cs87project_msolano2_tpu_torch.resilience import retry as port_retry

# the module, not the package's ``inject`` context manager of that name
ref_inject = importlib.import_module(
    "cs87project_msolano2_tpu.resilience.inject")

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_plan_memory():
    """Demotions live on memoized plans: each test starts with empty
    in-process plan caches (both packages') and, with the port's obs
    armed around it, an empty ``pifft_demotions_total``."""
    plans.cache.clear(memory=True)
    ref_plans.cache.clear(memory=True)
    obs.enable()
    yield
    obs.disable()
    obs.metrics.reset()
    plans.cache.clear(memory=True)
    ref_plans.cache.clear(memory=True)


def demotions() -> dict:
    """The port's ``pifft_demotions_total`` by rung ({to: count})."""
    prefix = 'pifft_demotions_total{to="'
    return {k[len(prefix):-2]: int(v)
            for k, v in obs.metrics.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _planes(n, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    shape = (*batch, n)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _reference(xr, xi, layout="pi"):
    y = np.fft.fft(xr.astype(np.complex128) + 1j * xi.astype(np.complex128))
    return y[..., bit_reverse_indices(xr.shape[-1])] if layout == "pi" else y


def _rel_err(yr, yi, ref):
    got = np.asarray(yr) + 1j * np.asarray(yi)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _pi_plan(n, **kw):
    return plans.get_plan(plans.make_key(n, layout="pi", device=CPU, **kw),
                          CPU)


# ------------------------------------------------------------- taxonomy


def test_classify_own_types_carry_their_kind():
    assert classify(TransientBackendError("x")) is FaultKind.TRANSIENT
    assert classify(CapacityError("x")) is FaultKind.CAPACITY
    assert classify(LoweringError("x")) is FaultKind.PERMANENT
    assert classify(CollectiveTimeout("x")) is FaultKind.TRANSIENT
    assert classify(HostDesyncError("x")) is FaultKind.PERMANENT
    assert classify(KernelBuildError("nvcc failed")) is FaultKind.PERMANENT
    assert isinstance(KernelBuildError("x"), RuntimeError)


@pytest.mark.parametrize("kind,want", [
    ("transient", FaultKind.TRANSIENT), ("capacity", FaultKind.CAPACITY),
    ("permanent", FaultKind.PERMANENT), ("timeout", FaultKind.TRANSIENT)])
def test_injected_faults_classify_as_the_reference_s(kind, want):
    """An injected fault carries a CUDA signature the port's tables
    classify as the reference's own injected fault is classified."""
    with inject("tube", kind), pytest.raises(Exception) as ei:
        maybe_fault("tube")
    with ref_inject.inject("tube", kind), pytest.raises(Exception) as ri:
        ref_inject.maybe_fault("tube")
    assert classify(ei.value) is want
    assert ref_taxonomy.classify(ri.value).value == want.value


# ---------------------------------------------------------------- retry


def _schedule(mod, policy_kw, fails, exc_type):
    """(calls, sleeps, result) of call_with_retry under a mock clock, a
    callable failing `fails` times with `exc_type` first."""
    sleeps, calls = [], [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= fails:
            raise exc_type("blip")
        return "ok"

    u = iter([0.0, 0.5, 0.9, 0.3, 0.7])
    try:
        out = mod.call_with_retry(flaky, policy=mod.RetryPolicy(**policy_kw),
                                  sleep=sleeps.append, rng=lambda: next(u),
                                  on_retry=lambda *a: None)
    except exc_type:
        out = "raised"
    return calls[0], sleeps, out


@pytest.mark.parametrize("policy_kw,fails", [
    ({"base_s": 1.0, "factor": 2.0, "jitter": 0.0}, 10),
    ({"base_s": 30.0}, 2),
    ({"base_s": 10.0, "jitter": 0.25, "max_backoff_s": 15.0}, 10),
    ({"base_s": 0.05, "max_backoff_s": 1.0}, 3)])
def test_retry_schedule_matches_the_reference(policy_kw, fails):
    port = _schedule(port_retry, policy_kw, fails, TransientBackendError)
    ref = _schedule(ref_retry, policy_kw, fails,
                    ref_taxonomy.TransientBackendError)
    assert port == ref


def test_retry_backoff_schedule_mock_clock():
    sleeps = []
    calls = [0]

    def always_transient():
        calls[0] += 1
        raise TransientBackendError("blip")

    policy = RetryPolicy(base_s=1.0, factor=2.0, jitter=0.0)
    with pytest.raises(TransientBackendError):
        call_with_retry(always_transient, policy=policy,
                        sleep=sleeps.append, rng=lambda: 0.0,
                        on_retry=lambda *a: None)
    assert calls[0] == 4
    assert sleeps == [1.0, 2.0, 4.0]


def test_retry_jitter_and_cap():
    policy = RetryPolicy(base_s=10.0, factor=2.0, jitter=0.25,
                         max_backoff_s=15.0)
    assert policy.backoff_s(1, 1.0) == pytest.approx(12.5)
    assert policy.backoff_s(2, 1.0) == pytest.approx(15.0)
    ref = ref_retry.RetryPolicy(base_s=10.0, factor=2.0, jitter=0.25,
                                max_backoff_s=15.0)
    for i in range(1, 6):
        for u in (0.0, 0.3, 0.99):
            assert policy.backoff_s(i, u) == ref.backoff_s(i, u)


def test_retry_recovers_midway_and_calls_hook():
    hook_calls = []
    state = [0]

    def flaky():
        state[0] += 1
        if state[0] < 3:
            raise ConnectionError("reset")
        return "ok"

    out = call_with_retry(
        flaky, policy=RetryPolicy(base_s=0.0, jitter=0.0),
        sleep=lambda s: None,
        on_retry=lambda exc, attempt, pause: hook_calls.append(
            (type(exc).__name__, attempt)))
    assert out == "ok"
    assert hook_calls == [("ConnectionError", 1), ("ConnectionError", 2)]


def test_retry_capacity_permanent_and_valueerror_fail_fast():
    for exc in (CapacityError("oom"), LoweringError("nvcc"),
                ValueError("infeasible cell"),
                RuntimeError("CUDA error: out of memory")):
        calls = [0]

        def once(exc=exc):
            calls[0] += 1
            raise exc

        with pytest.raises(type(exc)):
            call_with_retry(once, sleep=lambda s: pytest.fail(
                "must not sleep on a non-retryable fault"))
        assert calls[0] == 1


def test_with_retry_decorator():
    state = [0]

    @with_retry(policy=RetryPolicy(base_s=0.0, jitter=0.0),
                sleep=lambda s: None)
    def flaky(x):
        state[0] += 1
        if state[0] < 2:
            raise TransientBackendError("blip")
        return x * 2

    assert flaky(21) == 42


# ---------------------------------------------------------------- inject


def test_known_sites_and_kinds_match_the_reference():
    assert set(KNOWN_SITES) == set(ref_inject.KNOWN_SITES)
    assert KINDS == ref_inject.KINDS
    assert degrade.DEGRADE_CHAIN == tuple(
        "torch-fft" if r == "jnp-fft" else r
        for r in ref_degrade.DEGRADE_CHAIN)


@pytest.mark.parametrize("text", [
    "tube:capacity", "bench:transient:0.5:3", "collective:stall=2.0:1.0:1",
    "*:permanent::2", "plan:TIMEOUT", "tube", "tube:nosuchkind",
    ":capacity", "a:b:c:d:e", "x:stall=0", "x:stall=abc",
    "harness:transient:0.25"])
def test_fault_spec_parse_matches_the_reference(text):
    def parsed(cls):
        try:
            return dataclasses.astuple(cls.parse(text))
        except ValueError:
            return "ValueError"

    assert parsed(FaultSpec) == parsed(ref_inject.FaultSpec)


def test_fault_spec_parse_forms():
    s = FaultSpec.parse("tube:capacity")
    assert (s.site, s.kind, s.prob, s.count) == ("tube", "capacity", 1.0,
                                                 None)
    s = FaultSpec.parse("bench:transient:0.5:3")
    assert (s.prob, s.count) == (0.5, 3)
    for bad in ("tube", "tube:nosuchkind", ":capacity", "a:b:c:d:e"):
        with pytest.raises(ValueError):
            FaultSpec.parse(bad)


def test_inject_count_cap_and_site_glob():
    with inject("tu*", "permanent", count=2) as spec:
        for _ in range(2):
            with pytest.raises(InjectedFault):
                maybe_fault("tube")
        maybe_fault("tube")  # cap reached: no longer fires
        maybe_fault("plan")  # another site: never matched
        assert spec.fired == 2


def test_inject_env_armed(monkeypatch):
    monkeypatch.setenv("PIFFT_FAULT", "plan:timeout:1.0:1")
    with pytest.raises(CollectiveTimeout):
        maybe_fault("plan")
    maybe_fault("plan")  # count exhausted
    monkeypatch.setenv("PIFFT_FAULT", "plan:notakind")
    with pytest.raises(ValueError):
        maybe_fault("plan")
    # a mistyped spec keeps failing: never the stale spec list
    with pytest.raises(ValueError):
        maybe_fault("plan")


def test_inject_prob_zero_never_fires():
    with inject("tube", "capacity", prob=0.0) as spec:
        for _ in range(20):
            maybe_fault("tube")
        assert spec.fired == 0


# ----------------------------------------------------- degradation chain


def test_degradation_chain_full_parity_vs_numpy(capsys):
    """Every kernel entry dies of CAPACITY: rows -> rql -> torch-fft, the
    answer stays right, one demotion is recorded and announced."""
    n = 1 << 10
    xr, xi = _planes(n)
    with inject("tube", "capacity") as spec:
        plan = _pi_plan(n)
        yr, yi = plan.execute(xr, xi)
    assert spec.fired >= 2  # the plan's kernel and the rql rung died
    assert _rel_err(yr, yi, _reference(xr, xi)) < 1e-5
    assert plan.degraded
    assert [d["to"] for d in plan.demotions] == ["torch-fft"]
    (rec,) = plan.demotions
    assert rec["from"] == plan.variant and rec["kind"] == "capacity"
    assert any(s.startswith("rql:") for s in rec["skipped"])
    assert "DEGRADED" in capsys.readouterr().err
    d = plan.describe()
    assert d["degraded"] is True and d["demoted_to"] == "torch-fft"
    assert demotions() == {"torch-fft": 1}
    assert plan.storage_bytes() == 4


@pytest.mark.parametrize("layout", ["pi", "natural"])
@pytest.mark.parametrize("count,to", [(None, "torch-fft"), (1, "rql")])
def test_chain_output_after_a_tube_fault_at_2_14(layout, count, to):
    n = 1 << 14
    xr, xi = _planes(n, seed=3)
    plan = plans.get_plan(plans.make_key(n, layout=layout, device=CPU), CPU)
    with inject("tube", "capacity", count=count):
        yr, yi = plan.execute(xr, xi)
    assert plan.demotions[-1]["to"] == to
    assert _rel_err(yr, yi, _reference(xr, xi, layout)) < 1e-5


def test_degradation_is_sticky_across_calls():
    """Once a rung serves, later calls start there: the dead kernel is
    not tried again and the trail does not grow."""
    n = 1 << 9
    xr, xi = _planes(n, seed=7)
    with inject("tube", "capacity") as spec:
        plan = _pi_plan(n)
        plan.execute(xr, xi)
        fired_after_first = spec.fired
        yr, yi = plan.execute(xr, xi)
        assert spec.fired == fired_after_first
    assert len(plan.demotions) == 1
    assert _rel_err(yr, yi, _reference(xr, xi)) < 1e-5


def test_degradation_permanent_fault_also_demotes():
    n = 1 << 9
    xr, xi = _planes(n, seed=1)
    with inject("tube", "permanent"):
        plan = _pi_plan(n)
        yr, yi = plan.execute(xr, xi)
    assert plan.degraded
    assert _rel_err(yr, yi, _reference(xr, xi)) < 1e-5


def test_healthy_wrapper_serves_the_kernel_path_unchanged():
    """With no fault the wrapper returns the executor's own result, bit
    for bit, and keeps its consumes_input flag (the counterpart of the
    reference's jit-trace test: the wrapper must stay capturable)."""
    n = 1 << 12
    xr, xi = (torch.from_numpy(a) for a in _planes(n, seed=2))
    plan = _pi_plan(n)
    raw = ladder.build_executor(plan.key, plan.variant, plan.params)
    got, want = plan.fn(xr, xi), raw(xr, xi)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not plan.degraded
    key = plans.make_key(1 << 20, layout="pi", device=CPU)
    alias = plans.Plan(key, "fused-alias", {"tile": 1 << 14, "qb": 1})
    assert alias.fn.consumes_input


def test_transient_fault_is_not_degraded():
    n = 1 << 9
    with inject("tube", "transient"):
        plan = _pi_plan(n)
        with pytest.raises(InjectedFault):
            plan.execute(*_planes(n))
    assert not plan.degraded and not demotions()


def test_kernel_build_error_is_not_demoted():
    """A kernel that did not build re-raises: a library rung must not
    hide it."""
    plan = _pi_plan(1 << 12)

    def broken(xr, xi):
        raise KernelBuildError("nvcc failed (exit 1) on tile_fft.cu")

    plan._fn = degrade.resilient_executor(plan, broken)
    with pytest.raises(KernelBuildError):
        plan.execute(*_planes(1 << 12))
    assert not plan.degraded and not demotions()


def test_sticky_cuda_error_is_not_demoted():
    """A poisoned context re-raises, from the plan's executor or from a
    rung on the way down."""
    illegal = RuntimeError(
        "tile_fft launch failed: CUDA error 700 cudaErrorIllegalAddress "
        "(an illegal memory access was encountered)")

    def faulting(xr, xi):
        raise illegal

    plan = _pi_plan(1 << 12)
    plan._fn = degrade.resilient_executor(plan, faulting)
    with pytest.raises(RuntimeError, match="IllegalAddress"):
        plan.execute(*_planes(1 << 12))
    assert not plan.degraded

    def capacity(xr, xi):
        raise CapacityError("out of memory")

    plan2 = _pi_plan(1 << 13)
    plan2._fn = degrade.resilient_executor(plan2, capacity)
    real_build = degrade.build_rung
    try:
        degrade.build_rung = lambda key, rung: faulting
        with pytest.raises(RuntimeError, match="IllegalAddress"):
            plan2.execute(*_planes(1 << 13))
    finally:
        degrade.build_rung = real_build
    assert not plan2.degraded and not demotions()


@pytest.mark.parametrize("variant,tried", [
    ("sixstep", ["fourstep", "rql"]), ("rows", ["rql"]), ("rql", []),
    ("bluestein", []), ("stages", [])])
def test_card_planes_never_reach_a_library_rung(variant, tried,
                                                monkeypatch):
    """Planes off the CPU (meta tensors stand in for the card's) walk the
    kernel rungs alone: past rql the fault re-raises, and the any-length
    variants re-raise at once, so no library call or host round trip
    serves a card transform.  CPU planes keep the whole chain."""
    seen = []

    def refused(key, rung):
        seen.append(rung)
        raise CapacityError(f"{rung}: out of memory")

    def capacity(xr, xi):
        raise CapacityError("out of memory")

    monkeypatch.setattr(degrade, "build_rung", refused)
    plan = plans.Plan(plans.make_key(1 << 12, layout="pi", device=CPU),
                      variant, {})
    run = degrade.resilient_executor(plan, capacity)
    x = torch.empty(1 << 12, device="meta")
    with pytest.raises(CapacityError):
        run(x, x)
    assert seen == tried and not plan.degraded and not demotions()
    assert degrade.rungs_for(variant, "cuda") == tuple(tried)
    assert degrade.rungs_for(variant, CPU) == degrade._rungs_after(variant)


def test_numpy_ref_rung_parity_batched():
    key = plans.make_key(256, batch=(4,), layout="pi", device=CPU)
    xr, xi = _planes(256, seed=3, batch=(4,))
    yr, yi = degrade.build_rung(key, "numpy-ref")(torch.from_numpy(xr),
                                                  torch.from_numpy(xi))
    assert yr.dtype == torch.float32 and yr.shape == (4, 256)
    assert _rel_err(yr, yi, _reference(xr, xi)) < 1e-5


@pytest.mark.parametrize("domain", ["r2c", "c2r"])
@pytest.mark.parametrize("rung", ["rql", "torch-fft", "numpy-ref"])
def test_real_domain_rungs_vs_numpy(domain, rung):
    n = 1 << 12
    key = plans.make_key(n, domain=domain, device=CPU)
    x, _ = _planes(n, seed=4)
    fn = degrade.build_rung(key, rung)
    if domain == "r2c":
        yr, yi = fn(torch.from_numpy(x), torch.zeros(n))
        ref = np.fft.rfft(x.astype(np.float64))
        assert _rel_err(yr, yi, ref) < 1e-5
    else:
        h = np.fft.rfft(x.astype(np.float64))
        yr, yi = fn(torch.from_numpy(h.real.astype(np.float32)),
                    torch.from_numpy(h.imag.astype(np.float32)))
        assert not torch.any(yi)
        assert np.max(np.abs(yr.numpy() - x)) / np.max(np.abs(x)) < 1e-5


def test_any_length_plan_degrades_at_its_site():
    n = 1000
    xr, xi = _planes(n, seed=5)
    plan = plans.get_plan(plans.make_key(n, device=CPU), CPU)
    with inject("anylen", "capacity") as spec:
        yr, yi = plan.execute(xr, xi)
    assert spec.fired == 1 and plan.demotions[-1]["to"] == "torch-fft"
    assert _rel_err(yr, yi, _reference(xr, xi, "natural")) < 1e-5


def test_fourstep_rung_refuses_past_its_bound():
    """Past fourstep's shared-memory bound the rung refuses before it
    runs, and the walk goes on to rql."""
    key = plans.make_key(1 << 27, layout="pi", device=CPU)
    with pytest.raises(ValueError):
        degrade.build_rung(key, "fourstep")
    for bad in (plans.make_key(1000, device=CPU),
                plans.make_key(256, batch=(4,), layout="pi", device=CPU)):
        with pytest.raises(ValueError):
            degrade.build_rung(bad, "rql")


def test_degraded_plan_record_round_trip():
    key = plans.make_key(512, layout="pi", device=CPU)
    with inject("tube", "capacity"):
        plan = plans.get_plan(key, CPU)
        plan.execute(*_planes(512))
    rec = plan.to_record()
    back = plans.Plan.from_record(key, rec)
    assert back.degraded and \
        [d["to"] for d in back.demotions] == ["torch-fft"]
    assert back.served_variant() == "torch-fft"


def test_demotion_never_touches_the_disk_store(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    with inject("tube", "capacity"):
        plan = plans.get_plan(plans.make_key(512, layout="pi", device=CPU),
                              CPU)
        plan.execute(*_planes(512))
    assert plan.degraded
    plans.cache.store(plan)  # a store of a degraded plan memoizes only
    assert not [p for p in os.listdir(tmp_path) if p.startswith("plans-")]
    assert plans.cache.lookup(plan.key) is plan


@pytest.mark.parametrize("variant", [
    "sixstep", "fourstep", "rql", "two-kernel", "fused", "fused-alias",
    "rows", "mf", "bluestein", "rader", "mixedradix", "gpu-rows",
    "gpu-stages", "torch-fft", "numpy-ref", "stages"])
def test_rungs_after_matches_the_reference(variant):
    """The chain below every variant equals the reference's, jnp-fft as
    torch-fft (the port's stage path as the reference's jnp variant)."""
    ref_variant = {"torch-fft": "jnp-fft", "stages": "jnp"}.get(variant,
                                                               variant)
    want = tuple("torch-fft" if r == "jnp-fft" else r
                 for r in ref_degrade._rungs_after(ref_variant))
    assert degrade._rungs_after(variant) == want


@pytest.mark.parametrize("env", [None, "0", "-1", "nan", "junk", "2e-3",
                                 "inf"])
def test_error_budget_matches_the_reference(env, monkeypatch, capsys):
    if env is None:
        monkeypatch.delenv(precision.BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(precision.BUDGET_ENV, env)
    assert precision.BUDGET_ENV == ref_precision.BUDGET_ENV
    assert precision.PROMOTE_CHAIN == ref_precision.PROMOTE_CHAIN
    for mode in precision.PRECISIONS:
        assert precision.error_budget(mode) == \
            ref_precision.error_budget(mode)
    if env in ("-1", "nan", "junk", "inf"):
        # rejected values are announced once per value, not per call
        precision.error_budget("bf16")
        assert capsys.readouterr().err.count(precision.BUDGET_ENV) <= 2


def test_promote_precision_matches_the_reference():
    """The quality walk bf16 -> default -> split3 -> fp32 -> top gives
    the reference's records on its own Plan."""
    n = 1 << 12
    port = plans.Plan(plans.make_key(n, layout="pi", precision="bf16",
                                     device=CPU), "rows", {})
    ref = ref_plans.Plan(ref_plans.make_key(n, layout="pi",
                                            precision="bf16"), "rows", {})
    for _ in range(4):
        assert promote_precision(port, 0.5, 1e-9) == \
            ref_degrade.promote_precision(ref, 0.5, 1e-9)
    assert port.demotions == ref.demotions
    assert port.params == ref.params == {"precision": "fp32"}
    assert port.degraded and ref.degraded
    assert demotions() == {"precision:default": 1,
                              "precision:split3": 1, "precision:fp32": 1}


def test_promoted_plan_serves_the_tighter_mode():
    n = 1 << 12
    xr, xi = _planes(n, seed=6)
    plan = _pi_plan(n, precision="bf16")
    y16 = plan.execute(xr, xi)
    assert plan.storage_bytes() == 2
    assert promote_precision(plan, 5e-3, 0.0) == "default"
    y = plan.execute(xr, xi)
    ref = _reference(xr, xi)
    assert _rel_err(*y16, ref) > 1e-4 > 1e-6 > _rel_err(*y, ref)
    assert plan.storage_bytes() == 4


# --------------------------------------------------------------- journal


def test_journal_round_trip_and_last_wins(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    j.record("a", {"ms": 1.0})
    j.record("b", {"ms": 2.0})
    j.record("a", {"ms": 3.0})  # re-recorded: the later wins
    j2 = Journal(j.path)
    cells = j2.load()
    assert set(cells) == {"a", "b"}
    assert cells["a"]["ms"] == 3.0
    assert j2.has("a") and not j2.has("c")
    # the same file format: the reference's journal reads it alike
    assert ref_journal.Journal(j.path).load() == cells


def test_journal_tolerates_half_written_tail(tmp_path, capsys):
    j = Journal(str(tmp_path / "j.jsonl"))
    j.record("a", {"ms": 1.0})
    j.record("b", {"ms": 2.0})
    with open(j.path, "a") as fh:
        fh.write('{"cell": "c", "ms": 3.')  # the kill mid-write
    cells = Journal(j.path).load()
    assert set(cells) == {"a", "b"}
    assert "corrupt" in capsys.readouterr().err


def test_journal_guard_config(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    j.guard_config({"n": 4096, "smoke": True}, label="bench")
    Journal(j.path).guard_config({"n": 4096, "smoke": True})
    with pytest.raises(ValueError, match="different bench"):
        Journal(j.path).guard_config({"n": 1 << 20, "smoke": False},
                                     label="bench")
    j.reset()
    assert not os.path.exists(j.path) and not j.has("config")


# ----------------------------------------------------------------- cli


def test_cli_faults_list_and_inject(capsys):
    assert cli_main(["faults", "list"]) == 0
    out = capsys.readouterr().out
    assert all(site in out for site in KNOWN_SITES)
    assert " -> ".join(DEGRADE_CHAIN) in out
    assert cli_main(["faults", "inject", "tube:capacity", "-n", "2^10",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plan DEGRADED" in out and "(OK)" in out
    assert cli_main(["faults", "inject", "plan:transient:1.0:1",
                     "--device", "cpu"]) == 0
    assert "retry absorbed the fault" in capsys.readouterr().out
    assert cli_main(["faults", "inject", "tube:nosuchkind"]) == 2
