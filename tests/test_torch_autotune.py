"""The port's plan store and autotuner on the CPU, mirroring the
reference's tests/test_plans.py: key round trip, two-level cache hit and
miss, disk-store versioning and invalidation, the stale-token skip, the
offline refusal, the race's tune-or-reject contract (with an injected
timer), the sticky-error abort, the CUDA fault taxonomy, the race's
candidates against the reference's, and the ``plan`` CLI.  conftest.py
sets PIFFT_PLAN_CACHE=off; tests of the disk store point it at a tmp
dir.  The race on the card is in ``test_torch_cuda.py``."""

import json
import os

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.plans import ladder as ref_ladder
from cs87project_msolano2_tpu.plans.core import PlanKey as RefPlanKey
from cs87project_msolano2_tpu_torch import __version__, plans
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.plans import autotune
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import (
    SCHEMA_VERSION,
    CandidateResult,
    Plan,
    PlanKey,
    device_is_tunable,
    offline_kind,
)
from cs87project_msolano2_tpu_torch.resilience import (
    CapacityError,
    FaultKind,
    LoweringError,
    PifftError,
    TransientBackendError,
    classify,
    sticky,
    wrap,
)

CARD = "NVIDIA H100 80GB HBM3"
# what a kernel wrapper raises for a refused launch and for a faulting one
COOP_REFUSED = RuntimeError(
    "fused launch failed: CUDA error 720 cudaErrorCooperativeLaunchTooLarge "
    "(too many blocks in cooperative launch)")
ILLEGAL = RuntimeError(
    "fused launch failed: CUDA error 700 cudaErrorIllegalAddress (an "
    "illegal memory access was encountered)")


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    """Each test starts with an empty in-process cache (the disk level
    is governed per test via PIFFT_PLAN_CACHE)."""
    plan_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)


def tuned_key(**kw):
    base = dict(device_kind=CARD, n=1 << 20, batch=(), layout="pi",
                precision="split3")
    base.update(kw)
    return PlanKey(**base)


def fake_timer_factory(times):
    """timer(fn, key) returning canned times per call, raising for
    entries whose canned value is an exception instance."""
    seq = iter(times)

    def timer(fn, key):
        t = next(seq)
        if isinstance(t, Exception):
            raise t
        return t

    return timer


# ---------------------------------------------------------------- keys


def test_key_token_round_trip():
    for key in (
        tuned_key(),
        tuned_key(batch=(64, 8), layout="natural", precision="highest"),
        plans.make_key(4096, (16,), device="cpu"),
    ):
        assert PlanKey.from_token(key.token()) == key
    assert json.loads(tuned_key().token())["v"] == SCHEMA_VERSION
    with pytest.raises(ValueError, match="schema"):
        PlanKey.from_token(tuned_key().token().replace(
            f'"v":{SCHEMA_VERSION}', '"v":0'))


def test_key_validation():
    with pytest.raises(ValueError):
        tuned_key(layout="scrambled")
    with pytest.raises(ValueError):
        tuned_key(precision="bf8")
    with pytest.raises(ValueError):
        tuned_key(backend="tpu")
    assert tuned_key(batch=(3,), n=512).input_shape() == (3, 512)
    assert tuned_key(n=16).input_shape() == (16,)


def test_device_kinds_on_the_cpu():
    # no card here: "cuda" names no card, and neither kind may tune
    assert plans.make_key(1024, device="cpu").device_kind == "cpu"
    assert plans.make_key(1024).device_kind == "cuda"
    assert offline_kind("cpu") and offline_kind("cuda")
    assert not offline_kind(CARD)
    assert not device_is_tunable("cpu")
    assert not device_is_tunable("cuda")


# ------------------------------------------------- offline static plans


def test_offline_never_tunes_and_serves_static():
    key = plans.make_key(1 << 20, device="cpu")
    with pytest.raises(plans.TuningUnavailable, match="offline"):
        plans.tune(key, device="cpu")
    plan = plans.get_plan(key, "cpu")
    assert plan.source == "static"
    assert (plan.variant, plan.device) == ("rql", "cpu")


def test_get_plan_never_tunes_on_the_cpu_even_opted_in(monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "default_timer", fake_timer_factory(
        [AssertionError("the CPU raced the ladder")]))
    plan = plans.get_plan(plans.make_key(1 << 20, device="cpu"), "cpu")
    assert plan.source == "static" and plan.variant == "rql"


def test_tune_or_static_degrades_offline(capsys):
    plan = plans.tune_or_static(plans.make_key(1 << 21, device="cpu"),
                                device="cpu")
    assert (plan.source, plan.variant) == ("static", "fourstep")
    assert "not tuning" in capsys.readouterr().err


# --------------------------------------------------------------- cache


def test_memory_cache_hit_and_miss(monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", "off")
    key = tuned_key()
    assert plan_cache.lookup(key) is None  # miss
    plan = Plan(key=key, variant="rql",
                params={"tile": 1 << 14, "cb": None},
                source="tuned", ms=0.09)
    plan_cache.store(plan)
    assert plan_cache.lookup(key) is plan  # same in-process object
    assert plan_cache.lookup(tuned_key(n=1 << 21)) is None  # other key


def test_disk_store_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = tuned_key()
    record = [CandidateResult("fused", {"tile": 1 << 14, "qb": 2}, "won",
                              0.05, "fastest measured"),
              CandidateResult("rql", {"tile": 1 << 14, "cb": 32}, "lost",
                              0.07, "0.0700 ms vs winner 0.0500 ms"),
              CandidateResult("fused-alias", {"tile": 1 << 14, "qb": 4},
                              "rejected", None, "permanent ValueError: x")]
    plan = Plan(key=key, variant="fused", params={"tile": 1 << 14, "qb": 2},
                source="tuned", ms=0.05, tuning=record)
    plan_cache.store(plan)
    path = plan_cache.store_path(key.device_kind)
    assert os.path.exists(path)
    # a "second process": drop the memory level, hit the disk level
    plan_cache.clear(memory=True, disk=False)
    hit = plan_cache.lookup(key)
    assert hit is not None and hit.source == "cache"
    assert hit.variant == "fused" and hit.params["qb"] == 2
    assert hit.ms == pytest.approx(0.05)
    assert hit.tuning == record
    # and get_plan serves it without touching the static default
    assert plans.get_plan(key).variant == "fused"


def test_disk_store_version_invalidation(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = tuned_key()
    plan_cache.store(Plan(key=key, variant="rql", params={},
                          source="tuned"))
    path = plan_cache.store_path(key.device_kind)

    def reload_with(**edits):
        with open(path) as fh:
            data = json.load(fh)
        data.update(edits)
        with open(path, "w") as fh:
            json.dump(data, fh)
        plan_cache.clear(memory=True, disk=False)
        return plan_cache.lookup(key)

    assert reload_with() is not None  # untouched: still served
    # stale library version: the whole store is ignored
    assert reload_with(library_version="0.0.0-other") is None
    # wrong schema: ignored
    assert reload_with(library_version=__version__,
                       schema=SCHEMA_VERSION + 1) is None
    # wrong device kind: ignored
    assert reload_with(schema=SCHEMA_VERSION,
                       device_kind="NVIDIA someone-elses") is None
    # corrupt JSON: treated as absent, never an error
    with open(path, "w") as fh:
        fh.write("{not json")
    plan_cache.clear(memory=True, disk=False)
    assert plan_cache.lookup(key) is None


def test_cache_off_never_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setenv("PIFFT_PLAN_CACHE", "off")
    plan_cache.store(Plan(key=tuned_key(), variant="rql", params={},
                          source="tuned"))
    assert plan_cache.cache_dir() is None
    assert list(tmp_path.iterdir()) == []  # nothing written anywhere


def test_store_directory_is_the_ports_own(tmp_path, monkeypatch):
    from cs87project_msolano2_tpu.plans import cache as ref_cache

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("PIFFT_PLAN_CACHE")
    mine = plan_cache.cache_dir()
    assert mine == os.path.join(str(tmp_path),
                                "cs87project-msolano2-tpu-torch")
    assert mine != ref_cache.cache_dir()
    plan_cache.store(Plan(key=tuned_key(), variant="rql", params={},
                          source="tuned"))
    assert os.listdir(mine) == ["plans-NVIDIA-H100-80GB-HBM3.json"]


def test_stale_token_skipped_with_one_warn(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(plan_cache, "_STALE_WARNED", set())
    key = tuned_key()
    plan_cache.store(Plan(key=key, variant="rql", params={},
                          source="tuned"))
    path = plan_cache.store_path(key.device_kind)
    with open(path) as fh:
        data = json.load(fh)
    stale = tuned_key(n=1 << 19).token().replace(
        f'"v":{SCHEMA_VERSION}', '"v":0')
    data["plans"][stale] = {"variant": "fused", "params": {}}
    with open(path, "w") as fh:
        json.dump(data, fh)
    for _ in range(3):
        plan_cache.clear(memory=True, disk=False)
        assert plan_cache.lookup(key).variant == "rql"
    assert capsys.readouterr().err.count("stale-schema") == 1
    # a merge-write carries the stale entry through verbatim
    plan_cache.store(Plan(key=tuned_key(n=1 << 18), variant="rql",
                          params={}, source="tuned"))
    with open(path) as fh:
        assert stale in json.load(fh)["plans"]


def test_unwritable_store_warns_and_keeps_the_plan(tmp_path, monkeypatch,
                                                   capsys):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(blocker / "sub"))
    plan = Plan(key=tuned_key(), variant="rql", params={}, source="tuned")
    plan_cache.store(plan)
    assert "write failed" in capsys.readouterr().err
    assert plan_cache.lookup(tuned_key()) is plan


def test_cached_plan_sends_numpy_to_its_kinds_device():
    key = plans.make_key(256, (2,), device="cpu")
    plan = Plan.from_record(key, {"variant": "rows", "params": {}})
    assert plan.device is None
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))
    yr, yi = plan.execute(x.real, x.imag)
    assert yr.device.type == "cpu"
    y = yr.numpy() + 1j * yi.numpy()
    ref = np.fft.fft(x)
    # split3 budget, as every fp32 path
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-5


# ------------------------------------------------------------ autotune


def test_tune_races_ladder_and_records_every_candidate():
    key = tuned_key()
    cands = ladder.candidates(key)
    assert len(cands) >= 8  # the flagship ladder plus the auto-cb entry
    # the first candidate's cooperative launch is refused, second wins
    times = [COOP_REFUSED, 0.094]
    times += [0.1 + 0.01 * i for i in range(len(cands) - 2)]
    plan = plans.tune(key, timer=fake_timer_factory(times),
                      allow_offline=True, persist=False, verbose=False)
    assert plan.source == "tuned"
    assert plan.variant == cands[1][0] and plan.params == cands[1][1]
    assert plan.ms == pytest.approx(0.094)
    # every ladder entry is timed (won/lost with ms) or rejected with a
    # recorded reason — none silently dropped
    assert len(plan.tuning) == len(cands)
    for rec in plan.tuning:
        assert rec.status in ("won", "lost", "rejected")
        if rec.status == "rejected":
            assert rec.ms is None
            assert rec.reason.startswith("capacity RuntimeError")
            assert "cudaErrorCooperativeLaunchTooLarge" in rec.reason
        else:
            assert rec.ms is not None and rec.reason
    assert [r.status for r in plan.tuning].count("won") == 1


def test_tune_records_pre_launch_rejections():
    # at 2^25 the flagship rql entries' 2048 x 32 blocks overflow shared
    # memory: build_executor refuses them before any launch
    key = tuned_key(n=1 << 25)
    cands = ladder.candidates(key)
    plan = plans.tune(key, timer=lambda fn, key: 1.0, allow_offline=True,
                      persist=False, verbose=False)
    rejected = [r for r in plan.tuning if r.status == "rejected"]
    assert rejected and len(plan.tuning) == len(cands)
    for r in rejected:
        assert r.reason.startswith("permanent ValueError")
        assert "limit 232448" in r.reason


def test_race_reraises_a_sticky_cuda_error():
    key = tuned_key()
    calls = []

    def timer(fn, key):
        calls.append(1)
        if len(calls) == 2:
            raise ILLEGAL
        return 0.1

    with pytest.raises(RuntimeError, match="illegal memory access"):
        plans.tune(key, timer=timer, allow_offline=True, persist=False,
                   verbose=False)
    assert len(calls) == 2  # nothing ran after the fault
    assert plan_cache.lookup(key) is None  # and nothing was stored


def test_tune_cache_hit_skips_race(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = tuned_key()
    ncands = len(ladder.candidates(key))
    plans.tune(key, timer=fake_timer_factory([0.1] * ncands),
               allow_offline=True, verbose=False)
    # second tune: must NOT invoke the timer at all (a raising timer
    # proves the race never re-runs), and must log the cache hit
    plan = plans.tune(key, timer=fake_timer_factory(
        [AssertionError("ladder re-raced on a cache hit")] * ncands),
        allow_offline=True)
    assert plan.variant and capsys.readouterr().err.count("cache hit") == 1
    # ...even from a fresh process (memory dropped, disk hit)
    plan_cache.clear(memory=True, disk=False)
    plan2 = plans.tune(key, timer=fake_timer_factory(
        [AssertionError("ladder re-raced on a disk hit")] * ncands),
        allow_offline=True)
    assert plan2.source == "cache"
    assert capsys.readouterr().err.count("cache hit") == 1


def test_tune_ignores_memoized_static_plan():
    # get_plan parks static defaults in the same LRU the tuner consults;
    # those must not masquerade as tuning results or the race never runs
    key = tuned_key()
    static = plans.get_plan(key)
    assert static.source == "static" and static.variant == "rql"
    ncands = len(ladder.candidates(key))
    plan = plans.tune(key, timer=fake_timer_factory([0.1] * ncands),
                      allow_offline=True, persist=False, verbose=False)
    assert plan.source == "tuned" and len(plan.tuning) == ncands


@pytest.fixture
def card_is_tunable(monkeypatch):
    """Pretend a card is present for the opt-in decision and the race's
    refusal, with the timer stubbed: the machinery, not the card."""
    monkeypatch.setattr(plans, "device_is_tunable", lambda device: True)
    monkeypatch.setattr(autotune, "device_is_tunable", lambda device: True)


def test_tune_refuses_a_key_that_names_no_card(card_is_tunable):
    # a card is present, but the key is the CPU's: card timings must
    # never be stored under it
    key = plans.make_key(1 << 20, layout="pi", device="cpu")
    with pytest.raises(plans.TuningUnavailable, match="'cpu'"):
        plans.tune(key, timer=lambda fn, key: 0.1, verbose=False)


def test_autotune_opt_in_not_vetoed_by_static_memo(monkeypatch,
                                                   card_is_tunable):
    # PIFFT_PLAN_AUTOTUNE=1: a static fallback parked in the LRU by an
    # earlier failed race must not stop get_plan from tuning on retry
    monkeypatch.setenv("PIFFT_PLAN_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "default_timer",
                        lambda fn, key, device: 0.5)
    key = tuned_key()
    plan_cache.memoize(Plan(key=key, variant="rql", params={},
                            source="static"))
    plan = plans.get_plan(key)
    assert plan.source == "tuned"
    # and with the opt-in off, the memoized plan (now tuned) still serves
    monkeypatch.delenv("PIFFT_PLAN_AUTOTUNE")
    assert plans.get_plan(key) is plan


def test_opted_in_failed_race_warns_and_serves_static(monkeypatch, capsys,
                                                      card_is_tunable):
    monkeypatch.setenv("PIFFT_PLAN_AUTOTUNE", "1")

    def refuse(fn, key, device):
        raise COOP_REFUSED

    monkeypatch.setattr(autotune, "default_timer", refuse)
    plan = plans.get_plan(tuned_key())
    assert (plan.source, plan.variant) == ("static", "rql")
    assert "opted-in autotune failed (TuningError" in capsys.readouterr().err


def test_failed_opt_in_race_is_not_rerun(monkeypatch, capsys,
                                          card_is_tunable):
    # a key whose opted-in race failed serves its static plan from then
    # on: no second race, no second warning, until the cache is cleared
    monkeypatch.setenv("PIFFT_PLAN_AUTOTUNE", "1")
    races = []

    def refuse(fn, key, device):
        races.append(key)
        raise COOP_REFUSED

    monkeypatch.setattr(autotune, "default_timer", refuse)
    key = tuned_key()
    first = plans.get_plan(key)
    raced = len(races)
    assert raced >= 1 and plans.get_plan(key) is first
    assert len(races) == raced
    assert capsys.readouterr().err.count("opted-in autotune failed") == 1
    plan_cache.clear(memory=True, disk=False)
    plans.get_plan(key)
    assert len(races) == 2 * raced


def test_memory_hit_builds_no_token(monkeypatch):
    # the in-process LRU is keyed by the frozen key itself: a hit on the
    # per-call path serializes nothing
    key = tuned_key()
    plan = Plan(key=key, variant="rql", params={}, source="static")
    plan_cache.memoize(plan)

    def no_token(self):
        raise AssertionError("a memory hit built a token")

    monkeypatch.setattr(PlanKey, "token", no_token)
    assert plan_cache.lookup(key) is plan and plans.get_plan(key) is plan


def test_tune_all_rejected_raises_with_reasons():
    key = tuned_key()
    ncands = len(ladder.candidates(key))
    boom = [RuntimeError(f"CUDA error 2 cudaErrorMemoryAllocation (out of "
                         f"memory) {i}") for i in range(ncands)]
    with pytest.raises(plans.TuningError) as ei:
        plans.tune(key, timer=fake_timer_factory(boom),
                   allow_offline=True, verbose=False)
    assert len(ei.value.results) == ncands
    assert all(r.status == "rejected" and r.reason.startswith("capacity")
               for r in ei.value.results)


def test_tune_sweep_reports_measured_crossovers(monkeypatch):
    # a stand-in ladder: each executor is its (variant, params), and the
    # timer makes fourstep win from 2^22 and sixstep from 2^25
    monkeypatch.setattr(autotune.ladder, "build_executor",
                        lambda key, variant, params: variant)

    def timer(variant, key):
        want = ("sixstep" if key.n >= 1 << 25 else
                "fourstep" if key.n >= 1 << 22 else "fused")
        return 1.0 if variant == want else 2.0

    got, cross = plans.tune_sweep([1 << 25, 1 << 20, 1 << 22], timer=timer,
                                  allow_offline=True, persist=False,
                                  verbose=False, device="cpu")
    assert [p.key.n for p in got] == [1 << 20, 1 << 22, 1 << 25]
    assert [p.variant for p in got] == ["fused", "fourstep", "sixstep"]
    assert cross == 1 << 22
    assert plans.sixstep_crossover(got) == 1 << 25
    assert plans.fourstep_crossover(got[:1]) is None


def test_sweep_refuses_offline():
    with pytest.raises(plans.TuningUnavailable):
        plans.tune_sweep([1 << 20], verbose=False, device="cpu")


# ------------------------------------------------------------- ladder


def _without_tail_doublings(cands):
    """The reference's race with every entry that differs from an
    earlier one only in ``tail`` dropped: the port has no tail axis."""
    seen, out = set(), []
    for variant, params in cands:
        ident = (variant, tuple(sorted((k, v) for k, v in params.items()
                                       if k != "tail")))
        if ident not in seen:
            seen.add(ident)
            out.append((variant, params))
    return out


@pytest.mark.parametrize("logn", [17, 20, 21, 22, 24, 25, 26])
def test_candidates_match_the_reference(logn):
    n = 1 << logn
    ref = ref_ladder.candidates(RefPlanKey(
        device_kind="TPU v5e", n=n, layout="pi", backend="tpu"))
    ref = _without_tail_doublings(ref)
    mine = ladder.candidates(tuned_key(n=n))

    def shape(cands):
        # variant, its twiddle mode, and which axes an entry sets
        return [(v, p.get("separable", True),
                 tuple(sorted(k for k, x in p.items()
                              if x is not None and k != "tail")))
                for v, p in cands]

    assert shape(mine) == shape(ref)
    for (_, p), (_, rp) in zip(mine, ref):
        # Hopper-legal values: the tile is at most 2^14 where the TPU's
        # was 2^16, and halves exactly where the reference's halves
        assert p.get("tile", 1) <= 1 << 14
        if "tile" in p and "tile" in rp:
            assert rp["tile"] // p["tile"] == 4


def test_flagship_entries_build_at_the_headline_size():
    # every race entry at n = 2^20 builds (none refused on the CPU)
    key = tuned_key()
    for variant, params in ladder.candidates(key):
        assert callable(ladder.build_executor(key, variant, params))


def test_rows_ladder_covers_batched_keys():
    cands = ladder.candidates(plans.make_key(4096, (64,), device="cpu"))
    assert cands == [("rows", {})]


def test_candidates_refuse_unported_keys():
    with pytest.raises(NotImplementedError, match="bf16"):
        ladder.candidates(tuned_key(precision="bf16"))
    with pytest.raises(ValueError, match="not ported yet"):
        ladder.candidates(tuned_key(domain="r2c", layout="natural"))
    with pytest.raises(ValueError, match="not ported yet"):
        ladder.candidates(tuned_key(n=1000, layout="natural"))


# ----------------------------------------------------- fault taxonomy


@pytest.mark.parametrize("exc,kind,is_sticky", [
    (COOP_REFUSED, FaultKind.CAPACITY, False),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     FaultKind.CAPACITY, False),
    (RuntimeError("tile_fft launch failed: CUDA error 701 "
                  "cudaErrorLaunchOutOfResources (too many resources "
                  "requested for launch)"), FaultKind.CAPACITY, False),
    (ILLEGAL, FaultKind.PERMANENT, True),
    (RuntimeError("CUDA error: misaligned address"), FaultKind.PERMANENT,
     True),
    (RuntimeError("CUDA error: unspecified launch failure"),
     FaultKind.PERMANENT, True),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), FaultKind.TRANSIENT, False),
    (ValueError("fused blocks R=64 x qb=4 need 262144 bytes of shared "
                "memory (limit 232448)"), FaultKind.PERMANENT, False),
    (MemoryError(), FaultKind.CAPACITY, False),
    (ConnectionResetError(), FaultKind.TRANSIENT, False),
    (RuntimeError("something nobody has seen"), FaultKind.PERMANENT,
     False),
    (CapacityError("typed"), FaultKind.CAPACITY, False),
])
def test_classify_cuda_errors(exc, kind, is_sticky):
    assert classify(exc) is kind
    assert sticky(exc) is is_sticky


def test_wrap_types_the_fault():
    assert isinstance(wrap(COOP_REFUSED), CapacityError)
    assert isinstance(wrap(ILLEGAL), LoweringError)
    assert isinstance(wrap(RuntimeError("CUDA error: CUDA-capable "
                                        "device(s) is/are busy or "
                                        "unavailable")),
                      TransientBackendError)
    plain = wrap(RuntimeError("something nobody has seen"))
    assert type(plain) is PifftError and plain.__cause__ is not None
    typed = CapacityError("x")
    assert wrap(typed) is typed


# ----------------------------------------------------------------- cli


def test_cli_plan_show_and_clear(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    assert cli_main(["plan", "show"]) == 0
    out = capsys.readouterr().out
    assert "static defaults" in out  # empty store

    key = plans.make_key(1 << 20, layout="pi")  # this machine's kind
    plan_cache.store(Plan(key=key, variant="fused",
                          params={"tile": 1 << 14, "qb": 2},
                          source="tuned", ms=0.05))
    assert cli_main(["plan", "show"]) == 0
    out = capsys.readouterr().out
    assert f"n={1 << 20}" in out and "fused" in out and "0.0500 ms" in out

    assert cli_main(["plan", "clear"]) == 0
    assert "removed" in capsys.readouterr().out
    plan_cache.clear(memory=True, disk=False)
    assert plan_cache.lookup(key) is None


@pytest.mark.parametrize("argv", [["plan", "warm", "-n", "2^20"],
                                  ["plan", "sweep", "--ns", "2^20"]])
def test_cli_plan_warm_refuses_offline(argv, capsys):
    assert cli_main(argv) == 2
    assert "offline" in capsys.readouterr().err


def test_cli_plan_shapes_waits_for_the_serve_slice(capsys):
    assert cli_main(["plan", "warm", "--shapes", "shapes.jsonl"]) == 2
    assert "serving slice" in capsys.readouterr().err


def test_cli_plan_warm_refuses_unported_keys(capsys, monkeypatch,
                                            card_is_tunable):
    monkeypatch.setattr(plans, "current_device_kind", lambda device: CARD)
    assert cli_main(["plan", "warm", "--precision", "bf16"]) == 2
    assert "bf16" in capsys.readouterr().err


def test_plan_describe():
    plan = Plan(key=tuned_key(), variant="fused", params={"qb": 2},
                source="tuned", ms=0.0123456)
    assert plan.describe() == {"variant": "fused", "params": {"qb": 2},
                               "source": "tuned", "ms": 0.0123}
    assert torch.device(plan._numpy_device(np.zeros(1))).type == "cuda"
