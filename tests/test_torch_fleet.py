"""The port's fleet loop (``fleet/``) on the CPU, case for case against
the reference's ``tests/test_fleet.py``, with the reference's modules run
beside it where both compute the same thing: the drift scanner's
findings on the same stub populations (verdict p-values within 1e-12),
the baseline's minimum-samples rule, the decayed arrival model (decay,
hot order, the clock rebase across persistence, a corrupt file starting
cold, each package loading the other's model file, the file beside the
plan cache), the canary racer's promote/abort/rollback contract with an
injected timer (journaled epochs, a byte-identical store after a
``promote`` fault), the shadow timer's population, the traffic mirror,
the router's canary exclusion, the plan store's lock, the fleet event
schemas and ``fleet model``'s output.

No assertion here depends on wall-clock latency: the timed drive
(drift under a stall, promotion, recovery) is ``fleet smoke``, run on
the card by ``chip_smoke.py`` phase 22."""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import obs as ref_obs
from cs87project_msolano2_tpu.cli import main as ref_cli_main
from cs87project_msolano2_tpu.fleet import ArrivalModel as RefArrivalModel
from cs87project_msolano2_tpu.fleet import DriftDetector as RefDriftDetector
from cs87project_msolano2_tpu.fleet import (
    TrafficMirror as RefTrafficMirror,
)
from cs87project_msolano2_tpu.obs import metrics as ref_metrics
from cs87project_msolano2_tpu.plans import cache as ref_plan_cache
from cs87project_msolano2_tpu.serve.batcher import GroupKey as RefGroupKey
from cs87project_msolano2_tpu_torch import obs, plans
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.fleet import (
    ArrivalModel,
    CanaryController,
    DriftDetector,
    FleetController,
    TrafficMirror,
    model_path,
)
from cs87project_msolano2_tpu_torch.obs import events, metrics
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans.core import Plan
from cs87project_msolano2_tpu_torch.resilience.inject import (
    KNOWN_SITES,
    inject,
)
from cs87project_msolano2_tpu_torch.resilience.journal import Journal
from cs87project_msolano2_tpu_torch.serve import (
    GroupKey,
    MeshConfig,
    MeshDevice,
    MeshDispatcher,
    NoDeviceAvailable,
    ShapeSpec,
)
from cs87project_msolano2_tpu_torch.serve.router import Router

CPU = "cpu"
#: drift and canary verdicts, port vs reference, on the same populations
P_TOL = 1e-12


@pytest.fixture
def obs_run():
    rid = obs.enable()
    yield rid
    obs.disable()
    metrics.reset()


@pytest.fixture
def ref_obs_run():
    rid = ref_obs.enable()
    yield rid
    ref_obs.disable()
    ref_metrics.reset()


@pytest.fixture(autouse=True)
def _fresh_plan_memory():
    plan_cache.clear(memory=True, disk=False)
    ref_plan_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)
    ref_plan_cache.clear(memory=True, disk=False)


def key_cpu(n=256):
    return plans.make_key(n, device=CPU)


class _StubStats:
    def __init__(self, totals):
        self.totals = totals

    def window_totals(self, window_s=None):
        return self.totals


# --------------------------------------------------------- the drift scan


def test_drift_detector_merges_devices_and_emits(obs_run, ref_obs_run):
    totals = {
        "256:natural:split3@vdev0": [0.030] * 10,
        "256:natural:split3@vdev1": [0.032] * 10,
        "512:natural:split3@vdev0": [0.002] * 10,
    }
    found = {}
    for cls in (DriftDetector, RefDriftDetector):
        det = cls(_StubStats(totals), min_samples=8)
        det.set_baseline("256:natural:split3", [2.0] * 20)   # ms
        det.set_baseline("512:natural:split3",
                         [2.0 + 0.01 * i for i in range(20)])
        found[cls] = {f.label: f for f in det.scan()}
    port, ref = found[DriftDetector], found[RefDriftDetector]
    assert sorted(port) == sorted(ref)
    for label, f in port.items():
        r = ref[label]
        assert f.drifted == r.drifted
        assert abs(f.verdict.p_value - r.verdict.p_value) <= P_TOL
        assert f.verdict.med_change == pytest.approx(r.verdict.med_change,
                                                     abs=P_TOL)
        assert f.live_p99_ms == pytest.approx(r.live_p99_ms, abs=P_TOL)
        assert f.to_json().keys() == r.to_json().keys()
    f = port["256:natural:split3"]
    assert f.drifted and len(f.live_ms) == 20   # both devices merged
    assert f.live_p99_ms > f.baseline_p99_ms
    assert not port["512:natural:split3"].drifted
    drift_events = [r for r in events.snapshot()
                    if r["kind"] == "fleet_drift"]
    assert len(drift_events) == 1
    assert not events.validate_event(drift_events[0])
    assert metrics.counter_value("pifft_fleet_drift_total",
                                 shape="256:natural:split3") == 1.0


def test_drift_detector_baseline_capture_respects_min_samples():
    for cls in (DriftDetector, RefDriftDetector):
        stats = _StubStats({"a": [0.001] * 20, "b": [0.001] * 3})
        det = cls(stats, min_samples=8)
        assert det.capture_baseline() == ["a"]
        assert det.baselines() == ["a"]
        # too few live samples: the scan stays silent rather than
        # running an anticonservative MW on a half-empty window
        stats.totals = {"a": [0.5] * 4}
        assert det.scan() == []


# -------------------------------------------------------------- the canary


def _fast_timer(ms=1.0):
    def timer(fn, key):
        return ms
    return timer


def test_canary_promotes_on_verdict_and_journals_epoch(
        tmp_path, monkeypatch, obs_run):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    journal = Journal(str(tmp_path / "journal.jsonl"))
    ctl = CanaryController(journal=journal)
    key = key_cpu()
    live_ms = [30.0 + 0.1 * i for i in range(40)]
    out = ctl.race(key, live_ms, timer=_fast_timer(),
                   candidate_samples=[1.0 + 0.01 * i for i in range(8)])
    assert out.promoted and not out.rolled_back
    assert out.epoch == 1 and out.verdict.significant
    assert out.prior_variant == "rows" and out.winner_variant == "rows"
    store = plan_cache.store_path(key.device_kind)
    with open(store, encoding="utf-8") as fh:
        assert key.token() in json.load(fh)["plans"]
    cells = journal.load()
    assert f"promote:{key.token()}:e1" in cells
    assert f"promoted:{key.token()}:e1" in cells
    kinds = [r["kind"] for r in events.snapshot()]
    assert "fleet_canary" in kinds and "fleet_promote" in kinds
    for rec in events.snapshot():
        assert not events.validate_event(rec), rec
    # a rebuilt controller resumes the epoch count from the journal
    again = CanaryController(journal=Journal(str(tmp_path
                                                 / "journal.jsonl")))
    out2 = again.race(key, live_ms, timer=_fast_timer(),
                      candidate_samples=[1.0] * 8)
    assert out2.promoted and out2.epoch == 2


def test_canary_rejects_insignificant_candidate(
        tmp_path, monkeypatch, obs_run):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    ctl = CanaryController()
    key = key_cpu()
    live_ms = [1.0 + 0.01 * i for i in range(40)]
    # the candidate population straddles the live median: no verdict
    out = ctl.race(key, live_ms, timer=_fast_timer(),
                   candidate_samples=[1.16 + 0.01 * i for i in range(8)])
    assert not out.promoted and not out.rolled_back
    assert out.epoch is None
    assert out.reason.startswith("not promoted")
    store = plan_cache.store_path(key.device_kind)
    assert store is None or not os.path.exists(store)
    # the unpromoted shadow winner must not serve from the LRU
    assert plans.get_plan(key, device=CPU).source != "tuned"


def test_canary_site_fault_aborts_before_any_write(
        tmp_path, monkeypatch, obs_run):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    journal = Journal(str(tmp_path / "journal.jsonl"))
    ctl = CanaryController(journal=journal)
    key = key_cpu()
    with inject("canary", "transient", count=1):
        out = ctl.race(key, [30.0] * 40, timer=_fast_timer(),
                       candidate_samples=[1.0] * 8)
    assert not out.promoted and not out.rolled_back
    assert "aborted" in out.reason and "transient" in out.reason
    assert journal.load() == {}
    store = plan_cache.store_path(key.device_kind)
    assert store is None or not os.path.exists(store)
    assert metrics.counter_value("pifft_fleet_rollback_total") == 0.0
    assert metrics.counter_value("pifft_fleet_canary_aborted_total",
                                 kind="transient") == 1.0


def test_promote_fault_rolls_back_byte_identical(
        tmp_path, monkeypatch, obs_run):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    journal = Journal(str(tmp_path / "journal.jsonl"))
    key = key_cpu()
    # a pre-existing store entry (another key) must survive untouched
    other = key_cpu(512)
    plan_cache.store(Plan(key=other, variant="rql", params={},
                          source="tuned", ms=1.0))
    store = plan_cache.store_path(key.device_kind)
    with open(store, "rb") as fh:
        pre = fh.read()

    ctl = CanaryController(journal=journal)
    live_ms = [30.0 + 0.1 * i for i in range(40)]
    with inject("promote", "permanent", count=1):
        out = ctl.race(key, live_ms, timer=_fast_timer(),
                       candidate_samples=[1.0] * 8)
    assert out.rolled_back and not out.promoted
    with open(store, "rb") as fh:
        assert fh.read() == pre
    assert f"rollback:{key.token()}:e1" in journal.load()
    assert metrics.counter_value("pifft_fleet_rollback_total") == 1.0
    rb = [r for r in events.snapshot() if r["kind"] == "fleet_rollback"]
    assert len(rb) == 1 and not events.validate_event(rb[0])
    payload = rb[0]["payload"]
    assert payload["kind"] == "permanent"
    assert payload["to"] == out.prior_variant
    # demotion discipline on the demoted candidate plan, and the prior
    # plan serves again
    assert out.plan.degraded and out.plan.demotions[-1]["kind"] == \
        "permanent"
    assert plan_cache.lookup(key) is out.prior_plan


def test_promote_rollback_with_no_prior_store_removes_it(
        tmp_path, monkeypatch, obs_run):
    """A race that started with no store file rolls back to no store
    file (the snapshot of nothing is nothing)."""
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    key = key_cpu()
    with inject("promote", "permanent", count=1):
        out = CanaryController().race(key, [30.0] * 40,
                                      timer=_fast_timer(),
                                      candidate_samples=[1.0] * 8)
    assert out.rolled_back and out.snapshot is None
    assert not os.path.exists(plan_cache.store_path(key.device_kind))


def test_shadow_timer_times_copies_and_keeps_the_population():
    """The default timer: one untimed warm call, then `reps` timed calls
    over the mirrored planes in turn, each on fresh copies of the planes
    (the mirror's arrays are never handed to the executor); tune()
    gets the median, the verdict the whole population."""
    ctl = CanaryController(reps=5)
    mirror = TrafficMirror()
    group = GroupKey(n=8)
    for v in (1.0, 2.0):
        mirror.observe(group, np.full(8, v, np.float32),
                       np.zeros(8, np.float32))
    key = key_cpu(8)
    planes = ctl._shadow_planes(key, group, mirror)
    assert [p[0][0] for p in planes] == [1.0, 2.0]
    seen = []

    def fn(xr, xi):
        assert isinstance(xr, torch.Tensor) and xr.device.type == "cpu"
        seen.append(float(xr[0]))
        xr += 100.0   # an executor that writes over its input
        return xr, xi

    samples = []
    med = ctl._shadow_timer(planes, samples, torch.device(CPU))(fn, key)
    assert seen == [1.0, 1.0, 2.0, 1.0, 2.0, 1.0]
    assert planes[0][0][0] == 1.0   # the mirror's planes untouched
    assert len(samples) == 1 and len(samples[0][1]) == 5
    assert med == sorted(samples[0][1])[2]
    # a cold mirror still races: seeded synthetic planes of the key's
    # shape
    cold = ctl._shadow_planes(key, GroupKey(n=16), mirror)
    assert len(cold) == 1 and cold[0][0].shape == (8,)


def test_fleet_step_races_the_drifted_label_with_shadow_samples(
        tmp_path, monkeypatch, obs_run):
    """One loop iteration on a CPU mesh: the drifted served label is
    raced on the designated canary with the shadow timer (its population
    of DEFAULT_REPS samples reaches the verdict) and the canary is
    released after; an undrifted label is not raced.  The promotion
    decision is not asserted: it rests on host timings."""
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    mesh = MeshDispatcher(MeshConfig(devices=2), [ShapeSpec(n=256),
                                                  ShapeSpec(n=512)],
                          device=CPU)
    fleet = FleetController(mesh, journal_path=str(tmp_path / "j.jsonl"))
    assert mesh.fleet_tap is fleet.tap
    stats = _StubStats({"256:natural:split3@vdev0": [0.5] * 12,
                        "512:natural:split3@vdev1": [0.001] * 12})
    fleet.drift.stats = stats
    fleet.drift.set_baseline("256:natural:split3", [1.0] * 12)
    fleet.drift.set_baseline("512:natural:split3", [1.0] * 12)
    designated = []
    set_canary = mesh.router.set_canary
    monkeypatch.setattr(mesh.router, "set_canary",
                        lambda d: (designated.append(d), set_canary(d)))
    step = fleet.step(max_races=1)
    assert [f.label for f in step["findings"] if f.drifted] == \
        ["256:natural:split3"]
    (outcome,) = step["outcomes"]
    assert outcome.label == "256:natural:split3"
    assert outcome.winner_variant == "rows"
    assert outcome.verdict.samples == (12, 8)
    assert designated == ["vdev1", None]


# ------------------------------------------------------ the traffic mirror


def test_traffic_mirror_copies_and_bounds():
    for mirror_cls, group_cls in ((TrafficMirror, GroupKey),
                                  (RefTrafficMirror, RefGroupKey)):
        mirror = mirror_cls(per_group=2)
        group = group_cls(n=8)
        xr = np.ones(8, dtype=np.float32)
        mirror.observe(group, xr, None)
        xr[0] = 99.0   # the mirror must hold a COPY
        mirror.observe(group, np.full(8, 2.0), np.full(8, 3.0))
        mirror.observe(group, np.full(8, 4.0), np.full(8, 5.0))
        planes = mirror.planes(group)
        assert len(planes) == 2   # newest two
        assert planes[0][0][0] == 2.0 and planes[1][0][0] == 4.0
        assert mirror.planes(group_cls(n=16)) == []


def test_router_canary_designation_excludes_device():
    devices = [MeshDevice(i, device=CPU) for i in range(3)]
    router = Router(devices)
    group = GroupKey(n=8)
    router.set_canary("vdev2")
    assert [d.id for d in router.candidates()] == ["vdev0", "vdev1"]
    device, _why, _warmth, _load = router.choose(group)
    assert device.id != "vdev2"
    router.set_canary(None)
    assert len(router.candidates()) == 3
    for d in devices:
        d.state = "dead"
    with pytest.raises(NoDeviceAvailable):
        router.choose(group)


def test_designate_needs_a_second_healthy_device():
    mesh = MeshDispatcher(MeshConfig(devices=2), device=CPU)
    ctl = CanaryController(mesh=mesh)
    assert ctl.designate() == "vdev1"
    assert mesh.router.canary == "vdev1"
    ctl.release()
    mesh.devices[0].state = "dead"
    assert ctl.designate() is None and mesh.router.canary is None


# ------------------------------------------------------- the arrival model


def test_arrival_model_decay_and_hot_order():
    hots = []
    for model_cls, group_cls in ((ArrivalModel, GroupKey),
                                 (RefArrivalModel, RefGroupKey)):
        model = model_cls(half_life_s=10.0, min_weight=0.5)
        for _ in range(8):
            model.observe(group_cls(n=256), now=100.0)
        model.observe(group_cls(n=512), now=100.0)
        hot = model.hot(now=100.0)
        assert [k[0] for _w, k in hot] == [256, 512]
        # two half-lives later the cold shape decays under the floor
        # (0.25 < min_weight) while the hot one is still worth a warm
        hot = model.hot(now=120.0)
        assert [k[0] for _w, k in hot] == [256]
        assert hot[0][0] == pytest.approx(2.0)
        hots.append(hot)
    assert hots[0] == hots[1]


def test_arrival_model_persistence_rebases_clock(tmp_path, obs_run):
    path = str(tmp_path / "arrivals.json")
    model = ArrivalModel(path=path, half_life_s=10.0)
    model.observe(GroupKey(n=64), now=50.0)
    model.observe(GroupKey(n=64), now=50.0)
    assert model.save(now=60.0) == path   # decayed to 1.0 at save
    doc = json.load(open(path))
    assert doc["schema"] == 1
    assert doc["arrivals"][0]["weight"] == pytest.approx(1.0)
    assert "t" not in doc["arrivals"][0]   # no process-local clocks

    # a restart loads the decayed mass at ITS "now" — downtime is not
    # charged against the mix
    loaded = ArrivalModel.load(path, half_life_s=10.0, now=7.0)
    assert loaded.hot(now=7.0)[0][0] == pytest.approx(1.0)
    specs = loaded.hot_specs(now=7.0)
    assert [s.n for s in specs] == [64]
    prewarm = [r for r in events.snapshot() if r["kind"] == "fleet_prewarm"]
    assert len(prewarm) == 1 and not events.validate_event(prewarm[0])


def test_arrival_model_corrupt_file_starts_cold(tmp_path):
    path = str(tmp_path / "arrivals.json")
    with open(path, "w") as fh:
        fh.write("{not json")
    assert ArrivalModel.load(path).hot() == []
    with open(path, "w") as fh:
        json.dump({"schema": 999, "arrivals": []}, fh)
    assert ArrivalModel.load(path).hot() == []
    with open(path, "w") as fh:
        json.dump({"schema": 1, "arrivals": [{"weight": 3.0}]}, fh)
    assert ArrivalModel.load(path).hot() == []


def test_each_package_loads_the_others_model(tmp_path):
    """The file format is the reference's exactly: a model either
    package saves, the other loads to the same hot set, byte for byte
    on a re-save."""
    port_path = str(tmp_path / "port.json")
    ref_path = str(tmp_path / "ref.json")
    port = ArrivalModel(path=port_path, half_life_s=30.0)
    ref = RefArrivalModel(path=ref_path, half_life_s=30.0)
    for n, count, t in ((256, 5, 1.0), (4096, 3, 4.0), (1024, 1, 9.0)):
        for _ in range(count):
            port.observe(GroupKey(n=n, layout="pi"), now=t)
            ref.observe(RefGroupKey(n=n, layout="pi"), now=t)
    port.save(now=10.0)
    ref.save(now=10.0)
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    from_ref = ArrivalModel.load(ref_path, half_life_s=30.0, now=0.0)
    from_port = RefArrivalModel.load(port_path, half_life_s=30.0, now=0.0)
    assert from_ref.hot(now=0.0) == from_port.hot(now=0.0)
    assert [k[0] for _w, k in from_ref.hot(now=0.0)] == [256, 4096, 1024]


def test_model_path_follows_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", "off")
    assert model_path() is None
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    assert model_path() == str(tmp_path / "fleet-arrivals.json")
    from cs87project_msolano2_tpu.fleet import model_path as ref_path

    assert model_path() == ref_path()


def test_drain_persists_the_model_and_a_restart_prewarms(
        tmp_path, monkeypatch, obs_run):
    """The mesh hooks: admission feeds the tap, a drain saves the model
    beside the plan cache, and a restarted mesh with no shape set warms
    the hot groups from it."""
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    rng = np.random.default_rng(3)
    xr = rng.standard_normal(64).astype(np.float32)
    xi = rng.standard_normal(64).astype(np.float32)

    async def first():
        mesh = MeshDispatcher(MeshConfig(devices=2), [ShapeSpec(n=64)],
                              device=CPU)
        fleet = FleetController(mesh, model=ArrivalModel())
        async with mesh:
            for _ in range(3):
                await mesh.submit(xr, xi)
            await mesh.drain_device("vdev0")
        return fleet

    fleet = asyncio.run(first())
    assert len(fleet.tap.mirror.planes(GroupKey(n=64))) == 3
    assert os.path.exists(model_path())

    async def restart():
        mesh = MeshDispatcher(MeshConfig(devices=2), [], device=CPU)
        FleetController(mesh, model=ArrivalModel.load())
        async with mesh:
            mesh.warm()
            return [s.label() for s in mesh.specs]

    assert asyncio.run(restart()) == ["64:natural:split3"]


# ----------------------------------------------------- plan-store locking


def test_store_lock_serializes_concurrent_writers(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    keys = [key_cpu(n) for n in (64, 128, 256, 512)]
    errors = []

    def write(key):
        try:
            plan_cache.store(Plan(key=key, variant="rql", params={},
                                  source="tuned", ms=1.0))
        except Exception as exc:   # pragma: no cover - the assertion
            errors.append(exc)

    threads = [threading.Thread(target=write, args=(k,))
               for k in keys for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    path = plan_cache.store_path(keys[0].device_kind)
    with open(path, encoding="utf-8") as fh:
        stored = json.load(fh)["plans"]
    # no lost update: every key's merge-write survived the race
    assert {k.token() for k in keys} <= set(stored)
    assert not os.path.exists(f"{path}.lock")


def test_store_lock_breaks_stale_locks(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = key_cpu(64)
    path = plan_cache.store_path(key.device_kind)
    lock = f"{path}.lock"
    with open(lock, "w") as fh:
        fh.write("999999")   # a dead writer's leftover
    stale = time.time() - 2 * plan_cache._LOCK_STALE_S
    os.utime(lock, (stale, stale))
    plan_cache.store(Plan(key=key, variant="rql", params={},
                          source="tuned", ms=1.0))
    with open(path, encoding="utf-8") as fh:
        assert key.token() in json.load(fh)["plans"]
    assert not os.path.exists(lock)


def test_store_clear_removes_lockfiles(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = key_cpu(64)
    path = plan_cache.store_path(key.device_kind)
    plan_cache.store(Plan(key=key, variant="rql", params={},
                          source="tuned", ms=1.0))
    with open(f"{path}.lock", "w"):
        pass
    removed = plan_cache.clear(memory=False, disk=True)
    assert path in removed
    assert not os.path.exists(f"{path}.lock")


# ------------------------------------------------------ sites and events


def test_canary_and_promote_sites_are_live():
    for site in ("canary", "promote"):
        assert "not ported" not in KNOWN_SITES[site]
        assert "fleet/canary.py" in KNOWN_SITES[site]


def test_fleet_event_kinds_schema(obs_run):
    events.emit("fleet_drift", shape="s", p_value=0.01,
                live_p99_ms=5.0, baseline_p99_ms=1.0)
    events.emit("fleet_canary", shape="s", promote=True, p_value=0.01)
    events.emit("fleet_promote", token="t", variant="v", p_value=0.01,
                epoch=1)
    events.emit("fleet_rollback", token="t", epoch=1,
                **{"from": "v2", "to": "v1", "kind": "quality",
                   "reason": "p99 did not recover"})
    events.emit("fleet_prewarm", shape="s", weight=3.2)
    recs = events.snapshot()
    assert len(recs) == 5
    for rec in recs:
        assert not events.validate_event(rec), rec
    # a field-less fleet event is schema-INVALID, not silently fine
    events.emit("fleet_promote", token="t")
    bad = events.snapshot()[-1]
    assert any("missing" in p for p in events.validate_event(bad))


def test_fleet_cli_model_matches_the_reference(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    model = ArrivalModel(path=str(tmp_path / "fleet-arrivals.json"))
    model.observe(GroupKey(n=64), now=1.0)
    for _ in range(3):
        model.observe(GroupKey(n=4096, layout="pi"), now=1.0)
    model.save(now=1.0)
    outputs = {}
    for name, main in (("port", cli_main), ("ref", ref_cli_main)):
        for argv in (["fleet", "model", "--json"], ["fleet", "model"]):
            assert main(argv) == 0
            outputs[(name, len(argv))] = capsys.readouterr().out
    assert outputs[("port", 3)] == outputs[("ref", 3)]
    assert outputs[("port", 2)] == outputs[("ref", 2)]
    doc = json.loads(outputs[("port", 3)])
    assert [h["n"] for h in doc["hot"]] == [4096, 64]
    assert "n=64" in outputs[("port", 2)]
    # an empty cache: the cold message, the same in both
    os.remove(str(tmp_path / "fleet-arrivals.json"))
    assert cli_main(["fleet", "model"]) == 0
    cold = capsys.readouterr().out
    assert ref_cli_main(["fleet", "model"]) == 0
    assert capsys.readouterr().out == cold and "no hot shapes" in cold
    assert cli_main(["fleet"]) == 2


def test_fleet_smoke_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    assert cli_main(["fleet", "smoke"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
