"""The port's mesh serving (``serve/mesh.py``, ``serve/router.py``) on the
CPU, case for case against the reference's ``tests/test_serve_mesh.py``:
shape-affinity routing read from the placement counter, priority
admission (low sheds first, class-aware retry), per-tenant quotas,
self-healing device failover (kill and stall) with zero dropped requests
and consensus before the re-route, warm-cache handoff on a planned drain
with the journaled resume, the event schemas, the live ``device`` fault
site, and ``serve --mesh-smoke`` / ``bench --serve-mesh`` end to end.

Parity with the JAX package: the same seeded request sequence, submitted
one request at a time on 8 CPU devices (so load cannot differ), gives
the reference's ``MeshDispatcher``'s placement sequence, placement
labels and reasons, degrade trails and structured errors, through a
device kill; the responses agree within split3's 1e-5 rel L2 and are at
least as close to complex128 as the reference's (its split3 tail is the
looser side).

The card rule on every mesh device: with ``BatchRunner._on_card`` mocked,
no library rung serves, the overload level stops at window collapse, a
batch's capacity fault answers a structured ``RequestFailed`` (the
device stays healthy), and a device kill still fails over."""

import asyncio
import json

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import obs as ref_obs
from cs87project_msolano2_tpu import resilience as ref_resilience
from cs87project_msolano2_tpu import serve as ref_serve
from cs87project_msolano2_tpu_torch import obs, resilience
from cs87project_msolano2_tpu_torch import serve as port_serve
from cs87project_msolano2_tpu_torch.obs import events as obs_events
from cs87project_msolano2_tpu_torch.obs import metrics
from cs87project_msolano2_tpu_torch.obs.spans import clock
from cs87project_msolano2_tpu_torch.serve import (
    GroupKey,
    MeshConfig,
    MeshDevice,
    MeshDispatcher,
    NoDeviceAvailable,
    QueueFull,
    QuotaExceeded,
    RequestFailed,
    ServeError,
    ShapeSpec,
)
from cs87project_msolano2_tpu_torch.serve.batcher import BatchRunner
from cs87project_msolano2_tpu_torch.utils.verify import (
    pi_layout_to_natural,
    rel_err,
)

CPU = "cpu"
N = 256
#: the split3 budget: port vs reference, rel L2
SPLIT3_TOL = 1e-5


def planes(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def ref_fft(xr, xi):
    return np.fft.fft(xr.astype(np.complex128)
                      + 1j * xi.astype(np.complex128))


def got(resp):
    return np.asarray(resp.yr) + 1j * np.asarray(resp.yi)


def close(resp, xr, xi):
    ref = ref_fft(xr, xi)
    return np.max(np.abs(got(resp) - ref)) / np.max(np.abs(ref)) < 1e-4


def run_async(coro, timeout_s=180.0):
    """Hard deadline: a mesh bug must FAIL, never hang the suite."""

    async def bounded():
        return await asyncio.wait_for(coro, timeout=timeout_s)

    return asyncio.run(bounded())


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    for var in ("PIFFT_OBS", "PIFFT_OBS_EVENTS", "PIFFT_TRACE_SAMPLE",
                "PIFFT_FAULT", "PIFFT_PLAN_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    yield
    for o in (obs, ref_obs):
        if o.enabled():
            o.disable()
        o.metrics.reset()


@pytest.fixture
def obs_run():
    obs.enable()
    yield obs
    obs.disable()


def mesh_cfg(devices=3, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 1.0)
    return MeshConfig(devices=devices, **kw)


def cpu_mesh(config=None, specs=None):
    return MeshDispatcher(config, specs, device=CPU)


# ------------------------------------------------------------- routing


def test_affinity_second_batch_lands_on_same_device(obs_run):
    """A warmed GroupKey's repeat traffic lands on the SAME device, read
    from the placement counter."""
    specs = [ShapeSpec(n=N), ShapeSpec(n=N, layout="pi")]
    xr, xi = planes()

    async def main():
        async with cpu_mesh(mesh_cfg(), specs) as mesh:
            home = mesh.router.route(GroupKey(n=N), record=False)
            before = metrics.counter_value(
                "pifft_serve_placement_total", device=home.id,
                reason="affinity")
            r1 = await mesh.submit(xr, xi)
            r2 = await mesh.submit(xr, xi)
            after = metrics.counter_value(
                "pifft_serve_placement_total", device=home.id,
                reason="affinity")
            return home, r1, r2, after - before

    home, r1, r2, placed = run_async(main())
    assert r1.device == home.id and r2.device == home.id
    assert placed >= 2
    assert close(r2, xr, xi)


def test_cold_group_routes_least_loaded_and_warms():
    """A group nobody warmed goes to the least-loaded device, and the
    device that served it becomes its affinity home (warmth 3: a cached
    callable)."""
    xr, xi = planes(n=128)

    async def main():
        async with cpu_mesh(mesh_cfg()) as mesh:
            r1 = await mesh.submit(xr, xi)
            r2 = await mesh.submit(xr, xi)
            first = mesh.device(r1.device)
            return r1, r2, first.warmth(GroupKey(n=128))

    r1, r2, warmth = run_async(main())
    assert r1.device == r2.device == "vdev0"
    assert warmth == 3


def test_mesh_device_map_and_backend_tags(monkeypatch):
    """Mesh device i runs on the CPU when asked, else on cuda:{i mod
    count} (one card: all share cuda:0); the default tag is the port's
    "cuda", a tag outside plans.core.BACKENDS is refused at
    construction, and the mesh defaults to the card."""
    mesh = cpu_mesh(mesh_cfg(devices=3, backends=("gpu",)))
    assert [d.device.type for d in mesh.devices] == ["cpu"] * 3
    assert [d.backend for d in mesh.devices] == ["gpu", "cuda", "cuda"]
    assert all(d.runner.device.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError, match="tpu"):
        cpu_mesh(mesh_cfg(devices=2, backends=("tpu",)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshDispatcher(mesh_cfg(devices=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = MeshDispatcher(mesh_cfg(devices=4))
    assert {str(d.device) for d in card.devices} == {"cuda:0"}
    assert all(d.runner.pool.pinned for d in card.devices)
    assert all(d.runner.fallback_rungs() == () for d in card.devices)


# ----------------------------------------------------------- admission


def test_low_priority_sheds_first_with_scaled_retry(obs_run):
    """At a fill past low's ceiling but below the hard bound, low is
    rejected (retry scaled 4x) while normal still admits."""
    from cs87project_msolano2_tpu_torch.serve.dispatcher import (
        PRIORITY_ADMIT_FILL,
        PRIORITY_RETRY_SCALE,
    )

    assert PRIORITY_ADMIT_FILL["low"] < PRIORITY_ADMIT_FILL["normal"]
    assert PRIORITY_RETRY_SCALE["low"] > PRIORITY_RETRY_SCALE["high"]
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=1, queue_depth=8, max_batch=2,
                       max_wait_ms=50.0)
        mesh = cpu_mesh(cfg)
        shed = metrics.counter_value("pifft_serve_shed_total",
                                     priority="low")
        # fill the single device's queue to 5/8: past low's ceiling (4)
        # but under normal's (8)
        pending = [asyncio.ensure_future(mesh.submit(xr, xi))
                   for _ in range(5)]
        await asyncio.sleep(0)
        with pytest.raises(QueueFull) as low_err:
            await mesh.submit(xr, xi, priority="low")
        shed_after = metrics.counter_value("pifft_serve_shed_total",
                                           priority="low")
        ok = await mesh.submit(xr, xi, priority="normal")
        await asyncio.gather(*pending)
        await mesh.close()
        return low_err.value, shed_after - shed, ok

    low_err, shed_delta, ok = run_async(main())
    assert low_err.retry_after_ms > 0
    assert shed_delta >= 1
    assert ok.batch_size >= 1


def test_tenant_quota_rejects_structured_and_releases():
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=2, tenant_quota=2, max_wait_ms=30.0)
        mesh = cpu_mesh(cfg)
        burst = [asyncio.ensure_future(
            mesh.submit(xr, xi, tenant="acme")) for _ in range(2)]
        await asyncio.sleep(0)
        with pytest.raises(QuotaExceeded) as err:
            await mesh.submit(xr, xi, tenant="acme")
        # another tenant is untouched by acme's quota
        other = await mesh.submit(xr, xi, tenant="zed")
        done = await asyncio.gather(*burst)
        # quota released on completion: acme admits again
        again = await mesh.submit(xr, xi, tenant="acme")
        await mesh.close()
        return err.value, other, done, again

    err, other, done, again = run_async(main())
    assert err.tenant == "acme" and err.quota == 2
    rec = err.to_record()
    assert rec["type"] == "tenant_quota" and rec["quota"] == 2
    assert rec["retry_after_ms"] > 0
    assert len(done) == 2 and other.batch_size >= 1
    assert again.batch_size >= 1


def test_priority_validated():
    xr, xi = planes()

    async def main():
        async with cpu_mesh(mesh_cfg(devices=1)) as mesh:
            with pytest.raises(ServeError):
                await mesh.submit(xr, xi, priority="urgent")

    run_async(main())


# ------------------------------------------------------------ failover


def test_device_kill_reroutes_zero_drops_consensus(obs_run):
    """An injected device<K> fault mid-run: the device dies ONCE, its
    queued and in-flight requests re-route failover-tagged, every future
    resolves (zero drops), consensus ran, and the survivors' answers
    stay numpy-correct."""
    specs = [ShapeSpec(n=N)]
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=3, max_batch=2, max_wait_ms=5.0)
        async with cpu_mesh(cfg, specs) as mesh:
            home = mesh.router.route(GroupKey(n=N), record=False)
            await mesh.submit(xr, xi)  # prime the home device
            with resilience.inject(home.site, "permanent", count=1):
                results = await asyncio.gather(
                    *[mesh.submit(xr, xi) for _ in range(8)])
            late = await mesh.submit(xr, xi)
            return mesh, home, results, late

    mesh, home, results, late = run_async(main())
    assert mesh.device(home.id).state == "dead"
    assert len(results) == 8  # zero dropped: every future resolved
    tagged = [r for r in results
              if any(t == f"failover:{home.id}" for t in r.degrade)]
    assert tagged and all(r.degraded for r in tagged)
    assert all(r.device != home.id for r in results)
    for r in results + [late]:
        assert close(r, xr, xi)
    # the new affinity home serves undegraded
    assert not late.degraded
    kinds = [r.get("kind") for r in obs_events.snapshot()]
    assert "serve_device_failed" in kinds
    consensus = [r for r in obs_events.snapshot()
                 if r.get("kind") == "fallback_consensus"
                 and str(r["payload"]["label"]).startswith(
                     f"serve-mesh:{home.id}")]
    assert consensus and consensus[0]["payload"]["agreed"] is True
    assert metrics.counter_value("pifft_serve_failover_total",
                                 device=home.id) >= len(tagged)


def test_device_stall_supervisor_aborts_and_fails_over(obs_run):
    """A device that STALLS under an armed batch deadline is aborted by
    the supervisor and failed over as a dead one is.  The deadline is
    armed only after both devices are primed: the supervisor cannot tell
    a cold first batch from a stall."""
    specs = [ShapeSpec(n=N)]
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=2, max_batch=1, max_wait_ms=2.0)
        async with cpu_mesh(cfg, specs) as mesh:
            home = mesh.router.route(GroupKey(n=N), record=False)
            await mesh.submit(xr, xi)  # prime the home device
            # prime the survivor too (route around the home)
            home.state = "draining"
            await mesh.submit(xr, xi)
            home.state = "healthy"
            mesh.config.batch_deadline_s = 0.2
            mesh.config.batch_abort_waits = 1
            with resilience.inject(home.site, "stall", count=1,
                                   stall_s=1.5):
                results = await asyncio.gather(
                    *[mesh.submit(xr, xi) for _ in range(4)])
            mesh.config.batch_deadline_s = None
            return mesh, home, results

    mesh, home, results = run_async(main())
    assert mesh.device(home.id).state == "dead"
    assert len(results) == 4
    assert any(f"failover:{home.id}" in r.degrade for r in results)
    for r in results:
        assert close(r, xr, xi)


def test_all_devices_dead_is_structured_not_a_hang():
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=1, max_wait_ms=2.0)
        async with cpu_mesh(cfg, [ShapeSpec(n=N)]) as mesh:
            home = mesh.devices[0]
            await mesh.submit(xr, xi)
            with resilience.inject(home.site, "permanent", count=1):
                # the in-flight batch has nowhere to go: its future
                # resolves with the structured no-device error
                with pytest.raises(NoDeviceAvailable):
                    await mesh.submit(xr, xi)
            with pytest.raises(NoDeviceAvailable) as err:
                await mesh.submit(xr, xi)
            return err.value

    err = run_async(main())
    assert err.to_record()["type"] == "no_device_available"


# --------------------------------------------------------------- drain


def test_drain_hands_warm_cache_then_queue_journaled(tmp_path, obs_run):
    """Planned drain: the successor adopts the callables BEFORE the
    queue moves, the handoff is journaled, the drained group's next
    request lands on the successor undegraded, and the moved requests
    complete."""
    journal = tmp_path / "drain.jsonl"
    specs = [ShapeSpec(n=N)]
    xr, xi = planes()
    group = GroupKey(n=N)

    async def main():
        cfg = mesh_cfg(devices=3, max_wait_ms=20.0)
        async with cpu_mesh(cfg, specs) as mesh:
            home = mesh.router.route(group, record=False)
            await mesh.submit(xr, xi)  # resolve on the home device
            assert home.warmth(group) == 3
            pending = [asyncio.ensure_future(mesh.submit(xr, xi))
                       for _ in range(3)]
            await asyncio.sleep(0)
            report = await mesh.drain_device(home.id,
                                             journal_path=str(journal))
            moved = await asyncio.gather(*pending)
            succ = mesh.device(report["handoffs"][0]["successor"])
            assert succ.warmth(group) == 3  # adopted, not re-resolved
            after = await mesh.submit(xr, xi)
            return mesh, home, report, moved, after

    mesh, home, report, moved, after = run_async(main())
    assert mesh.device(home.id).state == "drained"
    assert [h["group"] for h in report["handoffs"]] == [group.label()]
    assert report["handoffs"][0]["adopted"] >= 1
    successor = report["handoffs"][0]["successor"]
    assert after.device == successor
    assert not after.degraded and not after.degrade
    for r in moved:  # a planned move is NOT degradation
        assert not any(str(t).startswith("failover:") for t in r.degrade)
    assert close(after, xr, xi)
    records = [json.loads(line) for line in
               journal.read_text().splitlines()]
    cells = {r["cell"] for r in records}
    assert f"handoff:{home.id}:{group.label()}" in cells
    assert f"drained:{home.id}" in cells
    kinds = [r.get("kind") for r in obs_events.snapshot()]
    assert "serve_handoff" in kinds and "serve_drain_complete" in kinds


def test_drain_resumes_from_journal_after_kill(tmp_path, obs_run):
    """A journal already holding a group's handoff cell means that group
    is NOT re-handed (no duplicate serve_handoff event), but the drain
    still completes."""
    journal = tmp_path / "drain.jsonl"
    group = GroupKey(n=N)
    xr, xi = planes()

    async def main():
        cfg = mesh_cfg(devices=3, max_wait_ms=5.0)
        async with cpu_mesh(cfg, [ShapeSpec(n=N)]) as mesh:
            home = mesh.router.route(group, record=False)
            await mesh.submit(xr, xi)
            # the pre-kill drain progress: the handoff cell is
            # journaled, then the process died before the queue moved
            succ = mesh.router.route(group, exclude={home.id},
                                     record=False)
            resilience.Journal(str(journal)).record(
                f"handoff:{home.id}:{group.label()}",
                {"successor": succ.id, "adopted": 0})
            before = [r for r in obs_events.snapshot()
                      if r.get("kind") == "serve_handoff"]
            report = await mesh.drain_device(home.id,
                                             journal_path=str(journal))
            after = [r for r in obs_events.snapshot()
                     if r.get("kind") == "serve_handoff"]
            return report, len(after) - len(before)

    report, handoff_events = run_async(main())
    assert report["resumed"] == 1
    assert report["handoffs"] == []  # nothing re-handed
    assert handoff_events == 0


def test_drain_refuses_dead_device():
    async def main():
        async with cpu_mesh(mesh_cfg(devices=2)) as mesh:
            mesh.devices[0].state = "dead"
            with pytest.raises(ServeError):
                await mesh.drain_device(mesh.devices[0].id)

    run_async(main())


# --------------------------------------------------- event schema, site


def test_mesh_event_kinds_are_schemad():
    """A placement without its reason (or a failover without its count)
    is schema-invalid, so the smoke's zero-invalid gate guards them."""
    base = {"v": 1, "run": "r", "seq": 0, "kind": "serve_placement",
            "t": 0.0}
    bad = dict(base, payload={"device": "vdev0", "shape": "256"})
    assert any("reason" in p for p in obs_events.validate_event(bad))
    good = dict(base, payload={"device": "vdev0", "shape": "256",
                               "reason": "affinity"})
    assert obs_events.validate_event(good) == []
    bad2 = {"v": 1, "run": "r", "seq": 1, "kind": "serve_failover",
            "t": 0.0, "payload": {"device": "vdev0"}}
    assert any("requests" in p for p in obs_events.validate_event(bad2))


def test_device_site_registered(capsys):
    from cs87project_msolano2_tpu_torch.cli import main

    assert "device" in resilience.KNOWN_SITES
    text = resilience.KNOWN_SITES["device"]
    assert "device<K>" in text and "device*" in text
    assert "not ported" not in text
    # the fleet's two sites are live since fleet/ landed
    for site in ("canary", "promote"):
        assert "fleet/canary.py" in resilience.KNOWN_SITES[site]
        assert "not ported" not in resilience.KNOWN_SITES[site]
    assert main(["faults", "list"]) == 0
    out = capsys.readouterr().out
    assert "device<K>" in out and "device*" in out


# ------------------------------------------------------- entry points


def test_mesh_smoke_cli_end_to_end(capsys):
    """The mesh gate in-process: kill, failover, consensus, drain,
    affinity and spread all asserted."""
    from cs87project_msolano2_tpu_torch.serve.cli import serve_main

    rc = serve_main(["--mesh-smoke", "--json", "--devices", "4",
                     "--mesh-rps", "60", "--mesh-duration", "0.6",
                     "--device", CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out["problems"]
    assert out["ok"] is True and out["device"] == CPU
    assert out["report"]["failed"] == 0
    assert out["report"]["killed_device"] is not None
    assert out["report"]["failover_tagged"] >= 1
    assert out["report"]["p99_pre_kill_ms"] is not None
    assert out["report"]["p99_post_kill_ms"] is not None
    assert out["consensus_events"] >= 1
    assert out["schema_invalid_events"] == 0
    assert any(c.startswith("handoff:") for c in out["journal_cells"])


def test_utilization_is_the_unclamped_busy_share():
    """A mesh device's ``utilization`` is its batches' seconds over wall
    seconds, not clamped at 1: two groups' batches can run on one device
    at once, so a share past 1 is reported as it is."""
    mesh = cpu_mesh(mesh_cfg(devices=2))
    wall = 0.5
    mesh.t_open = clock() - wall
    mesh.devices[0].busy_s = 3 * wall
    util = mesh.utilization()
    assert util["vdev0"]["utilization"] >= 2.5
    assert util["vdev1"]["utilization"] == 0.0


def test_bench_serve_mesh_smoke_emits_row_set(capsys):
    """``bench --serve-mesh --smoke`` emits the serve_mesh row set
    (per-device utilization and the pre/post-kill p99 split) and exits
    0: the kill is the measurement, not an error."""
    from cs87project_msolano2_tpu_torch import bench

    rc = bench.main(["--serve-mesh", "--smoke", "--device", CPU,
                     "--load-rps", "60", "--load-duration", "0.5"])
    assert rc == 0
    record = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "serve_mesh_p99_post_kill_ms"
    assert record["unit"] == "ms" and record["smoke"] is True
    assert record.get("degraded") is True
    assert record["env"]["platform"] == "cpu"
    rows = record["serve_mesh"]
    devices = [r for r in rows if r["row"] == "device"]
    kills = [r for r in rows if r["row"] == "kill"]
    assert len(devices) == 8 and len(kills) == 1
    assert all({"device", "utilization", "served", "state"} <= set(r)
               for r in devices)
    kill = kills[0]
    assert kill["failed"] == 0
    assert kill["failover_tagged"] >= 1
    assert kill["p99_post_kill_ms"] == record["value"]
    assert sum(1 for r in devices if r["state"] == "dead") == 1


def test_serve_devices_and_mesh_smoke_need_the_card(monkeypatch, capsys):
    """Without ``--device cpu`` on a machine with no card, the mesh
    entry points fail with a clear error (exit 2); they never carry on
    on the CPU."""
    from cs87project_msolano2_tpu_torch.serve.cli import serve_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_main(["--mesh-smoke"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert serve_main(["--devices", "4", "--port", "0"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


# ----------------------------------------------------- the reference


PARITY_SPECS = [dict(n=256), dict(n=256, layout="pi"),
                dict(n=512, precision="fp32"), dict(n=1024, domain="r2c")]


def _parity_sequence():
    """A seeded sequence of (spec index or None for a cold n=128 group,
    planes) and the request index where the spec-0 home device is
    killed."""
    rng = np.random.default_rng(11)
    seq = []
    for i in range(20):
        k = int(rng.integers(0, len(PARITY_SPECS) + 1))
        spec = PARITY_SPECS[k] if k < len(PARITY_SPECS) else dict(n=128)
        xr = rng.standard_normal(spec["n"]).astype(np.float32)
        xi = np.zeros_like(xr) if spec.get("domain") == "r2c" \
            else rng.standard_normal(spec["n"]).astype(np.float32)
        seq.append((spec, xr, xi))
    return seq, 12


def _drive(pkg, obs_mod, inject, mesh):
    """Submit the sequence one request at a time; kill spec 0's home at
    the kill index.  Returns (per-request outcome, placement events)."""
    seq, kill_at = _parity_sequence()

    async def main():
        out = []
        async with mesh:
            for i, (spec, xr, xi) in enumerate(seq):
                kw = {k: v for k, v in spec.items() if k != "n"}
                if i == kill_at:
                    home = mesh.router.route(
                        pkg.GroupKey(n=256), record=False)
                    with inject(home.site, "permanent", count=1):
                        resp = await mesh.submit(xr, xi, **kw)
                else:
                    resp = await mesh.submit(xr, xi, **kw)
                out.append((resp.device, list(resp.degrade),
                            resp.degraded, got(resp)))
            await mesh.drain_device("vdev7")
            drained = [d.state for d in mesh.devices]
        return out, drained

    out, drained = run_async(main())
    placements = [(e["payload"]["device"], e["payload"]["shape"],
                   e["payload"]["reason"], e["payload"]["warmth"])
                  for e in obs_mod.snapshot()
                  if e.get("kind") == "serve_placement"]
    return seq, out, placements, drained


def test_mesh_parity_with_the_reference():
    """The same seeded sequence, one request at a time, on 8 CPU devices
    through the reference's MeshDispatcher and the port's: the placement
    sequence (device, label, reason, warmth), the responses' devices and
    degrade trails (failover:<device> after the kill) and the drain's
    end states are equal; the responses agree within 1e-5 rel L2 and
    are at least as close to complex128."""
    specs_port = [ShapeSpec(**s) for s in PARITY_SPECS]
    specs_ref = [ref_serve.ShapeSpec(**s) for s in PARITY_SPECS]
    obs.enable()
    try:
        seq, ours, place_ours, drain_ours = _drive(
            port_serve, obs, resilience.inject,
            MeshDispatcher(MeshConfig(devices=8, max_batch=4,
                                      max_wait_ms=1.0),
                           specs_port, device=CPU))
    finally:
        obs.disable()
    ref_obs.enable()
    try:
        _, theirs, place_ref, drain_ref = _drive(
            ref_serve, ref_obs, ref_resilience.inject,
            ref_serve.MeshDispatcher(ref_serve.MeshConfig(
                devices=8, max_batch=4, max_wait_ms=1.0), specs_ref))
    finally:
        ref_obs.disable()
    assert place_ours == place_ref
    assert drain_ours == drain_ref
    assert any(t and t[0].startswith("failover:") for _d, t, *_ in ours)
    for (spec, xr, xi), o, r in zip(seq, ours, theirs):
        assert o[:3] == r[:3], spec
        assert o[3].shape == r[3].shape
        assert rel_err(o[3], r[3]) <= SPLIT3_TOL, spec
        if spec.get("domain") == "r2c":
            exact = np.fft.rfft(xr.astype(np.float64))
            e_o, e_r = rel_err(o[3], exact), rel_err(r[3], exact)
        else:
            exact = ref_fft(xr, xi)
            to_nat = (pi_layout_to_natural if spec.get("layout") == "pi"
                      else (lambda a: a))
            e_o = rel_err(to_nat(o[3]), exact)
            e_r = rel_err(to_nat(r[3]), exact)
        assert e_o <= SPLIT3_TOL and e_o <= max(e_r, 1e-6), (spec, e_o,
                                                             e_r)


# -------------------------------------------------------- the card rule


def test_the_card_rule_holds_on_every_mesh_device(monkeypatch, obs_run):
    """With every runner's planes taken to be on the card: a forced
    library rung is refused, the overload level stops at window
    collapse, a capacity fault at the serve site fails its batch with a
    structured RequestFailed while the device stays healthy, and a
    device kill still fails over with zero drops, no library rung."""
    monkeypatch.setattr(BatchRunner, "_on_card", lambda self: True)
    xr, xi = planes(seed=5)
    specs = [ShapeSpec(n=N)]

    async def main():
        cfg = mesh_cfg(devices=3, max_batch=8, max_wait_ms=5.0,
                       queue_depth=8, overload_watermark=0.8)
        async with cpu_mesh(cfg, specs) as mesh:
            for d in mesh.devices:
                assert d.runner.fallback_rungs() == ()
                assert d.runner.overload_rung() is None
            with pytest.raises(ValueError, match="CPU planes only"):
                mesh.devices[0].runner.run(GroupKey(n=N), [(xr, xi)],
                                           rung="torch-fft")
            q = asyncio.Queue()
            for _ in range(7):
                q.put_nowait(None)
            level = mesh._admission(GroupKey(n=N), q)
            home = mesh.router.route(GroupKey(n=N), record=False)
            with resilience.inject("serve", "capacity", count=1):
                failed = await asyncio.gather(
                    mesh.submit(xr, xi), return_exceptions=True)
            state_after_capacity = home.state
            with resilience.inject(home.site, "permanent", count=1):
                moved = await asyncio.gather(
                    *[mesh.submit(xr, xi) for _ in range(4)])
            return level, failed, state_after_capacity, home, moved

    level, failed, state, home, moved = run_async(main())
    assert level == (0.0, None, "overload:window")
    assert all(isinstance(e, RequestFailed) for e in failed), failed
    assert failed[0].to_record()["kind"] == "capacity"
    assert state == "healthy"
    assert len(moved) == 4
    assert all(r.plan_variant == "rows" for r in moved)
    assert any(f"failover:{home.id}" in r.degrade for r in moved)
    for r in moved:
        assert close(r, xr, xi)


def test_mesh_device_tag_flows_into_plan_keys():
    """A gpu-tagged device resolves gpu-backend plans, a cuda-tagged one
    the port's kernels; a re-route across tags adds
    failover:backend:<tag> to the trail."""
    xr, xi = planes(n=N, seed=9)

    async def main():
        cfg = mesh_cfg(devices=2, backends=("gpu", "cuda"),
                       max_wait_ms=1.0)
        async with cpu_mesh(cfg) as mesh:
            first = await mesh.submit(xr, xi)
            dev0 = mesh.devices[0]
            with resilience.inject(dev0.site, "permanent", count=1):
                moved = await mesh.submit(xr, xi)
            return first, moved

    first, moved = run_async(main())
    assert first.device == "vdev0"
    assert moved.device == "vdev1"
    assert moved.degrade == ["failover:vdev0", "failover:backend:cuda"]
    assert close(first, xr, xi) and close(moved, xr, xi)
    assert isinstance(MeshDevice(0, device=CPU).runner, BatchRunner)
