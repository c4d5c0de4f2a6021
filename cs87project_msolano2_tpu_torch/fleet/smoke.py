"""The fleet-loop acceptance drive: the whole closed loop, end-to-end
(the reference's ``fleet/smoke.py``)::

    python -m cs87project_msolano2_tpu_torch fleet smoke [--device cpu]

On the card by default; ``--device cpu`` runs the kernels' plain
versions.  Phases — every transition asserted, not just exercised:

A. PRIME + BASELINE — warm a 2-shape mesh, serve healthy shifted-free
   traffic, capture the drift baselines from the LIVE ``/slo``
   reservoir (never a bench file).
B. DRIFT — the ``shifted`` arrival process changes the mix mid-run
   while a ``device*`` stall fault slows every batch: the scan must
   flag drift with a Mann-Whitney verdict from live samples.
C. CANARY + PROMOTE — the racer shadow-races the drifted shape on the
   designated canary device over mirrored traffic; the winner must
   pass ``live_improved`` and land in the shared plan cache under a
   journaled promotion epoch; after the stall clears, live p99 must
   RECOVER (asserted against the drifted window: Mann-Whitney and p99),
   and the loop's own ``verify_recovery`` must keep or roll back the
   promotion as its verdict on that window says.
D. ROLLBACK — ``PIFFT_FAULT=promote:permanent:1.0:1`` fires between
   the journal record and the store write: the rollback must leave
   the shared plan-cache store BYTE-IDENTICAL to its pre-race state
   and emit the schema'd ``fleet_rollback`` demotion.
E. PREWARM — a drain persists the arrival model beside the plan
   cache; a RESTARTED mesh (empty shape set) must warm every
   previously-hot GroupKey from the model and serve each group's
   first request on a warm plan (no tuning event, no autotune span,
   verified against the numpy oracle).

The population is the reference's (n = 256 weighted 3, n = 512
weighted 1) on the CPU, and on the card the served row shapes of the
port's serving set: n = 4096 (the rows of BASELINE config 3) weighted
3 and n = 65536 (the largest row tile) weighted 1; the shift flips the
weights.  Served traffic runs with ``torch.fft`` refused, and the
Hopper kernel launches of the served batches are counted
(``ops.cuda_fft.launch_counts``).

Every event emitted across the run is schema-validated at the end.
Prints the findings on ``#`` lines, then a JSON summary; exit 0 only if
every assertion held, 2 when the card is asked for and there is none.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from ..analyze import regress
from ..obs import events, metrics
from ..obs.spans import clock
from ..plans import cache
from ..resilience.inject import inject
from ..serve import loadgen
from ..serve.dispatcher import QueueFull
from ..serve.mesh import MeshConfig, MeshDispatcher
from ..serve.shapes import ShapeSpec
from ..utils.stats import percentile_or_none
from .loop import FleetController
from .prewarm import ArrivalModel, model_path

RPS = 150.0
STALL_S = 0.03
WINDOW_S = 1.0
#: the event-loop lag probe's sleep, seconds
LAG_PROBE_S = 0.01

#: the served population on the CPU (the reference's): n=256 dominates
#: the healthy mix, the shift flips the weight onto n=512 (the step the
#: drift scan must see alongside the stall)
POPULATION = [
    (3.0, {"n": 256, "shifted_weight": 1.0}),
    (1.0, {"n": 512, "shifted_weight": 3.0}),
]

#: the served population on the card: the port's served row shapes
#: (BASELINE config 3's rows, and the largest row tile), the same
#: weights and shift
CARD_POPULATION = [
    (3.0, {"n": 4096, "shifted_weight": 1.0}),
    (1.0, {"n": 65536, "shifted_weight": 3.0}),
]


def population_for(device) -> list:
    return CARD_POPULATION if device.type == "cuda" else POPULATION


def _say(msg: str) -> None:
    print(f"[fleet-smoke] {msg}", file=sys.stderr, flush=True)


def _finding(msg: str) -> None:
    print(f"# fleet-smoke {msg}", flush=True)


class _Launches:
    """Hopper kernel launches of the served batches, with torch.fft
    refused while traffic runs (a served request that reached it
    raises), and each label's batches: ``served(mesh, labels)`` scopes
    one drive."""

    def __init__(self):
        self.launches: dict = {}
        self.batches: dict = {}

    @contextlib.contextmanager
    def served(self, mesh, labels):
        from ..ops import cuda_fft as cf

        def batches():
            summary = mesh.stats.summary()
            return {lb: summary.get(lb, {}).get("batches", 0)
                    for lb in labels}

        b0 = batches()
        with cf.library_fft_refused() as launched:
            yield
        for name, c in launched.items():
            self.launches[name] = self.launches.get(name, 0) + c
        for lb, b in batches().items():
            self.batches[lb] = self.batches.get(lb, 0) + b - b0[lb]

    def to_json(self) -> dict:
        return {"batches": sum(self.batches.values()),
                "batches_by_label": dict(self.batches),
                "launches": dict(self.launches)}


def _batch_launches(spec, device) -> dict:
    """{kernel: launches} of one batch of `spec` on the plan its
    requests are served by, counted alone on the card: the launches each
    served batch of that label must add."""
    import torch

    from .. import plans
    from ..ops import cuda_fft as cf

    plan = plans.plan_for((1, spec.n), layout=spec.layout,
                          precision=spec.precision, domain=spec.domain,
                          device=device, autotune=False)
    x = torch.zeros((1, spec.n), device=device)
    with cf.library_fft_refused() as launched:
        plan.fn(x, x.clone())
        torch.cuda.synchronize(device)
    return launched


def _callables(mesh) -> dict:
    """{(device, group, bucket, rung): plan id} of every callable the
    mesh's runners hold: what a served batch runs without building."""
    out = {}
    for d in mesh.devices:
        with d.runner._lock:
            items = list(d.runner._callables.items())
        for (group, bucket, rung), (_fn, plan) in items:
            out[(d.id, group.label(), bucket, rung)] = id(plan)
    return out


def _window(fleet, mesh) -> dict:
    """The live window's totals per label (samples, p50 and p99 ms) and
    each mesh device's served count: what the drift scan reads."""
    out = {}
    for label, ms in sorted(fleet.drift._merged_live(WINDOW_S).items()):
        out[label] = {"samples": len(ms),
                      "p50_ms": percentile_or_none(ms, 50.0),
                      "p99_ms": percentile_or_none(ms, 99.0)}
    horizon = clock() - WINDOW_S
    parts: dict = {}
    for key, dq in list(mesh.stats._window.items()):
        label = key.split("@", 1)[0]
        for t, q, c, _deg in list(dq):
            if t >= horizon:
                parts.setdefault(label, ([], []))
                parts[label][0].append(q * 1e3)
                parts[label][1].append(c * 1e3)
    for label, (q, c) in parts.items():
        if label in out:
            out[label]["queue_p50_ms"] = percentile_or_none(q, 50.0)
            out[label]["compute_p50_ms"] = percentile_or_none(c, 50.0)
    out["served"] = {d: row["served"]
                     for d, row in mesh.utilization().items()}
    return out


async def _drive(mesh, specs, inputs, population, process: str,
                 rps: float, duration_s: float, seed: int = 0,
                 on_shift=None) -> dict:
    """Open-loop arrivals over the population schedule (the loadgen
    ``shifted`` process under test); `on_shift` fires once at the
    schedule's shift point (the smoke arms the stall there).  Beside the
    tallies, this process's CPU seconds a second over the drive and the
    event loop's lag: how late a 10 ms sleep wakes, the delay each of a
    request's hand-offs between threads pays on this host."""
    rng = np.random.default_rng(seed)
    offsets, draws = loadgen.population_schedule(
        process, population, rps, duration_s, rng)
    t_shift = loadgen.SHIFT_AT_FRAC * duration_s
    shifted = False
    counts: dict = {"ok": 0, "rejected": 0, "failed": {}}
    lags: list = []
    running = True

    async def probe():
        while running:
            t = clock()
            await asyncio.sleep(LAG_PROBE_S)
            lags.append((clock() - t - LAG_PROBE_S) * 1e3)

    async def one(si: int):
        spec = specs[si]
        xr, xi = inputs[si]
        try:
            await mesh.submit(xr, xi, layout=spec.layout,
                              precision=spec.precision,
                              domain=spec.domain, op=spec.op)
        except QueueFull:
            counts["rejected"] += 1
            return
        except Exception as exc:
            # an open-loop driver must keep the schedule, but a failed
            # submit is still evidence — keep the per-type tally in the
            # phase summary so a broken phase is attributable
            name = type(exc).__name__
            counts["failed"][name] = counts["failed"].get(name, 0) + 1
            return
        counts["ok"] += 1

    cpu0 = sum(os.times()[:2])
    t0 = clock()
    prober = asyncio.ensure_future(probe())
    tasks = []
    for i, off in enumerate(offsets):
        if on_shift is not None and not shifted and off >= t_shift:
            on_shift()
            shifted = True
        delay = (t0 + off) - clock()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(int(draws[i]))))
    await asyncio.gather(*tasks)
    running = False
    await prober
    counts["cpu_per_s"] = (sum(os.times()[:2]) - cpu0) / (clock() - t0)
    counts["loop_lag_ms"] = {"p50": percentile_or_none(lags, 50.0),
                             "p99": percentile_or_none(lags, 99.0)}
    return counts


async def _main(tmp: str, device) -> dict:
    summary: dict = {"phases": {}, "device": str(device)}
    events_path = os.path.join(tmp, "events.jsonl")
    events.enable(events_path, run_id="fleet-smoke")
    journal_path = os.path.join(tmp, "fleet-journal.jsonl")

    population = population_for(device)
    specs = [ShapeSpec(**{k: v for k, v in rec.items()
                          if k != "shifted_weight"})
             for _w, rec in population]
    labels = [s.label() for s in specs]
    rng = np.random.default_rng(7)
    inputs = [(rng.standard_normal(s.n).astype(np.float32),
               rng.standard_normal(s.n).astype(np.float32))
              for s in specs]
    counter = _Launches()

    async def drive(process, duration_s, seed, on_shift=None):
        built = len(_callables(mesh))
        with counter.served(mesh, labels):
            counts = await _drive(mesh, specs, inputs, population,
                                  process, RPS, duration_s, seed=seed,
                                  on_shift=on_shift)
        counts["callables_built"] = len(_callables(mesh)) - built
        return counts

    config = MeshConfig(devices=4, max_batch=4, max_wait_ms=1.0,
                        queue_depth=512)
    mesh = MeshDispatcher(config, shape_specs=list(specs), device=device)
    fleet = FleetController(mesh, journal_path=journal_path,
                            window_s=WINDOW_S)

    async with mesh:
        # ---- A. prime + healthy baseline ------------------------
        _say("phase A: prime + baseline")
        for burst in (1, 2, 4):       # build every batch bucket
            for si in range(len(specs)):
                await asyncio.gather(*[
                    asyncio.ensure_future(mesh.submit(
                        inputs[si][0], inputs[si][1],
                        layout=specs[si].layout,
                        precision=specs[si].precision,
                        domain=specs[si].domain, op=specs[si].op))
                    for _ in range(burst)])
        a = await drive("uniform", 1.2, seed=1)
        window_a = _window(fleet, mesh)
        _finding(f"window A: {json.dumps(window_a)}; CPU "
                 f"{a['cpu_per_s']:.3f} s/s, loop lag "
                 f"{json.dumps(a['loop_lag_ms'])} ms, callables built "
                 f"{a['callables_built']}")
        captured = fleet.drift.capture_baseline(WINDOW_S)
        assert set(labels) <= set(captured), \
            f"baseline capture missed labels: {captured} vs {labels}"
        healthy = {f.label: f for f in fleet.drift.scan(WINDOW_S)}
        assert not any(f.drifted for f in healthy.values()), \
            "healthy traffic must not flag drift"
        summary["phases"]["A"] = {
            "traffic": a, "baselines": captured, "window": window_a,
            "baseline_p99_ms": {
                k: f.baseline_p99_ms for k, f in healthy.items()}}

        # ---- B. shifted traffic + stall => drift ----------------
        _say("phase B: shift + stall => drift scan")
        with contextlib.ExitStack() as stack:
            stall = {}

            def arm():
                stall["spec"] = stack.enter_context(
                    inject("device*", "stall", stall_s=STALL_S))

            b = await drive("shifted", 2.4, seed=2, on_shift=arm)
            assert stall.get("spec") is not None and \
                stall["spec"].fired > 0, "stall fault never fired"

            # ---- C1. race + MW-gated promotion (stall still live,
            # exactly the regime the canary exists for) ------------
            _say("phase C: canary race + promotion")
            served_before = _callables(mesh)
            t_race = clock()
            step = fleet.step(WINDOW_S, max_races=1)
            race_s = clock() - t_race
            served_after = _callables(mesh)
        drifted = [f for f in step["findings"] if f.drifted]
        assert drifted, "shifted+stalled traffic must flag drift"
        finding = drifted[0]
        assert finding.verdict.test == "mann-whitney"
        assert finding.live_p99_ms > finding.baseline_p99_ms
        _finding(f"drift on {finding.label}: p={finding.verdict.p_value:.3e}"
                 f" (alpha {fleet.drift.alpha}), live p99 "
                 f"{finding.live_p99_ms:.4f} ms vs baseline p99 "
                 f"{finding.baseline_p99_ms:.4f} ms, med_change "
                 f"{finding.verdict.med_change:+.4f}")
        assert step["outcomes"], "a drifted served label must race"
        outcome = step["outcomes"][0]
        # on the card the ladder's winner for these rows is the plan
        # already serving them: the promotion then re-stores that plan,
        # and what recovers the label is the stall's end
        same_plan = (outcome.plan is not None
                     and outcome.prior_plan is not None
                     and (outcome.plan.variant, outcome.plan.params)
                     == (outcome.prior_plan.variant,
                         outcome.prior_plan.params))
        # the mesh's runners keep the callables they built: a promotion
        # changes what the next build resolves, not what they serve
        rebuilt = sorted(str(k) for k, v in served_before.items()
                         if served_after.get(k) != v)
        _finding(f"canary on {outcome.label}: verdict p="
                 f"{outcome.verdict.p_value:.3e} med_change "
                 f"{outcome.verdict.med_change:+.4f}; prior "
                 f"{outcome.prior_variant} -> winner "
                 f"{outcome.winner_variant} (epoch {outcome.epoch}), "
                 f"the same plan {same_plan}; race {race_s:.3f} s; "
                 f"served callables replaced by it {rebuilt}, built "
                 f"during it {len(set(served_after) - set(served_before))}")
        assert outcome.promoted, \
            f"canary must promote its winner: {outcome.to_json()}"
        assert outcome.verdict.significant and \
            outcome.verdict.p_value < fleet.canary.alpha
        assert outcome.epoch == 1
        store = cache.store_path(outcome.plan.key.device_kind)
        with open(store, encoding="utf-8") as fh:
            assert outcome.token in json.load(fh)["plans"], \
                "promoted plan missing from the shared store"
        journal_cells = fleet.canary.journal.load()
        assert f"promote:{outcome.token}:e1" in journal_cells
        assert f"promoted:{outcome.token}:e1" in journal_cells
        summary["phases"]["B"] = {
            "traffic": b, "stall_fired": stall["spec"].fired,
            "drift": [f.to_json() for f in step["findings"]],
            "race_s": race_s}

        # ---- C2. stall cleared => p99 recovers ------------------
        # Recovery is held against the drifted window (the stall's
        # end).  The loop's own check, verify_recovery, holds the same
        # window against A's baseline, seconds earlier on the host's
        # clock: on a loaded host a healthy label's median moves by
        # more than the drift floor between such windows, and the loop
        # then rolls the promotion back.  Either decision must follow
        # from the verdict it read and leave the loop's state as that
        # decision says.
        c = await drive("uniform", 1.2, seed=3)
        window_c = _window(fleet, mesh)
        live_c = fleet.drift._merged_live(WINDOW_S).get(finding.label, [])
        vs_drifted = regress.live_improved(
            finding.live_ms, live_c, alpha=fleet.drift.alpha,
            min_change=fleet.drift.min_change)
        _finding(f"window C: {json.dumps(window_c)}; CPU "
                 f"{c['cpu_per_s']:.3f} s/s, loop lag "
                 f"{json.dumps(c['loop_lag_ms'])} ms, callables built "
                 f"{c['callables_built']}")
        assert vs_drifted.significant, \
            f"C must beat the drifted window: {vs_drifted.to_json()}"
        assert percentile_or_none(live_c, 99.0) < finding.live_p99_ms, \
            "p99 did not recover below the drifted p99"
        scans: list = []
        scan = fleet.drift.scan

        def recorded(window_s=None):
            scans.append(scan(window_s))
            return scans[-1]

        fleet.drift.scan = recorded
        rollbacks = metrics.counter_value("pifft_fleet_rollback_total")
        try:
            kept = fleet.verify_recovery(outcome, WINDOW_S)
        finally:
            fleet.drift.scan = scan
        vs_a = {f.label: f for f in scans[-1]}
        still = vs_a[finding.label].drifted
        live_p99 = percentile_or_none(live_c, 99.0)
        _finding(f"recovered p99 on {finding.label}: {live_p99:.4f} ms "
                 f"(drifted {finding.live_p99_ms:.4f} ms; against the "
                 f"drifted window p={vs_drifted.p_value:.3e} med_change "
                 f"{vs_drifted.med_change:+.4f}); against A's baselines "
                 + json.dumps({k: {"drifted": f.drifted,
                                   "p": f.verdict.p_value,
                                   "med_change": f.verdict.med_change}
                               for k, f in vs_a.items()})
                 + f"; the loop {'kept' if kept else 'rolled back'} "
                 f"the promotion")
        assert kept == (not still) == (not outcome.rolled_back), \
            f"verify_recovery kept={kept} on a drifted={still} window"
        if kept:
            assert outcome.promoted
            rebased = collections.Counter(
                fleet.drift._baselines[finding.label])
            assert rebased and not rebased - collections.Counter(live_c), \
                "a kept promotion makes its window the new baseline"
        else:
            assert not outcome.promoted
            assert metrics.counter_value("pifft_fleet_rollback_total") \
                == rollbacks + 1
            assert f"rollback:{outcome.token}:e1" in \
                fleet.canary.journal.load()
            restored = None
            if os.path.exists(store):
                with open(store, "rb") as fh:
                    restored = fh.read()
            assert restored == outcome.snapshot, \
                "a quality rollback must restore the pre-race store"
        summary["phases"]["C"] = {
            "traffic": c, "outcome": outcome.to_json(), "window": window_c,
            "same_plan": same_plan, "served_callables_replaced": rebuilt,
            "kept": kept, "vs_drifted": vs_drifted.to_json(),
            "vs_a": {k: f.to_json() for k, f in vs_a.items()},
            "drifted_p99_ms": finding.live_p99_ms,
            "recovered_p99_ms": live_p99}

        # ---- D. injected fault mid-promotion => rollback --------
        _say("phase D: fault mid-promotion => rollback")
        def store_bytes():
            if not os.path.exists(store):
                return b""
            with open(store, "rb") as fh:
                return fh.read()

        pre_bytes = store_bytes()
        rollbacks = metrics.counter_value("pifft_fleet_rollback_total")
        os.environ["PIFFT_FAULT"] = "promote:permanent:1.0:1"
        try:
            spec = fleet._spec_for(finding.label)
            rolled = fleet.canary.race(
                fleet.key_for(spec), finding.live_ms,
                group=fleet._group_for(spec),
                mirror=fleet.tap.mirror)
        finally:
            os.environ.pop("PIFFT_FAULT", None)
        assert rolled.rolled_back and not rolled.promoted, \
            f"promote fault must roll back: {rolled.to_json()}"
        post_bytes = store_bytes()
        assert post_bytes == pre_bytes, \
            "rollback must leave the shared store byte-identical"
        assert metrics.counter_value("pifft_fleet_rollback_total") \
            == rollbacks + 1
        assert f"rollback:{rolled.token}:e2" in \
            fleet.canary.journal.load()
        _finding(f"rollback: store {len(pre_bytes)} bytes before, "
                 f"{len(post_bytes)} after, byte-identical "
                 f"{post_bytes == pre_bytes}")
        summary["phases"]["D"] = {
            "outcome": rolled.to_json(),
            "store_bytes": len(post_bytes)}

        # ---- E1. drain persists the arrival model ---------------
        _say("phase E: drain-persisted model => restart prewarm")
        await mesh.drain_device("vdev1")
        mpath = model_path()
        assert mpath is not None and os.path.exists(mpath), \
            f"drain must persist the arrival model at {mpath}"

    # ---- E2. restart: prewarm from the persisted model ----------
    seq_restart = (events.snapshot() or [{}])[-1].get("seq", 0)
    mesh2 = MeshDispatcher(MeshConfig(devices=4, max_batch=4,
                                      max_wait_ms=1.0),
                           shape_specs=[], device=device)
    fleet2 = FleetController(mesh2, journal_path=journal_path,
                             model=ArrivalModel.load())
    async with mesh2:
        mesh2.warm()
        warmed = [s.label() for s in mesh2.specs]
        assert set(labels) <= set(warmed), \
            f"prewarm must restore the hot set: {warmed}"
        problems = []
        with counter.served(mesh2, labels):
            for si, spec in enumerate(specs):
                group = fleet2._group_for(spec)
                _dev, _why, warmth, _load = mesh2.router.choose(group)
                assert warmth >= 2, \
                    f"{group.label()} not warm anywhere after prewarm"
                xr, xi = inputs[si]
                resp = await mesh2.submit(
                    xr, xi, layout=spec.layout,
                    precision=spec.precision, domain=spec.domain,
                    op=spec.op)
                problem = loadgen.verify_response(
                    spec.n, spec.layout, spec.domain, False,
                    spec.precision, xr, xi, resp, op=spec.op)
                if problem:
                    problems.append(problem)
        assert not problems, f"restart responses wrong: {problems}"
    cold = [r for r in events.snapshot()
            if r.get("seq", 0) > seq_restart
            and (r.get("kind") == "plan_tuned"
                 or (r.get("kind") == "span"
                     and "autotune" in str(
                         (r.get("payload") or {}).get("name", ""))))]
    assert not cold, \
        f"restart must serve warm (no tuning events): {cold}"
    _finding(f"prewarmed {warmed} from {mpath}")
    summary["phases"]["E"] = {"prewarmed": warmed,
                              "model_path": mpath}

    # ---- the served batches' kernel launches --------------------
    served = counter.to_json()
    if device.type == "cuda":
        # each served batch adds its plan's launches and nothing else
        # (the 2^16 rows: tile_fft and long_range_sep; the 4096 rows:
        # tile_fft)
        per_batch = {spec.label(): _batch_launches(spec, device)
                     for spec in specs}
        want: dict = {}
        for label, kernels in per_batch.items():
            for name, c in kernels.items():
                want[name] = want.get(name, 0) \
                    + c * served["batches_by_label"][label]
        served["per_batch"] = per_batch
        served["want"] = want
    _finding(f"served {served['batches']} batches "
             f"{json.dumps(served['batches_by_label'])}, launches "
             f"{served['launches']}"
             + (f", want {served['want']} (per batch "
                f"{json.dumps(served['per_batch'])})"
                if "want" in served else ""))
    if device.type == "cuda":
        assert served["batches"] > 0 and \
            served["launches"] == served["want"], \
            f"served launches are not each batch's plan's: {served}"
    summary["served"] = served

    # ---- validate every event emitted across the run ------------
    events.flush()
    records, dropped = events.load_events(events_path)
    assert dropped == 0, f"{dropped} malformed event lines"
    bad = [(r.get("kind"), p) for r in records
           for p in events.validate_event(r)]
    assert not bad, f"schema-invalid events: {bad[:8]}"
    kinds = {r.get("kind") for r in records}
    for wanted in ("fleet_drift", "fleet_canary", "fleet_promote",
                   "fleet_rollback", "fleet_prewarm"):
        assert wanted in kinds, f"missing {wanted} event"
    summary["events"] = {"total": len(records),
                         "fleet": sorted(k for k in kinds
                                         if k.startswith("fleet_"))}
    summary["ok"] = True
    events.disable()
    return summary


def main(argv=None) -> int:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch fleet smoke",
        description="the fleet loop's gate: drift, canary race, "
                    "promotion, rollback, prewarm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    owned, prior = None, os.environ.get("PIFFT_PLAN_CACHE")
    if not prior or cache.cache_dir() is None:
        # hermetic by default: the loop IS the plan cache's feedback
        # path, so the smoke needs an ENABLED store — but promoting
        # into the operator's real store (the unset-env default) would
        # leave smoke artifacts behind.  An explicit env value is
        # respected.
        owned = tempfile.mkdtemp(prefix="pifft-fleet-cache-")
        os.environ["PIFFT_PLAN_CACHE"] = owned
    t0 = clock()
    try:
        with tempfile.TemporaryDirectory(prefix="pifft-fleet-") as tmp:
            summary = asyncio.run(_main(tmp, device))
    finally:
        if owned is not None:
            if prior is None:
                os.environ.pop("PIFFT_PLAN_CACHE", None)
            else:
                os.environ["PIFFT_PLAN_CACHE"] = prior
            shutil.rmtree(owned, ignore_errors=True)
    summary["seconds"] = round(clock() - t0, 3)
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
