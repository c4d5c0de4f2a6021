"""Canary plan rollout: shadow re-race → statistical promotion →
crash-safe epoch → automatic rollback (the reference's
``fleet/canary.py``).

When drift flags a plan, the fleet does NOT trust the tuned-cost table
— it re-measures.  The racer designates one healthy mesh device as the
CANARY (``Router.set_canary``: production traffic stops landing there,
the device stays healthy and keeps draining), then re-runs the autotune
ladder race with MIRRORED traffic — real request planes captured by
:class:`TrafficMirror`, executed shadow-side on the canary device,
results never served.

Promotion is gated by :func:`~..analyze.regress.live_improved`: the
candidate's shadow samples must beat the DRIFTED LIVE population on a
one-sided Mann-Whitney at fleet alpha, not merely look faster on a
median.  An accepted winner is journaled as a promotion EPOCH
(:class:`~..resilience.journal.Journal` — fsynced before the store
write, so a crash mid-promotion is visible on restart) and only then
written to the shared plan cache under the store lock.

Rollback is first-class, not an error path: a fault at the ``promote``
site, or a post-promotion scan showing live p99 never recovered,
restores the on-disk store BYTE-IDENTICALLY from the pre-race snapshot,
re-memoizes the prior plan, and records the demotion with the same
tag discipline the degradation chain uses (``degraded`` flag +
demotion record + ``pifft_fleet_rollback_total`` + schema'd
``fleet_rollback`` event).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Optional

import numpy as np

from ..analyze import regress
from ..obs import events, metrics
from ..obs.spans import clock
from ..plans import autotune, cache, get_plan
from ..plans.core import Plan, PlanKey, offline_kind, warn
from ..resilience.inject import maybe_fault
from ..resilience.taxonomy import classify

__all__ = ["CanaryController", "CanaryOutcome", "TrafficMirror",
           "DEFAULT_REPS", "DEFAULT_MIRROR_DEPTH", "DEFAULT_BACKEND"]

#: shadow timing repetitions per ladder candidate
DEFAULT_REPS = 8

#: mirrored request planes retained per group (newest win: the race
#: should replay the traffic that drifted, not last hour's)
DEFAULT_MIRROR_DEPTH = 8

#: the backend tag of a canary device or key that names none: the
#: port's kernels (``plans.core.BACKENDS``; the reference's is "tpu")
DEFAULT_BACKEND = "cuda"


class TrafficMirror:
    """Newest-N copies of real request planes per group, for shadow
    replay.  Copies are taken at observe time — the originals belong
    to an in-flight request and must not be aliased."""

    def __init__(self, per_group: int = DEFAULT_MIRROR_DEPTH):
        self.per_group = per_group
        self._lock = threading.Lock()
        self._planes: dict = {}   # group label -> deque[(xr, xi)]

    def observe(self, group, xr, xi) -> None:
        pair = (np.array(xr, copy=True),
                np.array(xi, copy=True) if xi is not None
                else np.zeros_like(np.asarray(xr)))
        with self._lock:
            dq = self._planes.get(group.label())
            if dq is None:
                dq = self._planes[group.label()] = collections.deque(
                    maxlen=self.per_group)
            dq.append(pair)

    def planes(self, group) -> list:
        with self._lock:
            dq = self._planes.get(group.label())
            return list(dq) if dq else []


@dataclasses.dataclass
class CanaryOutcome:
    """Everything one race decided and everything a rollback needs to
    undo it: the pre-race store snapshot rides here so rollback can
    restore bytes without re-deriving what "before" meant."""

    token: str
    label: str
    store_path: Optional[str] = None
    snapshot: Optional[bytes] = None
    prior_plan: Optional[Plan] = None
    prior_variant: Optional[str] = None
    winner_variant: Optional[str] = None
    verdict: Optional[regress.LiveVerdict] = None
    epoch: Optional[int] = None
    plan: Optional[Plan] = None
    promoted: bool = False
    rolled_back: bool = False
    reason: str = ""

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "promoted": self.promoted,
            "rolled_back": self.rolled_back,
            "epoch": self.epoch,
            "prior_variant": self.prior_variant,
            "winner_variant": self.winner_variant,
            "verdict": (self.verdict.to_json()
                        if self.verdict is not None else None),
            "reason": self.reason,
        }


class CanaryController:
    """Race, promote, roll back.  Stateless between races except the
    journal-derived epoch counter; safe to rebuild on restart (the
    journal is the durable record)."""

    def __init__(self, mesh=None, journal=None,
                 alpha: float = regress.DEFAULT_ALPHA,
                 min_change: float = regress.REPLICATED_MIN_CHANGE,
                 reps: int = DEFAULT_REPS):
        self.mesh = mesh
        self.journal = journal
        self.alpha = alpha
        self.min_change = min_change
        self.reps = reps
        self._epoch: Optional[int] = None

    # -- canary designation -------------------------------------------

    def designate(self) -> Optional[str]:
        """Reserve the highest-index healthy device as the canary —
        only when at least one OTHER healthy device keeps serving
        (a one-device mesh shadow-races without designation rather
        than starving production)."""
        if self.mesh is None:
            return None
        router = self.mesh.router
        healthy = [d for d in router.devices if d.state == "healthy"]
        if len(healthy) < 2:
            return None
        canary = healthy[-1]
        router.set_canary(canary.id)
        return canary.id

    def release(self) -> None:
        if self.mesh is not None:
            self.mesh.router.set_canary(None)

    def race_device(self, key: PlanKey, canary_id: Optional[str] = None):
        """The torch device the shadow race runs on: the canary's, else
        the mesh's, else the key's (the CPU for an offline kind, the
        card otherwise)."""
        import torch

        if self.mesh is not None:
            if canary_id is not None:
                return self.mesh.device(canary_id).device
            return self.mesh.torch_device
        return torch.device("cpu" if offline_kind(key.device_kind)
                            else "cuda")

    # -- epochs --------------------------------------------------------

    def _next_epoch(self) -> int:
        if self._epoch is None:
            n = 0
            if self.journal is not None:
                n = sum(1 for c in self.journal.load()
                        if c.startswith("promote:"))
            self._epoch = n
        self._epoch += 1
        return self._epoch

    # -- shadow measurement -------------------------------------------

    def _shadow_planes(self, key: PlanKey, group=None,
                       mirror=None) -> list:
        """Input planes for the shadow race: mirrored request planes
        when available (shape-checked against the key), synthetic
        otherwise — a race must not fail just because the mirror is
        cold."""
        shape = key.input_shape()
        planes = []
        if mirror is not None and group is not None:
            for xr, xi in mirror.planes(group):
                if xr.shape == shape:
                    planes.append((np.asarray(xr, dtype=np.float32),
                                   np.asarray(xi, dtype=np.float32)))
        if not planes:
            rng = np.random.default_rng(0)
            planes = [(rng.standard_normal(shape).astype(np.float32),
                       rng.standard_normal(shape).astype(np.float32))]
        return planes

    def _shadow_timer(self, planes: list, samples_out: list, device):
        """An autotune timer that keeps per-call millisecond samples:
        the Mann-Whitney verdict needs the candidate's POPULATION, not
        the single time autotune's default timer reports.  Each timed
        call is what a served request pays around the executor — the
        host-to-device copy of the mirrored planes, the executor on
        `device`, the device-to-host copy that synchronizes it — since
        the verdict holds these samples against the live totals, which
        include the same copies.  One untimed call first builds and
        warms the executor."""
        import torch

        reps = self.reps

        def call(fn, xr, xi):
            # copy=True: on the CPU the executor must not see the
            # mirror's own arrays (it may write over its inputs)
            yr, yi = fn(torch.from_numpy(xr).to(device, copy=True),
                        torch.from_numpy(xi).to(device, copy=True))
            yr.cpu().numpy(), yi.cpu().numpy()

        def timer(fn, key) -> float:
            call(fn, *planes[0])           # build + warm, untimed
            ms = []
            for i in range(reps):
                xr, xi = planes[i % len(planes)]
                t0 = clock()
                call(fn, xr, xi)
                ms.append((clock() - t0) * 1e3)
            med = sorted(ms)[len(ms) // 2]
            samples_out.append((med, ms))
            return med

        return timer

    # -- the race ------------------------------------------------------

    def _abort(self, outcome: CanaryOutcome, key: PlanKey, kind: str,
               reason: str, canary_id: Optional[str]) -> CanaryOutcome:
        """Announce, count and return a race that ends before any
        promotion (promote=False)."""
        outcome.reason = reason
        metrics.inc("pifft_fleet_canary_aborted_total", kind=kind)
        events.emit("fleet_canary", cell={"n": key.n},
                    shape=outcome.label, promote=False, p_value=1.0,
                    aborted=kind, device=canary_id)
        warn(f"fleet: {reason}")
        return outcome

    def race(self, key: PlanKey, live_ms, *, group=None, mirror=None,
             candidate_samples=None, timer=None) -> CanaryOutcome:
        """One canary race for `key` against the drifted live
        population `live_ms` (milliseconds, from the drift finding).

        `candidate_samples` (with `timer`) lets tests supply the shadow
        population directly; by default the controller times the ladder
        race itself on mirrored planes."""
        token = key.token()
        label = group.label() if group is not None else token
        path = cache.store_path(key.device_kind)
        snapshot = None
        if path is not None and os.path.exists(path):
            with open(path, "rb") as fh:
                snapshot = fh.read()

        canary_id = self.designate()
        try:
            device = self.race_device(key, canary_id)
            prior = get_plan(key, device=device)
            outcome = CanaryOutcome(
                token=token, label=label, store_path=path,
                snapshot=snapshot, prior_plan=prior,
                prior_variant=prior.variant)
            try:
                maybe_fault("canary")
            except Exception as exc:
                kind = classify(exc).value
                return self._abort(
                    outcome, key, kind,
                    f"canary race aborted ({kind}): {str(exc)[:200]}",
                    canary_id)

            # BACKEND GUARD: a winner raced on one backend family is
            # meaningless on another — the variant namespaces are
            # disjoint and the timings incomparable — so a canary
            # whose device tag differs from the key's backend axis
            # REFUSES the race outright, before any timing spends a
            # cycle.  Same abort discipline as the injection probe.
            canary_backend = (getattr(self.mesh.device(canary_id),
                                      "backend", DEFAULT_BACKEND)
                              if canary_id is not None else None)
            key_backend = getattr(key, "backend", DEFAULT_BACKEND)
            if canary_backend is not None \
                    and canary_backend != key_backend:
                return self._abort(
                    outcome, key, "backend_mismatch",
                    f"canary race refused (backend_mismatch): canary "
                    f"{canary_id} is {canary_backend!r} but the key's "
                    f"backend axis is {key_backend!r} — a winner raced "
                    f"there would be promoted onto hardware it was "
                    f"never timed on", canary_id)

            samples_out: list = []
            if timer is None:
                planes = self._shadow_planes(key, group, mirror)
                timer = self._shadow_timer(planes, samples_out, device)
            try:
                candidate = autotune.tune(
                    key, force=True, timer=timer, verbose=False,
                    allow_offline=True, persist=False, device=device)
            except Exception as exc:
                kind = classify(exc).value
                cache.memoize(prior)   # the race must not leak a loser
                return self._abort(
                    outcome, key, kind,
                    f"canary race failed ({kind}): "
                    f"{type(exc).__name__}: {str(exc)[:200]}",
                    canary_id)
            outcome.winner_variant = candidate.variant

            if candidate_samples is None:
                # tune() picked the min-median candidate; recover that
                # candidate's full sample population for the verdict
                candidate_samples = (min(samples_out)[1]
                                     if samples_out else [candidate.ms])
            verdict = regress.live_improved(
                list(live_ms), list(candidate_samples),
                alpha=self.alpha, min_change=self.min_change)
            outcome.verdict = verdict
            events.emit("fleet_canary", cell={"n": key.n}, shape=label,
                        promote=verdict.significant,
                        p_value=verdict.p_value,
                        med_change=verdict.med_change,
                        variant=candidate.variant, device=canary_id)

            if not verdict.significant:
                # the shadow tune memoized its winner (persist=False
                # still updates the in-process LRU) — an unpromoted
                # candidate must not serve, so put the prior back
                cache.memoize(prior)
                outcome.reason = (f"not promoted: verdict "
                                  f"p={verdict.p_value:.3g} "
                                  f"med_change={verdict.med_change:+.3f}")
                return outcome

            epoch = self._next_epoch()
            outcome.epoch = epoch
            outcome.plan = candidate
            if self.journal is not None:
                self.journal.record(
                    f"promote:{token}:e{epoch}",
                    {"variant": candidate.variant,
                     "prior": prior.variant,
                     "p_value": verdict.p_value,
                     "med_change": verdict.med_change,
                     "epoch": epoch})
            try:
                maybe_fault("promote")
            except Exception as exc:
                self.rollback(
                    outcome, kind=classify(exc).value,
                    reason=(f"fault mid-promotion: "
                            f"{type(exc).__name__}: {str(exc)[:200]}"))
                return outcome
            cache.store(candidate, persist=True)
            if self.journal is not None:
                self.journal.record(f"promoted:{token}:e{epoch}",
                                    {"variant": candidate.variant,
                                     "epoch": epoch})
            metrics.inc("pifft_fleet_promote_total")
            events.emit("fleet_promote", cell={"n": key.n},
                        token=token, variant=candidate.variant,
                        p_value=verdict.p_value, epoch=epoch,
                        shape=label)
            warn(f"fleet: promoted {label} -> {candidate.variant} "
                 f"(epoch {epoch}, p={verdict.p_value:.2e})")
            outcome.promoted = True
            return outcome
        finally:
            if canary_id is not None:
                self.release()

    # -- rollback ------------------------------------------------------

    def rollback(self, outcome: CanaryOutcome, kind: str,
                 reason: str) -> None:
        """Demote a promotion: restore the shared store byte-for-byte
        from the pre-race snapshot, re-memoize the prior plan, and
        record the demotion with the standard tag discipline."""
        path = outcome.store_path
        if path is not None:
            try:
                if outcome.snapshot is None:
                    if os.path.exists(path):
                        os.remove(path)
                else:
                    tmp = f"{path}.tmp.rollback.{os.getpid()}"
                    with open(tmp, "wb") as fh:
                        fh.write(outcome.snapshot)
                    os.replace(tmp, path)
            except OSError as exc:
                warn(f"fleet: rollback could not restore {path}: "
                     f"{exc}")
        if outcome.prior_plan is not None:
            cache.memoize(outcome.prior_plan)
        record = {"from": outcome.winner_variant,
                  "to": outcome.prior_variant,
                  "kind": kind, "reason": reason}
        if outcome.plan is not None:
            outcome.plan.degraded = True
            outcome.plan.demotions.append(dict(record))
        if self.journal is not None and outcome.epoch is not None:
            self.journal.record(
                f"rollback:{outcome.token}:e{outcome.epoch}",
                dict(record))
        metrics.inc("pifft_fleet_rollback_total")
        events.emit("fleet_rollback", cell={"shape": outcome.label},
                    token=outcome.token, epoch=outcome.epoch,
                    **record)
        warn(f"fleet: rollback {outcome.label}: "
             f"{outcome.winner_variant} -> {outcome.prior_variant} "
             f"({kind}: {reason})")
        outcome.promoted = False
        outcome.rolled_back = True
        outcome.reason = reason
