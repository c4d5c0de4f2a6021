"""The closed loop: wire drift detection, the canary racer and the
arrival model to one serving mesh (the reference's ``fleet/loop.py``).

    serve → observe (FleetTap) → drift scan → canary race →
    MW-gated promote → verify recovery → (rollback) → prewarm next boot

The controller owns no thread: :meth:`FleetController.step` is one
loop iteration, driven by whoever owns the cadence (the smoke drives
it between traffic phases; an operator cron would call it the same
way).  Everything it decides is journaled/evented, so a restarted
controller resumes from durable state, not memory.
"""

from __future__ import annotations

from typing import Optional

from ..analyze import regress
from ..plans.core import warn
from ..resilience.journal import Journal
from ..serve.batcher import GroupKey
from .canary import CanaryController, TrafficMirror
from .drift import DEFAULT_DRIFT_MIN_CHANGE, DriftDetector
from .prewarm import ArrivalModel, FleetTap

__all__ = ["FleetController"]


class FleetController:
    """One mesh's fleet loop.  Attaching the controller installs its
    :class:`~.prewarm.FleetTap` as ``mesh.fleet_tap`` — from then on
    every admitted request feeds the arrival model and the traffic
    mirror, and ``mesh.warm()`` consults the persisted hot set."""

    def __init__(self, mesh, journal_path: Optional[str] = None,
                 alpha: float = regress.DEFAULT_ALPHA,
                 drift_min_change: float = DEFAULT_DRIFT_MIN_CHANGE,
                 improve_min_change: float =
                 regress.REPLICATED_MIN_CHANGE,
                 window_s: Optional[float] = None,
                 model: Optional[ArrivalModel] = None):
        self.mesh = mesh
        self.window_s = window_s
        self.tap = FleetTap(model=model, mirror=TrafficMirror())
        mesh.fleet_tap = self.tap
        # asymmetric floors on purpose: flagging drift (and paying a
        # race) takes a regime change; accepting a candidate only
        # takes the ledger's replicated-change floor
        self.drift = DriftDetector(mesh.stats, alpha=alpha,
                                   min_change=drift_min_change)
        journal = Journal(journal_path) if journal_path else None
        self.canary = CanaryController(mesh, journal=journal,
                                       alpha=alpha,
                                       min_change=improve_min_change)

    # -- label -> served spec -----------------------------------------

    def _spec_for(self, label: str):
        for spec in self.mesh.specs:
            if spec.label() == label:
                return spec
        return None

    def _group_for(self, spec) -> GroupKey:
        return GroupKey(n=spec.n, layout=spec.layout,
                        precision=spec.precision, domain=spec.domain,
                        op=spec.op)

    def key_for(self, spec):
        """The PlanKey a served spec races under: its key on the mesh's
        device (the card's name, or "cpu")."""
        return spec.key(self.mesh.torch_device)

    # -- one loop iteration -------------------------------------------

    def step(self, window_s: Optional[float] = None,
             max_races: Optional[int] = None) -> dict:
        """Scan for drift, race every drifted label (bounded by
        `max_races` — a mass drift event, e.g. a host slowdown, must
        not turn into an unbounded race storm)."""
        findings = self.drift.scan(window_s or self.window_s)
        outcomes = []
        for finding in findings:
            if not finding.drifted:
                continue
            if max_races is not None and len(outcomes) >= max_races:
                warn(f"fleet: race budget ({max_races}) reached; "
                     f"{finding.label} deferred to the next step")
                continue
            spec = self._spec_for(finding.label)
            if spec is None:
                warn(f"fleet: drifted label {finding.label} has no "
                     f"served spec; skipping race")
                continue
            outcome = self.canary.race(
                self.key_for(spec), finding.live_ms,
                group=self._group_for(spec), mirror=self.tap.mirror)
            outcomes.append(outcome)
        return {"findings": findings, "outcomes": outcomes}

    # -- post-promotion watch -----------------------------------------

    def verify_recovery(self, outcome,
                        window_s: Optional[float] = None) -> bool:
        """Did the promotion actually fix the drift?  Re-scan the
        promoted label's LIVE window; still drifted → automatic
        rollback (quality demotion).  True = recovered/kept."""
        if not outcome.promoted or outcome.rolled_back:
            return not outcome.rolled_back
        findings = self.drift.scan(window_s or self.window_s)
        for finding in findings:
            if finding.label == outcome.label and finding.drifted:
                self.canary.rollback(
                    outcome, kind="quality",
                    reason="live p99 failed to recover after "
                           "promotion")
                return False
        # the promoted regime is the new healthy reference
        self.drift.capture_baseline(window_s or self.window_s,
                                    labels=[outcome.label])
        return True
