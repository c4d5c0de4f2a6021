"""Live drift detection: has a served plan's latency left the regime it
was tuned in?  (The reference's ``fleet/drift.py``.)

The evidence is the ``/slo`` sliding-window reservoir
(:meth:`~..serve.slo.LatencyStats.window_totals`) — the SAME samples the
burn-rate monitor reads, so drift and SLO alerts can never disagree
about what the fleet observed.  Totals (queue + compute, the host
copies included) are deliberate: a stalling device shows up as queue
growth on the requests BEHIND the stalled batch, which per-compute
timings would miss.

The verdict is :func:`~..analyze.regress.live_regressed` — the same
one-sided Mann-Whitney + minimum-practical-change gate the offline
regression ledger uses — never an ad-hoc threshold.  A baseline is a
raw millisecond population captured while the fleet was healthy
(:meth:`DriftDetector.capture_baseline`), refreshed whenever a canary
promotion is accepted.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..analyze import regress
from ..obs import events, metrics
from ..plans.core import warn
from ..utils.stats import percentile_or_none

__all__ = ["DriftDetector", "DriftFinding", "DEFAULT_MIN_SAMPLES",
           "DEFAULT_DRIFT_MIN_CHANGE"]

#: below this many live samples a scan stays silent for the label —
#: the MW detector is anticonservative on tiny populations and a
#: half-empty window says more about traffic than about the plan
DEFAULT_MIN_SAMPLES = 8

#: the practical-significance floor for DRIFT (vs the bench ledger's
#: 5%): live per-request latency on a shared host wobbles tens of
#: percent with load, so a drift verdict — which costs a canary race
#: and a possible promotion — demands a REGIME change, not a wobble.
#: The Mann-Whitney p-value still gates statistical significance; this
#: only sets how big a median shift is worth acting on.
DEFAULT_DRIFT_MIN_CHANGE = 0.25


@dataclasses.dataclass
class DriftFinding:
    """One label's scan result.  ``live_ms`` is kept (not just its
    summary) so the canary racer can reuse the exact drifted population
    as the baseline side of its promotion verdict."""

    label: str
    verdict: regress.LiveVerdict
    live_ms: list
    baseline_ms: list
    live_p99_ms: Optional[float]
    baseline_p99_ms: Optional[float]

    @property
    def drifted(self) -> bool:
        return self.verdict.significant

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "drifted": self.drifted,
            "verdict": self.verdict.to_json(),
            "live_p99_ms": self.live_p99_ms,
            "baseline_p99_ms": self.baseline_p99_ms,
            "samples": len(self.live_ms),
        }


class DriftDetector:
    """Scan the live latency window against healthy baselines.

    Baselines and live populations are keyed by LABEL (the
    ``GroupKey.label()`` string) with per-device reservoirs merged:
    drift asks "is this PLAN slow now", not "is this device slow" —
    device health is the mesh supervisor's job.
    """

    def __init__(self, stats, alpha: float = regress.DEFAULT_ALPHA,
                 min_change: float = DEFAULT_DRIFT_MIN_CHANGE,
                 min_samples: int = DEFAULT_MIN_SAMPLES):
        self.stats = stats
        self.alpha = alpha
        self.min_change = min_change
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._baselines: dict = {}   # label -> [total_ms, ...]

    # -- populations ---------------------------------------------------

    def _merged_live(self, window_s: Optional[float] = None) -> dict:
        """label -> live total-latency population in MILLISECONDS,
        merged across ``label@device`` reservoirs."""
        merged: dict = {}
        for wkey, totals in self.stats.window_totals(window_s).items():
            label = wkey.split("@", 1)[0]
            merged.setdefault(label, []).extend(
                t * 1e3 for t in totals)
        return merged

    # -- baselines -----------------------------------------------------

    def capture_baseline(self, window_s: Optional[float] = None,
                         labels=None) -> list:
        """Snapshot the current live window as the healthy reference.
        Call while the fleet is known-good (after warmup, after an
        accepted promotion).  Returns the labels captured."""
        live = self._merged_live(window_s)
        captured = []
        with self._lock:
            for label, ms in live.items():
                if labels is not None and label not in labels:
                    continue
                if len(ms) < self.min_samples:
                    continue
                self._baselines[label] = list(ms)
                captured.append(label)
        return captured

    def set_baseline(self, label: str, totals_ms) -> None:
        with self._lock:
            self._baselines[label] = [float(t) for t in totals_ms]

    def baselines(self) -> list:
        with self._lock:
            return sorted(self._baselines)

    # -- the scan ------------------------------------------------------

    def scan(self, window_s: Optional[float] = None) -> list:
        """One drift pass over every baselined label with enough live
        samples.  Significant findings are counted
        (``pifft_fleet_drift_total``) and emitted as schema'd
        ``fleet_drift`` events; the full finding list (drifted or not)
        is returned so callers can also assert RECOVERY."""
        live = self._merged_live(window_s)
        with self._lock:
            baselines = {k: list(v) for k, v in self._baselines.items()}
        findings = []
        for label in sorted(baselines):
            live_ms = live.get(label, [])
            if len(live_ms) < self.min_samples:
                continue
            baseline_ms = baselines[label]
            verdict = regress.live_regressed(
                baseline_ms, live_ms, alpha=self.alpha,
                min_change=self.min_change)
            finding = DriftFinding(
                label=label, verdict=verdict, live_ms=live_ms,
                baseline_ms=baseline_ms,
                live_p99_ms=percentile_or_none(live_ms, 99.0),
                baseline_p99_ms=percentile_or_none(baseline_ms, 99.0))
            findings.append(finding)
            if verdict.significant:
                metrics.inc("pifft_fleet_drift_total", shape=label)
                events.emit(
                    "fleet_drift", shape=label,
                    p_value=verdict.p_value,
                    live_p99_ms=finding.live_p99_ms,
                    baseline_p99_ms=finding.baseline_p99_ms,
                    med_change=verdict.med_change,
                    samples=list(verdict.samples))
                warn(f"fleet: drift on {label}: live p99 "
                     f"{finding.live_p99_ms:.3f} ms vs baseline "
                     f"{finding.baseline_p99_ms:.3f} ms "
                     f"(p={verdict.p_value:.2e})")
        return findings
