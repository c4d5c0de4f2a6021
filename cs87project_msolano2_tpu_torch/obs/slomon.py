"""Burn-rate SLO monitoring: declared objectives, multi-window
evaluation, and the teeth — a hook the dispatcher consults so
sustained error-budget burn triggers admission-time degradation
BEFORE saturation.

An :class:`Objective` declares what "meeting the SLO" means for an op
class (or a shape pattern): a p99 latency target and an **error
budget** — the fraction of requests allowed to miss the target.  The
monitor classifies every served request good/bad against its matching
objectives and evaluates the classic multi-window **burn rate**

    burn = (bad fraction in window) / error_budget

over a SHORT and a LONG window (default 5 s / 60 s).  Burn 1.0 means
the budget is being spent exactly as provisioned; sustained burn above
the threshold on BOTH windows (short = it is happening now, long = it
is not a blip) fires:

* a schema'd ``slo_alert`` event (``state: "firing"``, the burn pair,
  the objective) and its ``"resolved"`` sibling when the burn drops;
* ``pifft_slo_burn_rate{objective,window}`` gauges on every
  evaluation, so the live ``/metrics`` endpoint exposes the burn
  continuously, not just at alert edges;
* the degradation hook: :meth:`SloMonitor.forced_level` returns
  ``"window"`` (collapse the coalescing window) while an alert fires
  and ``"torch-fft"`` (skip the tuned kernel for the cheap rung, the
  degrade chain's library rung) when the burn is extreme — the
  dispatcher applies it at admission time and TAGS it (``slo:window``
  / ``slo:torch-fft``) exactly like the queue-fill ladder's own
  demotions (never silent).

Objectives load from a YAML or JSON file (``pifft serve
--slo-objectives``); with PyYAML absent the file must be JSON — the
loader says so instead of guessing.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from collections import deque
from typing import Optional

from . import events, metrics
from .spans import clock

#: the classic multi-window pair: short = firing now, long = sustained
DEFAULT_WINDOWS = (5.0, 60.0)

#: burn above this on BOTH windows fires the alert (and the window
#: collapse); 1.0 = spending the budget exactly as provisioned
DEFAULT_THRESHOLD = 1.0

#: burn above this escalates the forced level to the cheap rung —
#: the budget is being torched, not merely overspent
DEFAULT_RUNG_THRESHOLD = 4.0

#: fewer samples than this in a window is "no signal", never "alert"
MIN_WINDOW_SAMPLES = 3


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared objective: requests matching ``match`` (an fnmatch
    pattern over the op — "fft", "conv", … — or the full shape label)
    must answer under ``p99_target_ms``, with ``error_budget`` the
    allowed miss fraction."""

    name: str
    p99_target_ms: float
    error_budget: float = 0.01
    match: str = "*"

    def __post_init__(self):
        if not self.name:
            raise ValueError("objective needs a name")
        if not self.p99_target_ms > 0:
            raise ValueError(f"objective {self.name!r}: p99_target_ms "
                             f"must be > 0, got {self.p99_target_ms}")
        if not 0.0 < self.error_budget <= 1.0:
            raise ValueError(f"objective {self.name!r}: error_budget "
                             f"must be in (0, 1], got "
                             f"{self.error_budget}")

    def applies(self, op: str, label: str) -> bool:
        return fnmatch.fnmatch(op, self.match) \
            or fnmatch.fnmatch(label, self.match)

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


def load_objectives(path: str) -> tuple:
    """``(objectives, windows)`` from a YAML/JSON config file:

        {"windows": [5, 60],
         "objectives": [{"name": "fft-p99", "match": "fft",
                         "p99_target_ms": 50, "error_budget": 0.01}]}

    or a bare list of objective records.  YAML needs PyYAML; without
    it the loader names the missing dependency instead of guessing at
    the syntax."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError as e:
            raise ValueError(
                f"{path}: not JSON and PyYAML is unavailable — "
                f"write the objectives as JSON") from e
        try:
            doc = yaml.safe_load(text)
        except yaml.YAMLError as e:
            # the contract is ValueError for any unparseable file —
            # the hot-reload path keys its warn-once on it
            raise ValueError(f"{path}: neither JSON nor YAML: "
                             f"{e}") from e
    if isinstance(doc, list):
        doc = {"objectives": doc}
    if not isinstance(doc, dict) or not isinstance(
            doc.get("objectives"), list) or not doc["objectives"]:
        raise ValueError(f"{path}: want an 'objectives' list (or a "
                         f"bare list of objective records)")
    objectives = []
    for i, rec in enumerate(doc["objectives"]):
        if not isinstance(rec, dict):
            raise ValueError(f"{path}: objective {i} is "
                             f"{type(rec).__name__}, not an object")
        try:
            objectives.append(Objective(
                name=str(rec.get("name") or f"objective{i}"),
                p99_target_ms=float(rec["p99_target_ms"]),
                error_budget=float(rec.get("error_budget", 0.01)),
                match=str(rec.get("match", "*"))))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: objective {i}: {e}") from e
    windows = doc.get("windows", list(DEFAULT_WINDOWS))
    if (not isinstance(windows, (list, tuple)) or len(windows) != 2
            or not all(isinstance(w, (int, float)) and w > 0
                       for w in windows)):
        raise ValueError(f"{path}: 'windows' must be two positive "
                         f"numbers [short_s, long_s], got {windows!r}")
    return objectives, (float(windows[0]), float(windows[1]))


class SloMonitor:
    """Streaming good/bad accounting + multi-window burn evaluation
    (module docstring).  ``observe`` and ``evaluate`` are called from
    the dispatcher's delivery path — both are O(matching objectives)
    with deque pruning, cheap enough for per-batch cadence.
    MUTATION is event-loop-only by design (no lock on the hot path);
    the telemetry thread may READ the snapshot surfaces
    (:meth:`describe`, :meth:`alerting` — plain attribute/dict reads,
    GIL-atomic) but must never observe/evaluate."""

    def __init__(self, objectives, windows=DEFAULT_WINDOWS,
                 threshold: float = DEFAULT_THRESHOLD,
                 rung_threshold: float = DEFAULT_RUNG_THRESHOLD,
                 min_samples: int = MIN_WINDOW_SAMPLES):
        if not objectives:
            raise ValueError("SloMonitor needs at least one objective")
        short, long_ = float(windows[0]), float(windows[1])
        if not 0 < short <= long_:
            raise ValueError(f"windows must be 0 < short <= long, got "
                             f"{windows!r}")
        names = [o.name for o in objectives]
        dups = {n for n in names if names.count(n) > 1}
        if dups:
            # name-keyed state would silently merge their samples and
            # alert flags — two objectives judged against different
            # targets must never share one deque
            raise ValueError(f"duplicate objective name(s) "
                             f"{sorted(dups)}; names key the monitor "
                             f"state and must be unique")
        self.objectives = list(objectives)
        self.windows = (short, long_)
        self.threshold = float(threshold)
        self.rung_threshold = float(rung_threshold)
        self.min_samples = int(min_samples)
        #: per-objective (t, bad) samples, long-window retention
        self._samples: dict = {o.name: deque() for o in self.objectives}
        self._alerting: dict = {o.name: False for o in self.objectives}
        self._level: Optional[str] = None
        self._t_eval: Optional[float] = None
        # hot-reload state (:meth:`watch`): the objectives file being
        # tracked, its last-seen mtime, the warn-once latch for a bad
        # edit, and the last stat time (the mtime poll is throttled to
        # the short window so per-batch evaluation stays syscall-free)
        self._source_path: Optional[str] = None
        self._source_mtime: Optional[float] = None
        self._reload_warned = False
        self._t_stat: Optional[float] = None

    # ------------------------------------------------------ hot reload

    def watch(self, path: str) -> None:
        """Track `path` (the ``--slo-objectives`` file) for mtime
        changes: :meth:`evaluate` re-reads it when it changes, so SLO
        targets tighten in production without a restart.  A reload
        that fails to parse warns ONCE and keeps the last good set —
        a fat-fingered edit must never strip a serving session of its
        objectives."""
        self._source_path = path
        try:
            self._source_mtime = os.path.getmtime(path)
        except OSError:
            self._source_mtime = None
        self._reload_warned = False

    def maybe_reload(self, now: Optional[float] = None) -> bool:
        """Reload the watched objectives file if its mtime moved;
        returns True when a new set was installed.  Sample deques and
        alert flags survive for objectives whose NAME survives (their
        history is still valid evidence); renamed or dropped
        objectives start fresh."""
        path = self._source_path
        if path is None:
            return False
        now = clock() if now is None else now
        if self._t_stat is not None \
                and now - self._t_stat < self.windows[0]:
            return False
        self._t_stat = now
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return False  # vanished: keep serving the last good set
        if mtime == self._source_mtime:
            return False
        self._source_mtime = mtime
        from ..plans.core import warn

        try:
            objectives, windows = load_objectives(path)
            names = [o.name for o in objectives]
            dups = {n for n in names if names.count(n) > 1}
            if dups:
                raise ValueError(f"duplicate objective name(s) "
                                 f"{sorted(dups)}")
        except (OSError, ValueError) as e:
            if not self._reload_warned:
                self._reload_warned = True
                warn(f"slo objectives reload failed ({path}): {e}; "
                     f"keeping the last good set")
            return False
        self._reload_warned = False
        self.objectives = list(objectives)
        self.windows = (float(windows[0]), float(windows[1]))
        self._samples = {o.name: self._samples.get(o.name, deque())
                         for o in self.objectives}
        self._alerting = {o.name: self._alerting.get(o.name, False)
                          for o in self.objectives}
        metrics.inc("pifft_slo_reloads_total")
        events.emit("slo_reload", path=path,
                    objectives=[o.name for o in self.objectives],
                    windows=list(self.windows))
        warn(f"slo objectives reloaded from {path}: "
             f"{len(self.objectives)} objective(s), windows "
             f"{self.windows[0]:g}s/{self.windows[1]:g}s")
        return True

    # ------------------------------------------------------ ingestion

    def observe(self, op: str, label: str, total_ms: float,
                t: Optional[float] = None) -> None:
        """Classify one served request against every matching
        objective."""
        now = clock() if t is None else t
        for obj in self.objectives:
            if not obj.applies(op, label):
                continue
            dq = self._samples[obj.name]
            dq.append((now, total_ms > obj.p99_target_ms))
            self._prune(dq, now)

    def _prune(self, dq, now: float) -> None:
        horizon = now - self.windows[1]
        while dq and dq[0][0] < horizon:
            dq.popleft()

    # ----------------------------------------------------- evaluation

    def _burn(self, dq, window_s: float, now: float) -> tuple:
        """(burn_rate or None, samples) over the trailing window."""
        t0 = now - window_s
        total = bad = 0
        for t, is_bad in reversed(dq):
            if t < t0:
                break
            total += 1
            bad += is_bad
        if total < self.min_samples:
            return None, total
        return (bad / total), total

    def evaluate(self, t: Optional[float] = None) -> dict:
        """Re-evaluate every objective; publishes the burn gauges,
        fires/resolves ``slo_alert`` events on transitions, and
        refreshes the degradation level :meth:`forced_level` serves.
        Returns ``{objective: {"burn": {window: rate}, "alerting":
        bool}}``."""
        now = clock() if t is None else t
        self.maybe_reload(now)
        out = {}
        level = None
        for obj in self.objectives:
            dq = self._samples[obj.name]
            self._prune(dq, now)
            burns = {}
            rates = []
            for window_s in self.windows:
                frac, count = self._burn(dq, window_s, now)
                burn = None if frac is None else frac / obj.error_budget
                burns[f"{window_s:g}s"] = burn
                rates.append(burn)
                # a drained window publishes 0, not its last value: a
                # gauge frozen at the crisis reading after traffic
                # stops would keep a dashboard red forever
                metrics.set_gauge("pifft_slo_burn_rate",
                                  burn if burn is not None else 0.0,
                                  objective=obj.name,
                                  window=f"{window_s:g}s")
            firing = all(b is not None and b > self.threshold
                         for b in rates)
            extreme = firing and all(b > self.rung_threshold
                                     for b in rates)
            was = self._alerting[obj.name]
            if firing != was:
                self._alerting[obj.name] = firing
                state = "firing" if firing else "resolved"
                events.emit("slo_alert", objective=obj.name,
                            state=state, burn=burns,
                            target_ms=obj.p99_target_ms,
                            budget=obj.error_budget,
                            windows=list(self.windows))
                metrics.inc("pifft_slo_alerts_total",
                            objective=obj.name, state=state)
                from ..plans.core import warn

                warn(f"slo {obj.name} {state}: burn "
                     + ", ".join(f"{w}={b if b is None else round(b, 2)}"
                                 for w, b in burns.items())
                     + f" (target p99 {obj.p99_target_ms} ms, budget "
                       f"{obj.error_budget:g})")
            if extreme:
                level = "torch-fft"
            elif firing and level is None:
                level = "window"
            out[obj.name] = {"burn": burns, "alerting": firing}
        self._level = level
        self._t_eval = now
        return out

    def forced_level(self, t: Optional[float] = None) -> Optional[str]:
        """The degradation the burn currently justifies — None,
        ``"window"`` (collapse the coalescing window) or ``"torch-fft"``
        (serve the cheap rung).  The dispatcher consults this at
        admission time and tags the demotion ``slo:<level>``
        (the serving layer).

        Normally current as of the last per-batch :meth:`evaluate` —
        but a delivery-driven cadence alone would freeze a firing
        alert across an idle gap (clients back off, no batch ever
        delivers, the stale level demotes the FIRST request after
        minutes of healthy silence), so a stale evaluation is
        refreshed here, on the admission path that reads it."""
        now = clock() if t is None else t
        if self._t_eval is None or now - self._t_eval > self.windows[0]:
            self.evaluate(t=now)
        return self._level

    def alerting(self) -> dict:
        return dict(self._alerting)

    def describe(self) -> dict:
        """The /healthz surface: objectives, windows, current state."""
        return {
            "windows_s": list(self.windows),
            "threshold": self.threshold,
            "rung_threshold": self.rung_threshold,
            "forced_level": self._level,
            "objectives": [
                {**o.to_record(), "alerting": self._alerting[o.name],
                 "samples": len(self._samples[o.name])}
                for o in self.objectives
            ],
        }
