"""Collective supervision: per-collective heartbeats, recovered-stall
accounting, and a supervised abort that turns a wedged rendezvous into
a recoverable :class:`~.taxonomy.CollectiveAborted` instead of a hang
(the reference's ``resilience/watchdog.py``).

A collective that wedges (an ``all_to_all`` whose peer never arrives)
blocks its caller inside the process group with no signal of its own.
Two layers deal with it:

* :func:`collective_watchdog` — a warn-only deadline: wrap a collective
  region and a stall past the (validated, logged) deadline prints a
  ``CollectiveTimeout`` warning while the region runs; a region that
  recovers records a ``collective_recovered`` event carrying the
  deadline-wait count.
* :func:`supervise_collective` — the supervisor: the region runs in a
  worker thread with a heartbeat armed per deadline; each expiry is
  counted, warned and recorded (straggler accounting across co-armed
  regions); past ``abort_waits`` expiries the supervisor cancels the
  region's :class:`CancellationToken` and raises
  :class:`CollectiveAborted`, which the resilient sharded entry points
  (``parallel/escape.py``) catch to re-plan onto the collective-free
  path.  Safe points: the token is checked before the region
  dispatches (after the ``collective`` injection probe) and may be
  polled by cooperative callers (``token.checkpoint()``); a worker
  already blocked inside the process group cannot be interrupted — it is
  ABANDONED (daemon thread) and its late completion, if any, is recorded
  as ``collective_late_completion``.  The process group's own timeout
  (``multihost.init_distributed``) ends such a worker in the end.

No wall clocks are read: the heartbeat counts deadline-sized waits on an
event, so "recovered after >= k x deadline" is derived from the wait
count alone.

Deadline validation: ``PIFFT_RENDEZVOUS_DEADLINE_S`` is parsed once at
arm time.  A non-numeric, non-finite or non-positive value warns and
serves the default — or, under ``strict=True``, raises ``ValueError``
at arm time.

Every region runs under a ``collective:<label>`` span; fires,
recoveries and aborts count on ``pifft_watchdog_fires_total``,
``pifft_collective_recoveries_total`` and
``pifft_collective_aborts_total`` (each by ``label``), and the
heartbeats, recoveries, abandonments and late completions are events of
the observability stream (all no-ops while it is disarmed).
"""

from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager
from typing import Callable, Optional

from ..obs import events, metrics, spans
from .inject import maybe_fault
from .taxonomy import CollectiveAborted, CollectiveTimeout

#: default rendezvous deadline, seconds
DEFAULT_RENDEZVOUS_DEADLINE_S = 60.0

#: default supervised-abort budget: how many whole deadlines a
#: supervised region may overrun before the supervisor abandons it
#: (``PIFFT_COLLECTIVE_ABORT_WAITS`` overrides)
DEFAULT_ABORT_WAITS = 2

#: the event kinds of the collective layer: the watchdog's, the
#: consensus's and the escape's (its transport demotion included)
COLLECTIVE_KINDS = frozenset((
    "collective_heartbeat", "collective_recovered", "collective_abandoned",
    "collective_timeout", "collective_late_completion", "distributed_init",
    "fallback_consensus", "device_unhealthy", "demotion",
    "collective_escape_completed"))


@contextmanager
def recorded_kinds():
    """Yield a list that, when the block ends, holds the kinds of the
    collective layer's events emitted inside it, in order: what a drill
    reports as its records.  Events are kept only while observability
    is armed, so the caller arms it (``obs.armed()``)."""
    seq0 = events._STATE.seq
    kinds: list = []
    yield kinds
    kinds.extend(r["kind"] for r in events.snapshot()
                 if r["seq"] >= seq0 and r["kind"] in COLLECTIVE_KINDS)


def _warn(msg: str) -> None:
    from ..plans.core import warn

    warn(msg)


def rendezvous_deadline_s(strict: bool = False) -> float:
    """The configured rendezvous deadline, validated at the call
    (``PIFFT_RENDEZVOUS_DEADLINE_S`` overrides the default).  A
    malformed value (non-numeric, non-finite or <= 0) warns with the raw
    and the served value, or raises ``ValueError`` under
    ``strict=True``."""
    raw = os.environ.get("PIFFT_RENDEZVOUS_DEADLINE_S", "").strip()
    if not raw:
        return DEFAULT_RENDEZVOUS_DEADLINE_S
    try:
        value = float(raw)
    except ValueError:
        value = None
    if value is not None and math.isfinite(value) and value > 0:
        return value
    msg = (f"PIFFT_RENDEZVOUS_DEADLINE_S={raw!r} is not a positive "
           f"finite number of seconds")
    if strict:
        raise ValueError(msg)
    _warn(f"{msg}; using the default {DEFAULT_RENDEZVOUS_DEADLINE_S:g}s")
    return DEFAULT_RENDEZVOUS_DEADLINE_S


def abort_waits_default() -> int:
    """The configured supervised-abort budget
    (``PIFFT_COLLECTIVE_ABORT_WAITS`` overrides the default)."""
    raw = os.environ.get("PIFFT_COLLECTIVE_ABORT_WAITS", "").strip()
    try:
        value = int(raw) if raw else DEFAULT_ABORT_WAITS
    except ValueError:
        value = 0
    if value >= 1:
        return value
    _warn(f"PIFFT_COLLECTIVE_ABORT_WAITS={raw!r} is not a positive "
          f"integer; using {DEFAULT_ABORT_WAITS}")
    return DEFAULT_ABORT_WAITS


class CancellationToken:
    """Cooperative cancellation for a supervised collective region: the
    supervisor calls :meth:`cancel` when the region overruns its abort
    budget; region code honors it at safe points by calling
    :meth:`checkpoint`, which raises :class:`CollectiveAborted` once
    cancelled.  The built-in safe point is the region's own dispatch."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: Optional[str] = None

    def cancel(self, reason: str) -> None:
        self.reason = reason
        self._event.set()

    def cancelled(self) -> bool:
        return self._event.is_set()

    def checkpoint(self, label: str = "") -> None:
        """Raise :class:`CollectiveAborted` if cancelled."""
        if self._event.is_set():
            raise CollectiveAborted(
                f"collective region {label or '<unnamed>'} cancelled "
                f"({self.reason})")


class WatchdogReport:
    """What the watchdog saw: ``fired`` deadline expiries (0 = the
    region finished inside its deadline)."""

    def __init__(self, label: str, deadline_s: float):
        self.label = label
        self.deadline_s = deadline_s
        self.fired = 0


class SupervisionReport(WatchdogReport):
    """A supervised region's accounting: deadline-wait count
    (``fired``), whether the supervisor ``aborted`` it, and whether it
    ``recovered`` (completed after overrunning at least one
    deadline)."""

    def __init__(self, label: str, deadline_s: float,
                 abort_waits: Optional[int]):
        super().__init__(label, deadline_s)
        self.abort_waits = abort_waits
        self.aborted = False
        self.recovered = False


# live supervised/watched regions: the straggler view.  A heartbeat
# names the sibling regions armed alongside this one that still wait.
_ACTIVE: dict = {}
_ACTIVE_LOCK = threading.Lock()


def _register(report: WatchdogReport) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE[id(report)] = report


def _unregister(report: WatchdogReport) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE.pop(id(report), None)


def _straggler_note(report: WatchdogReport) -> str:
    with _ACTIVE_LOCK:
        waiting = [r.label for r in _ACTIVE.values() if r is not report]
    if not waiting:
        return ""
    return f" (co-armed regions still waiting: {', '.join(waiting)})"


def active_regions() -> list:
    """Labels of the currently armed collective regions."""
    with _ACTIVE_LOCK:
        return [r.label for r in _ACTIVE.values()]


def _emit_recovered(label: str, fired: int, deadline: float) -> None:
    """A stuck-then-unstuck region: a ``collective_recovered`` record
    with its deadline-wait count, and a warn line."""
    metrics.inc("pifft_collective_recoveries_total", label=label)
    events.emit("collective_recovered", label=label, waits=fired,
                deadline_s=deadline)
    _warn(f"collective_recovered: {label} completed after >= "
          f"{fired * deadline:g}s ({fired} x {deadline:g}s deadline "
          f"waits — stuck-then-unstuck; raise "
          f"PIFFT_RENDEZVOUS_DEADLINE_S if this deadline is too twitchy)")


@contextmanager
def collective_watchdog(label: str, deadline_s: float | None = None,
                        strict: bool = False):
    """Arm a rendezvous deadline around a collective region (warn-only
    layer; :func:`supervise_collective` adds the abort).  While the
    with-block runs, a daemon thread wakes every `deadline_s` (default
    :func:`rendezvous_deadline_s`, validated here) and warns
    ``CollectiveTimeout`` naming the region.  On exit, a region that
    overran at least one deadline either raises
    :class:`CollectiveTimeout` (``strict=True``) or records
    ``collective_recovered``.  Yields the live :class:`WatchdogReport`."""
    deadline = float(deadline_s if deadline_s is not None
                     else rendezvous_deadline_s(strict=strict))
    maybe_fault("collective")
    report = WatchdogReport(label, deadline)
    done = threading.Event()

    def watch():
        while not done.wait(deadline):
            report.fired += 1
            metrics.inc("pifft_watchdog_fires_total", label=label)
            _warn(f"CollectiveTimeout: {label} still waiting after "
                  f">= {report.fired * deadline:g}s (deadline "
                  f"{deadline:g}s; PIFFT_RENDEZVOUS_DEADLINE_S "
                  f"overrides){_straggler_note(report)}")

    thread = threading.Thread(target=watch, name=f"pifft-watchdog-{label}",
                              daemon=True)
    _register(report)
    thread.start()
    try:
        # the watched region shows up named in the trace and the event
        # stream, with how many deadlines it overran
        with spans.span(f"collective:{label}", deadline_s=deadline) as sp:
            yield report
            sp.set(fired=report.fired)
    finally:
        done.set()
        thread.join(timeout=deadline + 1.0)
        _unregister(report)
    if report.fired:
        if strict:
            events.emit("collective_timeout", label=label,
                        fired=report.fired, deadline_s=deadline,
                        recovered=False)
            raise CollectiveTimeout(
                f"{label} exceeded its rendezvous deadline "
                f"({report.fired} x {deadline:g}s)")
        _emit_recovered(label, report.fired, deadline)


def supervise_collective(fn: Callable, label: str,
                         deadline_s: float | None = None,
                         abort_waits: Optional[int] = None,
                         token: Optional[CancellationToken] = None,
                         strict: bool = False):
    """Run ``fn()`` as a supervised collective region; returns
    ``(result, SupervisionReport)``.

    The region runs in a daemon worker thread while the supervisor
    counts deadline-sized waits.  Each expiry is a heartbeat: warned,
    counted (``pifft_watchdog_fires_total``) and recorded
    (``collective_heartbeat``), with the straggler note.  After
    ``abort_waits`` expiries (default :func:`abort_waits_default`) the
    region's `token` is cancelled, so a region not yet dispatched
    aborts at its safe point, and the supervisor raises
    :class:`CollectiveAborted` with the report on it
    (``exc.report``).  A worker blocked inside the process group is
    abandoned; if it completes later its result is discarded and
    ``collective_late_completion`` is recorded.  A region that completes
    after >= 1 wait records ``collective_recovered``; exceptions from
    the region propagate unchanged."""
    deadline = float(deadline_s if deadline_s is not None
                     else rendezvous_deadline_s(strict=strict))
    if abort_waits is None:
        abort_waits = abort_waits_default()
    token = token or CancellationToken()
    report = SupervisionReport(label, deadline, abort_waits)
    done = threading.Event()
    box: dict = {}

    def work():
        try:
            # the stall injection site lives inside the supervised
            # region: an injected stall delays here and the heartbeat
            # fires
            maybe_fault("collective")
            # safe point: never dispatch into a cancelled region
            token.checkpoint(label)
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["error"] = e
        finally:
            done.set()
            if "value" in box and token.cancelled():
                events.emit("collective_late_completion", label=label,
                            deadline_s=deadline)

    worker = threading.Thread(target=work,
                              name=f"pifft-collective-{label}",
                              daemon=True)
    _register(report)
    try:
        with spans.span(f"collective:{label}", deadline_s=deadline,
                        supervised=True) as sp:
            worker.start()
            while not done.wait(deadline):
                report.fired += 1
                metrics.inc("pifft_watchdog_fires_total", label=label)
                events.emit("collective_heartbeat", label=label,
                            waits=report.fired, deadline_s=deadline,
                            abort_waits=abort_waits)
                _warn(f"CollectiveTimeout: {label} still waiting after "
                      f">= {report.fired * deadline:g}s (deadline "
                      f"{deadline:g}s, abort after {abort_waits} "
                      f"waits){_straggler_note(report)}")
                if report.fired >= abort_waits:
                    report.aborted = True
                    token.cancel(f"{label} overran {report.fired} x "
                                 f"{deadline:g}s deadline waits")
                    metrics.inc("pifft_collective_aborts_total",
                                label=label)
                    events.emit("collective_abandoned", label=label,
                                waits=report.fired, deadline_s=deadline)
                    _warn(f"collective ABANDONED: {label} after "
                          f"{report.fired} x {deadline:g}s — supervisor "
                          f"aborting; the wedged worker is left behind "
                          f"(daemon) and a late completion will be "
                          f"recorded")
                    aborted = CollectiveAborted(
                        f"{label} abandoned after {report.fired} x "
                        f"{deadline:g}s deadline waits "
                        f"(abort_waits={abort_waits}; "
                        f"PIFFT_COLLECTIVE_ABORT_WAITS overrides)")
                    aborted.report = report
                    raise aborted
            sp.set(fired=report.fired, aborted=report.aborted)
    finally:
        _unregister(report)
    if "error" in box:
        raise box["error"]
    if report.fired:
        report.recovered = True
        _emit_recovered(label, report.fired, deadline)
    return box["value"], report
