"""Counters / gauges / histograms: the numeric side of observability.

A small labeled-series registry in the Prometheus data model:

    metrics.inc("pifft_plan_cache_hits_total", level="memory")
    metrics.set_gauge("pifft_roofline_util", 0.41, n="2^22")
    metrics.observe("pifft_cell_seconds", 1.7, phase="tube")

Series identity is ``name{label="value",...}`` with labels sorted, so
the snapshot doubles as the Prometheus textfile body
(:func:`export.prometheus_text`).  Every mutator is gated on the same
module-level flag as :mod:`.events`: disabled observability means one
attribute read and return — no locks, no allocation.

The stack wires these series (README, "Telemetry"): plan-cache
hits/misses (`plans/cache.py`), autotune candidate fates
(`plans/autotune.py`), retries per FaultKind (`resilience/retry.py`),
demotions per chain rung (`resilience/degrade.py`), collective-watchdog
fires (`resilience/watchdog.py`), bytes moved (`utils/roofline.py`),
and the spectral apps' ops and caches (`apps/`).
"""

from __future__ import annotations

import threading
from typing import Optional

#: Prometheus' default bucket ladder (seconds-ish scale) — fine for the
#: cell/phase durations this project observes
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

_LOCK = threading.Lock()
_COUNTERS: dict = {}
_GAUGES: dict = {}
_HISTOGRAMS: dict = {}


def escape_label_value(value) -> str:
    """A label value escaped per the Prometheus exposition format:
    backslash, double-quote and newline are the three characters the
    format reserves (in that order — escaping the escape first).  A
    shape label carrying any of them would otherwise corrupt every
    series on the same page, which is exactly the silent breakage a
    scrape never reports."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series(name: str, labels: dict) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{escape_label_value(labels[k])}"'
                    for k in sorted(labels))
    return f"{name}{{{body}}}"


def _enabled() -> bool:
    from . import events

    return events._STATE is not None


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Add `value` (default 1) to a counter series."""
    if not _enabled():
        return
    key = _series(name, labels)
    with _LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0.0) + float(value)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a gauge series to `value` (last write wins)."""
    if not _enabled():
        return
    with _LOCK:
        _GAUGES[_series(name, labels)] = float(value)


def observe(name: str, value: float,
            buckets: Optional[tuple] = None, **labels) -> None:
    """Record one observation into a histogram series (cumulative
    Prometheus buckets, plus sum and count)."""
    if not _enabled():
        return
    key = _series(name, labels)
    value = float(value)
    with _LOCK:
        h = _HISTOGRAMS.get(key)
        if h is None:
            bounds = tuple(buckets or DEFAULT_BUCKETS)
            h = _HISTOGRAMS[key] = {
                "bounds": bounds,
                "counts": [0] * (len(bounds) + 1),  # +1 for +Inf
                "sum": 0.0,
                "count": 0,
            }
        h["sum"] += value
        h["count"] += 1
        for i, bound in enumerate(h["bounds"]):
            if value <= bound:
                h["counts"][i] += 1
                break
        else:
            h["counts"][-1] += 1


def counter_value(name: str, **labels) -> float:
    """Current value of one counter series (0 when absent) — test and
    summary helper; reads are allowed even when disabled."""
    with _LOCK:
        return _COUNTERS.get(_series(name, labels), 0.0)


def snapshot() -> dict:
    """JSON-safe copy of the whole registry.

    Histograms are exported CUMULATIVE (each bucket includes all
    smaller ones, `+Inf` == count), which is the Prometheus wire
    semantic and lets the textfile exporter emit them verbatim."""
    with _LOCK:
        hists = {}
        for key, h in _HISTOGRAMS.items():
            cum, buckets = 0, {}
            for bound, c in zip(h["bounds"], h["counts"]):
                cum += c
                buckets[repr(float(bound))] = cum
            buckets["+Inf"] = h["count"]
            hists[key] = {"buckets": buckets,
                          "sum": h["sum"], "count": h["count"]}
        return {
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "histograms": hists,
        }


def reset() -> None:
    """Drop every series (called by :func:`events.enable` so counters
    are per-run, and by tests)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()
