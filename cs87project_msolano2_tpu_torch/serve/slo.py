"""SLO accounting: per-shape latency percentiles with the queue-wait /
compute split (the reference's ``serve/slo.py``).

A served request's latency is two stories: time spent WAITING
(admission, the batching window, queue depth: the dispatcher's doing)
and time spent COMPUTING (the batch it rode: the plan's doing; on the
card the host-to-device copy, the kernels and the device-to-host copy,
which synchronizes).  Every record keeps the split, and the summary
reports p50/p99 of each per shape label: the table ``serve --smoke``
prints.

Percentiles are the nearest-rank ones of ``utils/stats.py``, re-exported
here.  Beside the end-of-run summary, :class:`LatencyStats` keeps a
bounded per-key reservoir of timestamped samples over a sliding window,
so the live ``/slo`` endpoint (``obs.http``) reports p50/p99 per
(op, shape, domain, precision, device) as the server runs.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ..obs.spans import clock
from ..utils.stats import percentile_nearest_rank, percentile_or_none

__all__ = ["LatencyStats", "format_summary", "percentile",
           "percentile_or_none"]

#: re-export: the shared nearest-rank estimator (utils/stats.py)
percentile = percentile_nearest_rank

#: the live window the /slo endpoint reports over (seconds)
DEFAULT_WINDOW_S = 60.0

#: reservoir bound per label: a hot shape cannot grow the live table
#: without limit — the oldest samples age out in O(1)
WINDOW_MAX_SAMPLES = 4096


class LatencyStats:
    """Per-label accumulation of (queue_wait_s, compute_s, total_s)
    samples plus degradation/batching tallies.  Thread-safe: the
    dispatcher records from executor threads while summaries read from
    the event loop."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 window_max: int = WINDOW_MAX_SAMPLES):
        self._lock = threading.Lock()
        self._samples: dict = {}    # label -> list of sample dicts
        self._counts: dict = {}     # label -> {"requests", "batches",
        #                                       "degraded", "rejected"}
        #: the streaming reservoir behind the live /slo endpoint:
        #: window key -> deque[(t, queue_s, compute_s, degraded)]
        self.window_s = float(window_s)
        self._window_max = int(window_max)
        self._window: dict = {}

    def _bucket(self, label: str) -> dict:
        c = self._counts.get(label)
        if c is None:
            c = self._counts[label] = {"requests": 0, "batches": 0,
                                       "degraded": 0, "rejected": 0}
            self._samples[label] = []
        return c

    def record(self, label: str, queue_wait_s: float, compute_s: float,
               degraded: bool = False,
               device: Optional[str] = None) -> None:
        """One completed request.  `device` extends the live-window key
        (``label@device``) so the /slo table separates the mesh
        devices serving one shape — the per-(op, shape, domain,
        precision, device) contract of the live table."""
        now = clock()
        wkey = label if device is None else f"{label}@{device}"
        with self._lock:
            c = self._bucket(label)
            c["requests"] += 1
            if degraded:
                c["degraded"] += 1
            self._samples[label].append(
                {"queue": queue_wait_s, "compute": compute_s,
                 "total": queue_wait_s + compute_s})
            dq = self._window.get(wkey)
            if dq is None:
                dq = self._window[wkey] = deque(
                    maxlen=self._window_max)
            dq.append((now, queue_wait_s, compute_s, degraded))

    def record_batch(self, label: str) -> None:
        with self._lock:
            self._bucket(label)["batches"] += 1

    def record_rejected(self, label: str) -> None:
        with self._lock:
            self._bucket(label)["rejected"] += 1

    def summary(self) -> dict:
        """label -> row dict with counts and p50/p99 of queue, compute
        and total (ms).  Labels with zero completed samples report
        counts only."""
        out = {}
        with self._lock:
            for label, counts in self._counts.items():
                row = dict(counts)
                samples = self._samples[label]
                if samples:
                    for part in ("queue", "compute", "total"):
                        vals = [s[part] for s in samples]
                        row[f"{part}_p50_ms"] = round(
                            percentile(vals, 50) * 1e3, 4)
                        row[f"{part}_p99_ms"] = round(
                            percentile(vals, 99) * 1e3, 4)
                out[label] = row
        return out

    def window_summary(self,
                       window_s: Optional[float] = None) -> dict:
        """The LIVE table: per window key (``label`` or
        ``label@device``), counts and p50/p99 of queue/compute/total
        (ms) over the trailing `window_s` (default: the stats'
        configured window).  Keys whose window emptied report a
        zero-count row (the shape was served, just not recently) —
        the /slo endpoint's contract is the same stable schema the
        loadgen rows keep."""
        horizon = clock() - (window_s or self.window_s)
        out = {}
        with self._lock:
            for key, dq in self._window.items():
                # prune in place: aged samples never return
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                live = list(dq)
                row = {"requests": len(live),
                       "degraded": sum(1 for s in live if s[3])}
                for part, idx in (("queue", 1), ("compute", 2)):
                    vals = [s[idx] for s in live]
                    for q in (50, 99):
                        v = percentile_or_none(vals, q)
                        row[f"{part}_p{q}_ms"] = round(v * 1e3, 4) \
                            if v is not None else None
                totals = [s[1] + s[2] for s in live]
                for q in (50, 99):
                    v = percentile_or_none(totals, q)
                    row[f"total_p{q}_ms"] = round(v * 1e3, 4) \
                        if v is not None else None
                out[key] = row
        return out

    def window_totals(self, window_s: Optional[float] = None) -> dict:
        """Raw total-latency populations (seconds, queue + compute) per
        window key over the trailing window — the replicated samples
        the fleet drift detector feeds to the Mann-Whitney machinery
        (the fleet layer): the verdict runs on the latencies requests
        actually saw, not on the summarized percentiles."""
        horizon = clock() - (window_s or self.window_s)
        out = {}
        with self._lock:
            for key, dq in self._window.items():
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                out[key] = [s[1] + s[2] for s in dq]
        return out

    def retire(self, label: Optional[str] = None,
               device: Optional[str] = None) -> list:
        """Drop the live-window keys of a RETIRED group or device, so
        the /slo table stops carrying zero-count rows for shapes (or
        drained/dead mesh devices) that will never serve again.  By
        label, by device, or both; returns the removed keys.  The
        cumulative end-of-run tallies are untouched — retirement is a
        live-table statement, not history rewriting."""
        removed = []
        with self._lock:
            for key in list(self._window):
                klabel, _, kdev = key.partition("@")
                if label is not None and klabel != label:
                    continue
                if device is not None and kdev != device:
                    continue
                if label is None and device is None:
                    continue
                del self._window[key]
                removed.append(key)
        return removed


def format_summary(summary: dict) -> str:
    """The human table ``serve --smoke`` prints."""
    if not summary:
        return "serve: no requests recorded"
    cols = ("reqs", "batches", "rej", "degr", "q_p50", "q_p99",
            "c_p50", "c_p99", "tot_p99")
    lines = ["shape".ljust(28) + "  " + "  ".join(c.rjust(8) for c in cols)]
    for label in sorted(summary):
        row = summary[label]

        def ms(key):
            v = row.get(key)
            return f"{v:.3f}" if v is not None else "-"

        vals = (str(row["requests"]), str(row["batches"]),
                str(row["rejected"]), str(row["degraded"]),
                ms("queue_p50_ms"), ms("queue_p99_ms"),
                ms("compute_p50_ms"), ms("compute_p99_ms"),
                ms("total_p99_ms"))
        lines.append(label.ljust(28) + "  "
                     + "  ".join(v.rjust(8) for v in vals))
    return "\n".join(lines)
