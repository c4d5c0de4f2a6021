"""Structured events: the one record every observability signal becomes.

An event is a small JSON-safe dict with a fixed envelope —

    {"v": 1, "run": "<run id>", "seq": 17, "t": 0.0421,
     "kind": "span" | "warn" | "retry" | "demotion" | ...,
     "cell": {"n": 1048576, "p": 8, "variant": "fused"},   # optional
     "payload": {...}}                                      # optional

``run`` ties every signal of one process run together (a bench row, a
demotion, a plan-cache miss, and a profiler trace all carry the same
id); ``t`` is seconds since :func:`enable` on the sanctioned monotonic
clock (:mod:`.spans` owns the clock); ``seq`` is a process-wide
monotonically increasing ordinal so a merged/filtered stream can be
re-ordered exactly.

Emission is gated on ONE module-level flag read (`_STATE is None`):
when observability is disabled, :func:`emit` returns before taking any
lock or allocating anything.  When enabled, events land in a bounded
thread-safe in-process buffer and — when a sink path was given — are
appended to a JSONL file through the same atomic line writer the
resilience journal uses (:func:`resilience.journal.write_line`), so a
kill can at worst truncate the final line and the tolerant reader
(:func:`resilience.journal.load_records`) skips exactly that.
"""

from __future__ import annotations

import threading
import uuid
from collections import deque
from typing import Optional

from . import spans
from .spans import clock

#: bump when the event envelope changes incompatibly
SCHEMA_VERSION = 1

#: buffered events beyond this drop the OLDEST first (the drop count is
#: kept and surfaced by the summary — silent truncation reads as
#: "covered everything" when it didn't)
BUFFER_MAX = 65536


class _State:
    """Everything one enabled observability run owns."""

    __slots__ = ("run", "t0", "t0_ns", "seq", "lock", "buffer", "dropped",
                 "spans", "sink_path", "sink_fh", "buffer_max", "rec")

    def __init__(self, run: str, sink_path: Optional[str],
                 buffer_max: int = BUFFER_MAX):
        self.run = run
        # t0 on the span clock and on the profiler's Unix-ns clock
        self.t0, self.t0_ns = spans.anchor()
        self.seq = 0
        self.lock = threading.Lock()
        # deques with maxlen: drop-oldest stays O(1) when a long sweep
        # overruns the buffer (dropped counts track what fell off)
        self.buffer: deque = deque(maxlen=buffer_max)
        self.dropped = 0
        # finished span records (dicts), for in-process Chrome export
        self.spans: deque = deque(maxlen=buffer_max)
        self.sink_path = sink_path
        self.sink_fh = None
        self.buffer_max = buffer_max
        # where closing spans land until the stream is read (drain)
        self.rec = spans.Recorder(buffer_max, stream=self, t0=self.t0,
                                  t0_ns=self.t0_ns)


#: THE module-level enabled flag: None = disabled (every emit/span/
#: metric call is a no-op), a _State = enabled
_STATE: Optional[_State] = None


def enabled() -> bool:
    return _STATE is not None


def run_id() -> Optional[str]:
    """The current run id, or None when observability is disabled."""
    st = _STATE
    return st.run if st is not None else None


def enable(events_path: Optional[str] = None,
           run_id: Optional[str] = None,
           buffer_max: int = BUFFER_MAX,
           append: bool = False) -> str:
    """Turn observability on; returns the run id.

    `events_path` arms the JSONL sink (one atomic line per event);
    without it events stay in the in-process buffer only.  The sink
    file is TRUNCATED by default — a sink file is one run's stream,
    and leftovers from an earlier run would silently pollute every
    summary/validation of the new one; pass ``append=True`` to
    accumulate runs deliberately (the summary separates them by run
    id).  Re-enabling replaces the previous run's state (flushing its
    sink first).  Metrics are reset so counters are per-run.
    """
    global _STATE
    if _STATE is not None:
        disable()
    rid = run_id or uuid.uuid4().hex[:12]
    st = _State(rid, events_path, buffer_max)
    if events_path:
        import os

        from ..resilience.journal import open_append

        if not append:
            d = os.path.dirname(os.path.abspath(events_path))
            os.makedirs(d, exist_ok=True)
            with open(events_path, "w", encoding="utf-8"):
                pass  # truncate: this run owns the file
        st.sink_fh = open_append(events_path)
    _STATE = st
    spans._REC = st.rec
    from . import metrics

    metrics.reset()
    return rid


def disable() -> None:
    """Turn observability off (flushes and closes the sink).  The
    buffered events/spans of the finished run are discarded — export
    before disabling."""
    global _STATE
    st = _STATE
    if st is None:
        return
    drain(st)  # the closed spans reach the sink before it closes
    _STATE = None
    if spans._REC is st.rec:
        spans._REC = None
    error = None
    with st.lock:
        if st.sink_fh is not None:
            try:
                st.sink_fh.flush()
                st.sink_fh.close()
            except OSError as e:
                error = e
            st.sink_fh = None
    if error is not None:
        from ..plans.core import warn

        warn(f"obs sink close failed ({st.sink_path}): {error}")


def flush() -> None:
    """fsync the JSONL sink (events are already flushed per line; this
    adds the durability barrier a checkpoint wants)."""
    st = _STATE
    if st is None or st.sink_fh is None:
        return
    drain(st)
    import os

    error = None
    with st.lock:
        try:
            if st.sink_fh is not None:
                st.sink_fh.flush()
                os.fsync(st.sink_fh.fileno())
        except (OSError, ValueError) as e:
            error = e
    if error is not None:
        from ..plans.core import warn

        warn(f"obs sink flush failed ({st.sink_path}): {error}")


def emit(kind: str, /, cell: Optional[dict] = None, **payload):
    """Record one event; returns the record, or None when disabled.

    `cell` is the run-cell identity (``{"n":, "p":, "variant":}`` —
    any JSON-safe subset); everything else rides in ``payload``.
    `kind` is positional-only so a payload may itself carry a ``kind``
    key (the fault taxonomy's records do).
    """
    st = _STATE
    if st is None:
        return None
    return _emit(st, kind, cell, payload)


def _emit(st: _State, kind: str, cell, payload):
    drain(st)  # the spans that closed before this event come first
    return _put(st, kind, cell, payload)


def _put(st: _State, kind: str, cell, payload, t: Optional[float] = None):
    """Append one event (at span-clock time `t`, default now) to the
    buffer and the sink."""
    from ..resilience.journal import write_line

    rec = {"v": SCHEMA_VERSION, "run": st.run, "kind": str(kind),
           "t": round((clock() if t is None else t) - st.t0, 9)}
    if cell:
        rec["cell"] = dict(cell)
    if payload:
        rec["payload"] = payload
    sink_error = None
    sink_dead = False
    dropped_now = first_drop = False
    with st.lock:
        rec["seq"] = st.seq
        st.seq += 1
        if len(st.buffer) == st.buffer_max:
            st.dropped += 1  # deque maxlen evicts the oldest in O(1)
            dropped_now, first_drop = True, st.dropped == 1
        st.buffer.append(rec)
        if st.sink_fh is not None:
            try:
                # per-line flush, no per-line fsync (events are a
                # telemetry stream, not a checkpoint; obs.flush() adds
                # the fsync barrier where a caller needs one)
                write_line(st.sink_fh, rec, fsync=False)
            except TypeError as e:
                # THIS event's payload is not JSON-serializable: skip
                # it, keep the sink — one bad payload must not silence
                # the rest of the stream
                sink_error = e
            except (OSError, ValueError) as e:
                # a full disk must never kill the measurement the
                # events describe — drop the sink, keep the buffer
                st.sink_fh = None
                sink_error, sink_dead = e, True
    if dropped_now:
        # outside the lock (metrics holds its own lock; warn() emits
        # back into this stream): buffer overflow is counted on a
        # live series — silent event loss reads as "covered
        # everything" when it didn't
        from . import metrics

        metrics.inc("pifft_obs_dropped_total")
        if first_drop:
            from ..plans.core import warn

            warn(f"obs buffer overflowed (max {st.buffer_max}); "
                 f"oldest events are being dropped — the count rides "
                 f"pifft_obs_dropped_total and the summary (arm a "
                 f"JSONL sink or raise buffer_max for full streams)")
    if sink_error is not None:
        # outside the lock: warn() mirrors into this event stream
        from ..plans.core import warn

        warn(f"obs sink write failed ({st.sink_path}) for kind "
             f"{rec['kind']!r} ({type(sink_error).__name__}: "
             f"{sink_error}); "
             + ("further events buffer in-process only" if sink_dead
                else "event kept in-process only"))
    return rec


def record_span(span_rec: dict) -> None:
    """Keep a finished span's record (one built whole, as the trace
    plane's request spans are) for the in-process Chrome export and
    mirror it into the event stream."""
    st = _STATE
    if st is None:
        return
    drain(st)
    _keep_span(st, span_rec)


def _keep_span(st: _State, span_rec: dict, t: Optional[float] = None):
    with st.lock:
        st.spans.append(span_rec)  # deque maxlen: drop-oldest is O(1)
    _put(st, "span", span_rec.get("cell"),
         {k: v for k, v in span_rec.items() if k != "cell"}, t)


def drain(st: _State) -> None:
    """Turn the spans `st`'s recorder holds into span records and
    ``span`` events, in the order they closed: what each read or write
    of the stream does first.  The record is the one a span has always
    had: name, ts_s and dur_s (seconds on the span clock since enable),
    tid, depth, then parent, cell, args, links, sid, trace and error
    where set."""
    done = st.rec.done
    while done:
        try:
            name, t0, t1, depth, parent, tid, extra = done.popleft()
        except IndexError:  # another thread took the last one
            break
        rec = {"name": name, "ts_s": round(t0 - st.t0, 9),
               "dur_s": round(t1 - t0, 9), "tid": tid, "depth": depth}
        if parent:
            rec["parent"] = parent
        if extra:
            rec.update(extra)
        _keep_span(st, rec, t1)


def snapshot() -> list:
    """Copies of the buffered events (empty when disabled)."""
    st = _STATE
    if st is None:
        return []
    drain(st)
    with st.lock:
        return [dict(r) for r in st.buffer]


def span_snapshot() -> list:
    """Copies of the finished-span records (empty when disabled)."""
    st = _STATE
    if st is None:
        return []
    drain(st)
    with st.lock:
        return [dict(r) for r in st.spans]


def dropped() -> int:
    st = _STATE
    if st is None:
        return 0
    drain(st)
    return st.dropped


# ------------------------------------------------------------- schema


#: required envelope fields and their types
_REQUIRED = (("v", int), ("run", str), ("seq", int), ("kind", str),
             ("t", (int, float)))

#: per-kind required payload fields (the generic envelope is enough for
#: every other kind).  The collective-supervision kinds
#: (resilience/watchdog.py) are schema'd so the multichip smoke can
#: assert their shape, not just their presence: a recovered stall MUST
#: carry its deadline-wait count, an abandonment its wait total, a
#: consensus its epoch and verdict.
_KIND_PAYLOAD = {
    "span": ("name", "ts_s", "dur_s", "tid"),
    "metrics": ("snapshot",),
    "collective_recovered": ("label", "waits", "deadline_s"),
    "collective_heartbeat": ("label", "waits", "deadline_s"),
    "collective_abandoned": ("label", "waits", "deadline_s"),
    "fallback_consensus": ("label", "epoch", "agreed"),
    # the mesh-serving kinds (the serving layer): a placement names its
    # device and why, a device death its fault kind, a failover how
    # many requests moved, a handoff who inherited the warm cache
    "serve_placement": ("device", "shape", "reason"),
    "serve_device_failed": ("device", "kind"),
    "serve_failover": ("device", "requests"),
    "serve_handoff": ("device", "successor", "shape"),
    # the burn-rate SLO monitor (obs/slomon.py): an alert must name
    # its objective, whether it is firing or resolved, and the burn
    # pair that decided — a gate asserts the shape, not just the
    # presence
    "slo_alert": ("objective", "state", "burn"),
    # the wire front door (the serving layer): a negotiation
    # must say which dialect/version/credit window it settled on, and
    # a fallback which version the client offered vs what the server
    # supports — the wire-smoke gate asserts both shapes
    "serve_wire_negotiated": ("protocol", "version", "credits"),
    "serve_wire_fallback": ("offered", "supported"),
    # the fleet control loop (fleet/): a drift finding
    # must carry the statistical verdict that flagged it (p-value from
    # the calibrated Mann-Whitney detector, never an ad-hoc threshold),
    # a promotion its journaled epoch and the verdict that gated it, a
    # rollback the demotion-record discipline (from/to/kind/reason —
    # the same shape resilience.degrade journals), and a prewarm which
    # group the arrival model predicted hot
    "fleet_drift": ("shape", "p_value", "live_p99_ms", "baseline_p99_ms"),
    "fleet_canary": ("shape", "promote", "p_value"),
    "fleet_promote": ("token", "variant", "p_value", "epoch"),
    "fleet_rollback": ("token", "from", "to", "kind", "reason"),
    "fleet_prewarm": ("shape", "weight"),
}


def validate_event(rec) -> list:
    """Schema-check one event record; returns a list of problems
    (empty = valid).  This is what ``obs validate`` runs over every
    emitted event."""
    problems = []
    if not isinstance(rec, dict):
        return [f"event is {type(rec).__name__}, not an object"]
    for field, typ in _REQUIRED:
        if field not in rec:
            problems.append(f"missing required field {field!r}")
        elif not isinstance(rec[field], typ) or isinstance(rec[field], bool):
            problems.append(
                f"field {field!r} is {type(rec[field]).__name__}")
    if rec.get("v") != SCHEMA_VERSION and isinstance(rec.get("v"), int):
        problems.append(f"schema version {rec['v']} != {SCHEMA_VERSION}")
    if isinstance(rec.get("seq"), int) and rec["seq"] < 0:
        problems.append(f"seq {rec['seq']} is negative")
    if isinstance(rec.get("kind"), str) and not rec["kind"]:
        problems.append("kind is empty")
    if "cell" in rec and not isinstance(rec["cell"], dict):
        problems.append(f"cell is {type(rec['cell']).__name__}, not an "
                        f"object")
    payload = rec.get("payload")
    if payload is not None and not isinstance(payload, dict):
        problems.append(f"payload is {type(payload).__name__}, not an "
                        f"object")
    kind = rec.get("kind")
    wanted = _KIND_PAYLOAD.get(kind)
    if wanted and isinstance(payload, dict):
        for field in wanted:
            if field not in payload:
                problems.append(f"kind {kind!r} payload missing "
                                f"{field!r}")
    elif wanted and payload is None:
        problems.append(f"kind {kind!r} requires a payload")
    return problems


def load_events(path: str) -> tuple:
    """(events, dropped_line_count) from a JSONL sink file, tolerating
    the half-written tail a kill leaves (the resilience journal's
    reader discipline)."""
    from ..resilience.journal import load_records

    return load_records(path)
