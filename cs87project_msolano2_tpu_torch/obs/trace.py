"""Trace-context propagation: one identity per request, end to end.

A p99 outlier on the mesh is only debuggable if the request's journey
— admission, router placement, queue wait, coalescing window, the
batch invocation it rode, every degrade rung and failover re-route —
can be reassembled afterwards.  This module is the Dapper-style
identity that makes that possible (the live plane):

* a :class:`TraceContext` ``(trace_id, span_id, parent_id, sampled)``
  is **minted at** ``Dispatcher.submit`` (or **adopted from** the wire
  protocol's optional ``trace`` field, so a client's own trace id
  round-trips) and rides the :class:`~..serve.dispatcher.Request`
  through placement, queueing and coalescing;
* the batcher's ONE ``serve_batch`` span records
  ``links: [request span ids]`` — the fan-in edge a per-request tree
  cannot express — and the Chrome exporter renders those links as
  flow arrows (``ph: "s"/"f"``) in Perfetto;
* at delivery the request's own **span tree** is built from the
  timestamps the dispatcher already stamps: ``queue`` (submit →
  dequeue), ``window`` (dequeue → batch execution), ``compute`` (the
  batch's kernel time), plus an instant child per degrade tag and per
  failover/handoff re-route hop — and travels back on the response,
  so the caller holds the attribution for ITS OWN latency;
* **sampling is head-based** (``PIFFT_TRACE_SAMPLE``, a fraction in
  [0, 1], default 1) with a tail upgrade: degraded, failover-tagged
  and shed requests are ALWAYS emitted — the outliers the trace plane
  exists for must never be the ones sampled away.

The OFF state is the contract, exactly like spans: with observability
disabled every :func:`mint`/:func:`ensure` returns the shared
:data:`NOOP_TRACE` singleton — no allocation, no randomness, no
contextvar write (verified by test, the no-op-span pattern extended
to trace mint).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import random
import threading
import uuid
from typing import Optional

from .spans import clock

#: head-based sampling knob: fraction of minted traces whose span
#: trees are emitted into the event stream (degraded/failover/shed
#: requests are always emitted regardless — the tail upgrade)
SAMPLE_ENV = "PIFFT_TRACE_SAMPLE"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagated identity: which trace this work belongs to
    (``trace_id``), which span IS this work (``span_id``), and which
    span caused it (``parent_id``)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    sampled: bool = True

    @property
    def live(self) -> bool:
        return bool(self.trace_id)

    def child(self) -> "TraceContext":
        """A new span under this one (same trace, same sampling)."""
        if not self.live:
            return NOOP_TRACE
        return TraceContext(self.trace_id, _new_id(8), self.span_id,
                            self.sampled)

    def to_wire(self) -> dict:
        """The wire form the protocol carries (the serving layer's protocol)."""
        rec = {"trace_id": self.trace_id, "span_id": self.span_id,
               "sampled": self.sampled}
        if self.parent_id:
            rec["parent_id"] = self.parent_id
        return rec


#: the disabled path: ONE shared instance, mint/ensure return it
#: without allocating (the no-op-span discipline)
NOOP_TRACE = TraceContext("", "", None, False)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "pifft_trace", default=None)

#: process-wide short-id source; uuid4 per id would be fine but a
#: counter-salted token keeps minting cheap on the submit hot path
_LOCK = threading.Lock()
_SALT = uuid.uuid4().hex[:8]
_SEQ = 0


def _new_id(nbytes: int) -> str:
    global _SEQ
    with _LOCK:
        _SEQ += 1
        seq = _SEQ
    return f"{_SALT}{seq:0{nbytes}x}"[-2 * nbytes:]


#: (raw env value, parsed rate) memo: mint() sits on the submit hot
#: path, so the env string is parsed (and a malformed one warned
#: about) ONCE per distinct value, not once per request
_RATE_CACHE: tuple = ("", 1.0)


def sample_rate() -> float:
    """The head-sampling fraction from ``PIFFT_TRACE_SAMPLE`` (default
    1.0; malformed values fall back to 1.0 with one warning per
    distinct value rather than silently killing the trace plane — or
    flooding the event stream with per-request warns)."""
    global _RATE_CACHE
    raw = os.environ.get(SAMPLE_ENV, "").strip()
    cached_raw, cached_rate = _RATE_CACHE
    if raw == cached_raw:
        return cached_rate
    if not raw:
        rate = 1.0
    else:
        try:
            rate = min(max(float(raw), 0.0), 1.0)
        except ValueError:
            from ..plans.core import warn

            warn(f"{SAMPLE_ENV}={raw!r} is not a number; tracing "
                 f"at 1.0")
            rate = 1.0
    _RATE_CACHE = (raw, rate)
    return rate


def current() -> Optional[TraceContext]:
    """The contextvar-carried trace of the calling context (None when
    nothing is propagating)."""
    return _CURRENT.get()


@contextlib.contextmanager
def use(ctx: TraceContext):
    """Carry `ctx` for the duration of the block (the contextvar
    form — async tasks inherit it through the event loop's context
    copy)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def mint() -> TraceContext:
    """A fresh trace rooted here — or :data:`NOOP_TRACE` when
    observability is disabled (one attribute read, nothing else)."""
    from . import events

    if events._STATE is None:
        return NOOP_TRACE
    rate = sample_rate()
    sampled = rate >= 1.0 or random.random() < rate
    return TraceContext(_new_id(16), _new_id(8), None, sampled)


def adopt(wire) -> TraceContext:
    """A server-side child of a wire-supplied trace (the protocol's
    optional ``trace`` field): the client's ``trace_id`` is kept — it
    round-trips on the response — its ``span_id`` becomes our
    ``parent_id``, and this hop gets a fresh span id.  Client-supplied
    traces are always sampled unless the field says otherwise (the
    client asked for the trace; dropping it heads-down would be a
    silent refusal).  Malformed fields mint instead of raising — a
    bad trace header must never fail the request it describes."""
    from . import events

    if events._STATE is None:
        return NOOP_TRACE
    trace_id = parent = None
    sampled = True
    if isinstance(wire, str) and wire.strip():
        parts = wire.strip().split("-")
        trace_id = parts[0] or None
        parent = parts[1] if len(parts) > 1 and parts[1] else None
    elif isinstance(wire, dict):
        tid = wire.get("trace_id")
        trace_id = tid.strip() if isinstance(tid, str) and tid.strip() \
            else None
        par = wire.get("span_id") or wire.get("parent_id")
        parent = par if isinstance(par, str) and par else None
        if isinstance(wire.get("sampled"), bool):
            sampled = wire["sampled"]
    if trace_id is None:
        return mint()
    return TraceContext(trace_id, _new_id(8), parent, sampled)


def ensure(trace=None) -> TraceContext:
    """THE submit-time entry (``Dispatcher.submit``): adopt a
    wire-supplied trace, continue a caller's in-process
    :class:`TraceContext` (or the contextvar-carried one) as a child,
    or mint fresh.  Disabled observability short-circuits to
    :data:`NOOP_TRACE` before anything else."""
    from . import events

    if events._STATE is None:
        return NOOP_TRACE
    if isinstance(trace, TraceContext):
        return trace.child() if trace.live else mint()
    if trace is not None:
        return adopt(trace)
    cur = _CURRENT.get()
    if cur is not None and cur.live:
        return cur.child()
    return mint()


# ------------------------------------------------- request span trees


def _rel(t_abs: float, st) -> float:
    return round(t_abs - st.t0, 9)


def request_span_records(trace: TraceContext, *, label: str, rid: int,
                         t_submit: float, t_dequeue: Optional[float],
                         t_exec: float, compute_s: float,
                         t_done: float, tags=(), marks=(),
                         device: Optional[str] = None,
                         cell: Optional[dict] = None,
                         error: Optional[str] = None) -> list:
    """The request's span records (root + phase children), built from
    the timestamps the dispatcher stamped.  The three phase children
    are defined so they sum EXACTLY to the SLO row's total
    (queue_wait + compute):

    * ``queue``   — submit → dequeue (the worker popped it);
    * ``window``  — dequeue → batch execution start (the coalescing
      hold; queue + window == the row's queue_wait);
    * ``compute`` — the batch outcome's kernel seconds, verbatim.

    Degrade tags and re-route marks become instant children, so a
    demotion or failover is visible IN the tree, not just the trail.
    Records are plain span payloads (``name/ts_s/dur_s/tid/sid``)
    ready for :func:`events.record_span`."""
    from . import events

    st = events._STATE
    if st is None or not trace.live:
        return []
    tid = threading.get_ident()
    t_dq = t_dequeue if t_dequeue is not None else t_exec
    root = {"name": "serve_request", "ts_s": _rel(t_submit, st),
            "dur_s": round(t_done - t_submit, 9), "tid": tid,
            "sid": trace.span_id, "trace": trace.trace_id,
            "args": {"rid": rid, "shape": label,
                     **({"device": device} if device else {})}}
    if trace.parent_id:
        root["parent_sid"] = trace.parent_id
    if cell:
        root["cell"] = dict(cell)
    if error:
        root["error"] = error
    out = [root]

    def child(name, t0, dur, **args):
        rec = {"name": name, "ts_s": _rel(t0, st),
               "dur_s": round(max(dur, 0.0), 9), "tid": tid,
               "sid": _new_id(8), "parent_sid": trace.span_id,
               "parent": "serve_request", "trace": trace.trace_id}
        if args:
            rec["args"] = args
        out.append(rec)
        return rec

    child("queue", t_submit, t_dq - t_submit)
    child("window", t_dq, t_exec - t_dq)
    child("compute", t_exec, compute_s)
    for tag in tags:
        child(f"degrade:{tag}", t_done, 0.0)
    for name, t_mark in marks:
        child(str(name), t_mark, 0.0)
    return out


def emit_request_trace(trace: TraceContext, records,
                       forced: bool = False) -> bool:
    """Emit a request's span records into the event stream iff the
    trace is head-sampled OR `forced` (degraded / failover / shed —
    the tail upgrade).  Returns whether it was emitted."""
    from . import events

    if events._STATE is None or not records:
        return False
    if not (trace.sampled or forced):
        return False
    for rec in records:
        events.record_span(dict(rec))
    return True


def wire_tree(trace: TraceContext, records, emitted: bool) -> dict:
    """The response-borne form of a request's trace: ids always, the
    span tree when it was emitted (an unsampled healthy request keeps
    its ids — correlation stays possible — without paying the tree)."""
    doc = {"trace_id": trace.trace_id, "span_id": trace.span_id,
           "sampled": bool(trace.sampled or emitted)}
    if emitted:
        doc["spans"] = [
            {"name": r["name"], "sid": r["sid"],
             "dur_ms": round(r["dur_s"] * 1e3, 4),
             **({"parent": r["parent_sid"]} if r.get("parent_sid")
                else {})}
            for r in records
        ]
    return doc


def shed_record(trace: TraceContext, *, label: str, t_submit: float,
                reason: str, priority: str = "normal") -> None:
    """A shed (admission-rejected) request still leaves a trace: one
    root span with the rejection — always emitted (shed requests are
    in the tail-upgrade class)."""
    from . import events

    st = events._STATE
    if st is None or not trace.live:
        return
    now = clock()
    rec = {"name": "serve_request", "ts_s": _rel(t_submit, st),
           "dur_s": round(now - t_submit, 9),
           "tid": threading.get_ident(), "sid": trace.span_id,
           "trace": trace.trace_id, "error": reason,
           "args": {"shape": label, "shed": True,
                    "priority": priority}}
    if trace.parent_id:
        rec["parent_sid"] = trace.parent_id
    events.record_span(rec)
