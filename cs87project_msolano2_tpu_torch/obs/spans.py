"""Nested phase spans: host-side begin/end intervals with run/cell
identity, exported as Chrome trace events and mirrored into the event
stream.

This module (together with ``utils/timing.py``) is a SANCTIONED CLOCK
LAYER: it may read ``time.perf_counter`` directly; everything else in
the package routes through it.  The distinction from the timing layer
matters and is deliberate:

* ``utils/timing.py`` produces **measurements** — device numbers a row
  or a law fit may cite (CUDA events, the loop slope over a captured
  graph).
* spans produce **observability** — host-side wall intervals (launch
  time, sweep-cell wall time, ETA arithmetic) that narrate where a run
  spent its time.  CUDA launches return before the device finishes, so
  a span duration is NEVER a device measurement unless the span was
  closed over an explicit device-sync boundary (the ``sync=``
  argument: ``torch.cuda.synchronize`` of the value's device).

Spans nest per thread (a thread-local stack tracks parent/depth), cost
one flag check when observability is disabled (the disabled path
returns a shared no-op singleton — no allocation, no locks), and
pass through ``torch.profiler.record_function`` (plus an NVTX range
when a card is present) when requested, so funnel/tube/cell phases show
up NAMED in a ``torch.profiler`` trace captured around them.

A finished span is kept as a raw tuple on the recorder (:class:`Recorder`);
the event stream builds its record and its ``span`` event when it is
read or written (``events.drain``), so closing a span costs a tuple and
a deque append.  The transform path's per-call sites (``fft.call`` down
to ``kernel.launch``, ``obs.TRANSFORM_PATH``) use :func:`call_span` and
:func:`path_span`, which take a bare name.  The root, :func:`call_span`,
also records while a ``torch.profiler`` session is open with
observability off; :func:`intervals` gives those spans on the profiler's
Unix-nanosecond clock, so each host interval of a call lines up with the
device activity of the same trace.

Inside a CUDA graph capture (the race's and ``loop_slope_ms``'s timer)
a span runs once per capture, never per replay, and must not
synchronize: ``sync=`` there raises after the span unwinds.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional


def clock() -> float:
    """THE sanctioned monotonic clock (seconds).  For progress/ETA
    arithmetic and span timestamps — never for device measurement
    (that is ``utils.timing``'s job; see the module docstring)."""
    return time.perf_counter()


def anchor() -> tuple:
    """(clock(), Unix ns) read together: the pair that maps the span
    clock onto the Unix-nanosecond clock of ``torch.profiler``'s events."""
    ns0 = time.time_ns()
    t = clock()
    return t, (ns0 + time.time_ns()) // 2


#: the clock and thread id as the per-call spans read them: no call of
#: this module's own between the site and the C function
_now = time.perf_counter
_tid = threading.get_ident

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


#: spans a torch.profiler session's recorder keeps, the oldest dropped
#: first: every span of a 10 s window of the fastest streamed cell
#: (about 2,600 calls a second, at most 9 spans a call) twice over
FOLLOW_CAP = 1 << 19


class Recorder:
    """Where finished spans go while something records them: raw
    ``(name, t0, t1, depth, parent, tid, extra)`` tuples on the span
    clock, ``extra`` None or the record's optional fields, with the
    (clock, Unix ns) anchor of the recording.  `stream` is the armed
    event stream's state, which turns the tuples into its span records
    and events when it is read (``events.drain``); without one (a
    torch.profiler session's recorder) :func:`intervals` reads the
    tuples, the oldest dropped past `cap` and counted in ``lost``."""

    __slots__ = ("done", "cap", "lost", "t0", "t0_ns", "stream")

    def __init__(self, cap: int, stream=None, t0=None, t0_ns=None):
        self.done: deque = deque()
        self.cap = cap
        self.lost = 0
        self.stream = stream
        self.t0, self.t0_ns = anchor() if t0 is None else (t0, t0_ns)

    def full(self) -> None:
        """More than `cap` spans wait: the stream takes them, or the
        oldest goes."""
        if self.stream is not None:
            from . import events

            events.drain(self.stream)
        else:
            self.done.popleft()
            self.lost += 1


#: THE recording flag: None while no span records (every span site
#: returns NOOP_SPAN after reading it), else the Recorder
_REC: Optional[Recorder] = None


class _NoProfiler:
    """Stands in for ``torch.autograd.profiler`` until torch is loaded,
    then puts the module in its place."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _PROFILER
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None or not hasattr(prof, "_is_profiler_enabled"):
            return False
        _PROFILER = prof
        return prof._is_profiler_enabled


#: ``torch.autograd.profiler``, whose ``_is_profiler_enabled`` is True
#: while a torch.profiler session runs
_PROFILER = _NoProfiler()


def streaming() -> bool:
    """True while the event stream is armed: the general spans record."""
    rec = _REC
    return rec is not None and rec.stream is not None


class _NoopSpan:
    """The disabled path: one shared instance, no state, no work."""

    __slots__ = ()
    dur_s = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **args):
        return self

    def set_links(self, links):
        return self


NOOP_SPAN = _NoopSpan()


class _PathSpan:
    """A span with a bare name: the transform path's per-call sites
    (:func:`path_span`, :func:`call_span`)."""

    __slots__ = ("name", "t0", "depth", "parent", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = self.stack = _stack()
        if stack:
            top = stack[-1]
            self.parent, self.depth = top.name, top.depth + 1
        else:
            self.parent, self.depth = None, 0
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        rec = _REC
        if rec is not None:
            done = rec.done
            done.append((self.name, self.t0, t1, self.depth, self.parent,
                         _tid(), None if exc_type is None
                         else {"error": exc_type.__name__}))
            if len(done) > rec.cap:
                rec.full()
        return False


def path_span(name: str):
    """A span of one step of the transform path, named and nothing
    else: while nothing records, one global read and the shared no-op.
    It records into the armed event stream, or into a torch.profiler
    session's recorder that :func:`call_span` opened."""
    if _REC is None:
        return NOOP_SPAN
    return _PathSpan(name)


def call_span(name: str):
    """The root span of one call into the port (``fft.call``): a
    :func:`path_span` that also starts recording when a torch.profiler
    session is open and observability is off, so the profiler's trace
    and :func:`intervals` cover the same calls on one clock, and stops
    at the first call after the session closed."""
    global _REC
    rec = _REC
    if rec is None:
        if not _PROFILER._is_profiler_enabled:
            return NOOP_SPAN
        _REC = Recorder(FOLLOW_CAP)
    elif rec.stream is None and not _PROFILER._is_profiler_enabled:
        _REC = None
        return NOOP_SPAN
    return _PathSpan(name)


def intervals() -> list:
    """The finished spans of the recording, oldest first, as ``(name,
    parent, depth, tid, start_ns, end_ns)`` on the Unix-nanosecond
    clock of ``torch.profiler``'s events; [] while nothing records."""
    rec = _REC
    if rec is None:
        return []
    t0, t0_ns = rec.t0, rec.t0_ns
    if rec.stream is not None:
        from . import events

        out = []
        for r in events.span_snapshot():
            start = t0_ns + round(r["ts_s"] * 1e9)
            out.append((r["name"], r.get("parent"), r.get("depth", 0),
                        r["tid"], start, start + round(r["dur_s"] * 1e9)))
        return out
    return [(name, parent, depth, tid, t0_ns + round((s - t0) * 1e9),
             t0_ns + round((e - t0) * 1e9))
            for name, s, e, depth, parent, tid, _ in list(rec.done)]


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in `value` (a tensor or nested
    list/tuple/dict of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def sync_value(value) -> None:
    """Wait for the device work behind `value`: ``torch.cuda.synchronize``
    of each CUDA device its tensors live on (none for CPU tensors).
    Refused inside a CUDA graph capture, where a synchronize breaks the
    capture."""
    import torch

    devices = _cuda_devices(value, set())
    if not devices:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "span sync= inside a CUDA graph capture: a span in a "
            "captured body runs once per capture and must not "
            "synchronize (drop sync= on per-call spans)")
    from ..utils.timing import sync

    for dev in devices:
        sync(dev)


class Span:
    """One live span.  Use via :func:`span`; on exit the finished span
    goes to the recorder, which the event stream turns into its record
    (buffer + event stream) when it is read.
    """

    __slots__ = ("name", "cell", "args", "annotate", "sync",
                 "t0", "dur_s", "parent", "depth", "stack", "_ann",
                 "_nvtx", "links", "sid", "trace_id")

    def __init__(self, name: str, cell: Optional[dict], annotate: bool,
                 sync: Optional[Callable], args: dict,
                 links=None, sid: Optional[str] = None,
                 trace_id: Optional[str] = None):
        self.name = name
        self.cell = cell
        self.args = args
        self.annotate = annotate
        self.sync = sync
        self.t0 = None
        self.dur_s = None
        self.parent = None
        self.depth = 0
        self._ann = None
        self._nvtx = False
        #: trace-plane identity (obs/trace.py): ``links`` is the
        #: fan-in edge — span ids this span serves (the batcher's
        #: coalesced requests) — rendered as Perfetto flow arrows by
        #: the Chrome exporter; ``sid``/``trace_id`` let other spans
        #: link to THIS one
        self.links = list(links) if links else None
        self.sid = sid
        self.trace_id = trace_id

    def set(self, **args):
        """Attach/overwrite span attributes mid-flight (they land in
        the record's ``args``)."""
        self.args.update(args)
        return self

    def set_links(self, links):
        """Attach/replace the fan-in link ids mid-flight."""
        self.links = list(links) if links else None
        return self

    def __enter__(self):
        stack = self.stack = _stack()
        if stack:
            self.parent = stack[-1].name
            self.depth = stack[-1].depth + 1
        stack.append(self)
        if self.annotate:
            import torch

            try:
                ann = torch.profiler.record_function(self.name)
                ann.__enter__()
                self._ann = ann
            except RuntimeError:
                # profiler machinery unavailable: the span itself still
                # records — annotation is strictly additive
                self._ann = None
            # a CPU-only build raises on torch.cuda.nvtx
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        self.t0 = clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        sync_error = None
        if self.sync is not None:
            # explicit device-sync boundary: close over the value so the
            # interval covers device completion.  A sync failure is
            # CAPTURED, never raised here: the cleanup below (annotation
            # exit, stack pop, span record) must always run or every
            # later span on this thread mis-nests — the error re-raises
            # after cleanup instead.
            try:
                sync_value(self.sync() if callable(self.sync)
                           else self.sync)
            except Exception as e:
                sync_error = e
        t1 = clock()
        self.dur_s = t1 - self.t0
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        rec = _REC
        if rec is not None and rec.stream is not None:
            extra = {}
            if self.cell:
                extra["cell"] = dict(self.cell)
            if self.args:
                extra["args"] = dict(self.args)
            if self.links:
                extra["links"] = list(self.links)
            if self.sid:
                extra["sid"] = self.sid
            if self.trace_id:
                extra["trace"] = self.trace_id
            if exc_type is not None:
                extra["error"] = exc_type.__name__
            elif sync_error is not None:
                extra["error"] = type(sync_error).__name__
            rec.done.append((self.name, self.t0, t1, self.depth,
                             self.parent, threading.get_ident(),
                             extra or None))
            if len(rec.done) > rec.cap:
                rec.full()
        if sync_error is not None and exc_type is None:
            raise sync_error
        # already unwinding: the body's original exception wins
        return False


def span(name: str, cell: Optional[dict] = None, annotate: bool = False,
         sync: Optional[Callable] = None, links=None,
         sid: Optional[str] = None, trace_id: Optional[str] = None,
         **args):
    """A phase span context manager.

        with span("tube", cell={"n": n, "p": p}):
            ...

    When observability is disabled this returns the shared no-op
    singleton — a true no-op (no locks, no allocation).  `annotate=True`
    additionally enters ``torch.profiler.record_function(name)`` (and an
    NVTX range on a card) so the phase is named in a profiler trace;
    `sync` (a tensor, a nested list/tuple/dict of them, or a callable
    returning one) closes the span over a synchronize of their CUDA
    devices.  `links`/`sid`/`trace_id` are the trace-plane identity
    fields (obs/trace.py): ``links`` records the span ids this span fans
    in from (the Chrome exporter draws them as flow arrows).  A site on
    a per-call path that passes a `cell` or attributes builds them only
    where :func:`streaming` holds."""
    rec = _REC
    if rec is None or rec.stream is None:
        return NOOP_SPAN
    return Span(name, cell, annotate, sync, args, links=links,
                sid=sid, trace_id=trace_id)


def traced(name: Optional[str] = None, annotate: bool = False):
    """Decorator form: ``@traced("phase")`` wraps every call of the
    function in a span (no-op while observability is disabled)."""

    def deco(fn: Callable) -> Callable:
        label = name or getattr(fn, "__name__", "span")

        @functools.wraps(fn)
        def run(*a, **kw):
            with span(label, annotate=annotate):
                return fn(*a, **kw)

        return run

    return deco


def current_depth() -> int:
    """Nesting depth of the calling thread's open spans (0 = none) —
    test/diagnostic helper."""
    return len(_stack())
