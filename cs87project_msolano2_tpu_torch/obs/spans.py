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

Inside a CUDA graph capture (the race's and ``loop_slope_ms``'s timer)
a span runs once per capture, never per replay, and must not
synchronize: ``sync=`` there raises after the span unwinds.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Optional


def clock() -> float:
    """THE sanctioned monotonic clock (seconds).  For progress/ETA
    arithmetic and span timestamps — never for device measurement
    (that is ``utils.timing``'s job; see the module docstring)."""
    return time.perf_counter()


_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NoopSpan:
    """The disabled path: one shared instance, no state, no work."""

    __slots__ = ()
    dur_s = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self

    def set_links(self, links):
        return self


NOOP_SPAN = _NoopSpan()


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
    for dev in devices:
        torch.cuda.synchronize(dev)


class Span:
    """One live span.  Use via :func:`span`; on exit the finished
    record goes to :func:`events.record_span` (buffer + event stream).
    """

    __slots__ = ("name", "cell", "args", "annotate", "sync",
                 "t0", "dur_s", "_parent", "_depth", "_ann", "_nvtx",
                 "links", "sid", "trace_id")

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
        self._parent = None
        self._depth = 0
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
        stack = _stack()
        if stack:
            self._parent = stack[-1].name
            self._depth = stack[-1]._depth + 1
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
        self.dur_s = clock() - self.t0
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        from . import events

        st = events._STATE
        if st is not None:
            rec = {"name": self.name, "ts_s": round(self.t0 - st.t0, 9),
                   "dur_s": round(self.dur_s, 9),
                   "tid": threading.get_ident(), "depth": self._depth}
            if self._parent:
                rec["parent"] = self._parent
            if self.cell:
                rec["cell"] = dict(self.cell)
            if self.args:
                rec["args"] = dict(self.args)
            if self.links:
                rec["links"] = list(self.links)
            if self.sid:
                rec["sid"] = self.sid
            if self.trace_id:
                rec["trace"] = self.trace_id
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            elif sync_error is not None:
                rec["error"] = type(sync_error).__name__
            events.record_span(rec)
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
    in from (the Chrome exporter draws them as flow arrows)."""
    from . import events

    if events._STATE is None:
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
