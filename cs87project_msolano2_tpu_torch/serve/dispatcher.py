"""The asyncio dispatcher: the serving front door (the reference's
``serve/dispatcher.py``).

Concurrent callers ``await dispatcher.submit(xr, xi)``; the dispatcher
groups compatible requests (same :class:`~.batcher.GroupKey`) into
bounded per-group queues, and one worker task per group drains them into
coalesced, padded invocations through :class:`~.batcher.BatchRunner`,
one launch of the port's Hopper kernels per batch on the card.  The
contract, in order of what a front door owes its callers:

* **Backpressure, never unbounded queues.**  Each group's queue is
  bounded (``queue_depth``); an admission past the bound raises
  :class:`QueueFull`, a structured error carrying ``retry_after_ms`` (an
  EMA of the group's per-request service time times the depth ahead),
  at once.  A saturated server answers "try later"; it never grows a
  queue or hangs a caller.

* **Coalescing window.**  A worker that finds its queue non-empty
  drains up to ``max_batch`` requests with no wait; otherwise it holds
  the batch open for ``max_wait_ms``.  All serve-side waiting funnels
  through one helper (:meth:`Dispatcher._wait_for_request`, on
  ``asyncio.wait_for``): nothing in the async paths blocks.

* **Admission-time graceful degradation.**  Queue fill decides the
  mode: past ``pressure_watermark`` the batching window collapses to
  zero (``pressure:window``); past ``overload_watermark`` a batch of CPU
  planes skips the tuned plan for the cheap ``torch-fft`` rung
  (``overload:torch-fft``), while on the card, where no library rung
  serves, the level stays at window collapse (``overload:window``).
  Every level, and every fault-driven rung inside the runner, is tagged
  on each affected response (``degraded: true`` and the ``degrade``
  trail), counted and evented: never silent.  A fault no rung absorbs
  fails that batch's requests with a structured :class:`RequestFailed`
  carrying the fault kind; the next batch is served.

* **Per-request observability.**  Every response carries its queue-wait
  vs compute split; the same numbers land in ``pifft_serve_*`` metrics,
  ``serve_request`` events and the per-shape :class:`~.slo.LatencyStats`.

Each batch runs in a thread-pool executor, so the event loop keeps
admitting (and rejecting) requests mid-kernel, and the workers of
several groups launch at once (the plan cache, the buffer pools and the
runner's callable cache take their locks).
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import itertools
from typing import Optional

import numpy as np

from ..obs import events, metrics
from ..obs import trace as trace_mod
from ..obs.spans import clock
from ..resilience import classify
from ..utils.device import resolve_device
from ..utils.roofline import SPECTRAL_OPS as OPS
from . import shapes as shapes_mod
from .batcher import OVERLOAD_RUNG, BatchRunner, GroupKey
from .buffers import BufferPool
from .slo import LatencyStats

#: worker-queue shutdown sentinel
_CLOSE = object()

#: admission priority classes, weakest first.  Priorities layer on the
#: bounded-queue backpressure: each class may fill
#: its group's queue only up to its ceiling fraction of
#: ``queue_depth``, so LOW-priority load sheds FIRST as pressure
#: builds while high-priority traffic keeps its full headroom; and a
#: rejection's ``retry_after_ms`` is scaled per class, so shed
#: low-priority clients back off harder than the high-priority ones
#: the server wants back soonest.
PRIORITIES = ("low", "normal", "high")
PRIORITY_ADMIT_FILL = {"low": 0.5, "normal": 1.0, "high": 1.0}
PRIORITY_RETRY_SCALE = {"low": 4.0, "normal": 1.0, "high": 0.5}


class ServeError(Exception):
    """Base of the structured serving errors: everything a caller (or
    the wire protocol) needs rides :meth:`to_record`, never a bare
    message to parse."""

    code = "serve_error"

    def extras(self) -> dict:
        return {}

    def to_record(self) -> dict:
        return {"type": self.code, "message": str(self), **self.extras()}


class QueueFull(ServeError):
    """Admission rejected: the group's queue is at depth.  Structured
    backpressure — carries when to come back, never hangs."""

    code = "queue_full"

    def __init__(self, msg: str, retry_after_ms: float):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms

    def extras(self) -> dict:
        return {"retry_after_ms": self.retry_after_ms}


class ShapeNotServed(ServeError):
    """Strict-shape mode: the request's shape is not in the warmed
    set."""

    code = "shape_not_served"


class DispatcherClosed(ServeError):
    code = "dispatcher_closed"


class RequestFailed(ServeError):
    """The batch died of a fault no fallback rung could absorb; the
    classification rides along so the caller's retry policy can
    decide."""

    code = "request_failed"

    def __init__(self, msg: str, kind: str):
        super().__init__(msg)
        self.kind = kind

    def extras(self) -> dict:
        return {"kind": self.kind}


@dataclasses.dataclass
class ServeConfig:
    """Dispatcher knobs."""

    max_batch: int = 8           # most requests one invocation carries
    max_wait_ms: float = 2.0     # batching window under normal load
    queue_depth: int = 64        # per-group bound; beyond it: QueueFull
    pressure_watermark: float = 0.5   # fill fraction: window -> 0
    overload_watermark: float = 0.875  # fill fraction: cheap-rung mode
    strict_shapes: bool = False  # only serve the warmed shape set
    #: burn-rate SLO objectives (obs/slomon.py): a config-file path
    #: for obs.slomon.load_objectives, a
    #: ready list of Objective records, or a built SloMonitor — when
    #: set, sustained error-budget burn forces the admission ladder
    #: (window collapse, then the cheap rung on CPU planes) BEFORE the
    #: queues saturate,
    #: tagged slo:<level> like every demotion
    slo_objectives: object = None


@dataclasses.dataclass
class Request:
    rid: int
    group: GroupKey
    xr: np.ndarray
    xi: np.ndarray
    t_submit: float
    future: asyncio.Future
    #: admission class (PRIORITIES) and tenant identity — recorded on
    #: every request; the mesh dispatcher's admission acts on them
    priority: str = "normal"
    tenant: str = "default"
    #: per-REQUEST degradation trail (e.g. ``failover:<device>`` when a
    #: mesh re-routes it off a dead device) — merged into the response's
    #: degrade trail on delivery, on top of whatever the batch earned
    trail: list = dataclasses.field(default_factory=list)
    #: trace-plane identity (obs/trace.py): minted at submit or adopted
    #: from the wire; NOOP_TRACE when observability is off
    trace: trace_mod.TraceContext = trace_mod.NOOP_TRACE
    #: stamped by the worker when it pops the request — splits the SLO
    #: row's queue_wait into queue (submit->dequeue) vs window
    #: (dequeue->execution) children in the span tree
    t_dequeue: Optional[float] = None
    #: instant trace marks ((name, t) pairs): failover/handoff re-route
    #: hops land here and become children of the request span tree
    marks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Response:
    """One served transform, with its latency split and degradation
    trail."""

    rid: int
    yr: np.ndarray
    yi: np.ndarray
    queue_wait_ms: float
    compute_ms: float
    batch_size: int
    plan_variant: str
    degraded: bool = False
    degrade: list = dataclasses.field(default_factory=list)
    #: which mesh device served the batch (None on the single-device
    #: dispatcher)
    device: Optional[str] = None
    #: the request's trace (obs/trace.py): ids always when tracing is
    #: armed, the span tree (queue/window/compute + degrade/failover
    #: children) when the trace was sampled or tail-upgraded —
    #: travels the wire so the CALLER holds its own attribution
    trace: Optional[dict] = None

    def to_record(self, arrays: bool = False) -> dict:
        rec = {
            "id": self.rid, "ok": True,
            "queue_wait_ms": round(self.queue_wait_ms, 4),
            "compute_ms": round(self.compute_ms, 4),
            "batch_size": self.batch_size,
            "plan_variant": self.plan_variant,
            "degraded": self.degraded,
        }
        if self.degrade:
            rec["degrade"] = list(self.degrade)
        if self.device is not None:
            rec["device"] = self.device
        if self.trace is not None:
            rec["trace"] = self.trace
        if arrays:
            # float32-faithful serialization: squeeze through float32
            # FIRST, then widen to float64 for repr — json emits the
            # shortest decimal that round-trips the f64, and an f64
            # holding an exact f32 value recovers that f32 BIT-
            # IDENTICALLY on decode.  Both wire dialects therefore
            # deliver the same plane bytes (tests/test_wire.py).
            rec["yr"] = np.asarray(self.yr, np.float32) \
                .astype(np.float64).tolist()
            rec["yi"] = np.asarray(self.yi, np.float32) \
                .astype(np.float64).tolist()
        return rec


class Dispatcher:
    """See the module docstring; use as an async context manager:

        async with Dispatcher(config, specs) as d:
            resp = await d.submit(xr, xi)
    """

    def __init__(self, config: Optional[ServeConfig] = None,
                 shape_specs=None, device=None):
        self.config = config or ServeConfig()
        self.specs = list(shape_specs or [])
        #: where every batch runs: the card unless the caller asks for
        #: the CPU (``utils.device.resolve_device``)
        self.device = resolve_device(device)
        self.runner = BatchRunner(BufferPool(device=self.device),
                                  device=self.device)
        self.stats = LatencyStats()
        self._queues: dict = {}
        self._workers: dict = {}
        self._ema_ms: dict = {}
        self._rid = itertools.count()
        self._closing = False
        self._served = {(s.n, s.layout, s.precision, s.domain,
                         getattr(s, "op", "fft"))
                        for s in self.specs}
        self.slomon = self._build_slomon(self.config.slo_objectives)

    @staticmethod
    def _build_slomon(spec):
        """The burn-rate monitor from a config-file path, a list of
        Objective records, or a ready SloMonitor (None disables —
        no per-batch evaluation cost)."""
        if spec is None:
            return None
        from ..obs import slomon as slomon_mod

        if isinstance(spec, slomon_mod.SloMonitor):
            return spec
        if isinstance(spec, str):
            objectives, windows = slomon_mod.load_objectives(spec)
            mon = slomon_mod.SloMonitor(objectives, windows)
            # a file-backed monitor hot-reloads on mtime change, so SLO
            # targets tighten in production without a restart
            mon.watch(spec)
            return mon
        return slomon_mod.SloMonitor(list(spec))

    # ----------------------------------------------------- lifecycle

    def warm(self, force: bool = False) -> list:
        """Resolve + memoize the plan for every served shape on the
        dispatcher's device (the ``plan warm --shapes`` path): a warm
        dispatcher reaches its first response on a cache hit."""
        return shapes_mod.warm(self.specs, force=force, device=self.device)

    async def __aenter__(self):
        if self.specs:
            # warming may tune (minutes on real hardware): keep the
            # event loop free while it runs
            await asyncio.get_running_loop().run_in_executor(
                None, self.warm)
        return self

    async def __aexit__(self, *exc):
        await self.close()
        return False

    async def close(self) -> None:
        """Stop accepting, drain every queue, join the workers.
        Requests admitted before close are served (the workers keep
        draining past the shutdown sentinel until their queues are
        empty); later submits raise :class:`DispatcherClosed`.  Any
        request a racing submit still managed to slip behind an
        exiting worker gets a structured :class:`DispatcherClosed`
        rejection — a shutdown must never orphan a future."""
        self._closing = True
        for q in self._queues.values():
            q.put_nowait(_CLOSE)
        if self._workers:
            await asyncio.gather(*self._workers.values(),
                                 return_exceptions=True)
        for q in self._queues.values():
            while True:
                try:
                    item = q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if item is _CLOSE or item.future.done():
                    continue
                item.future.set_exception(DispatcherClosed(
                    "dispatcher shut down while the request was queued"))

    async def drain(self) -> None:
        """Alias for :meth:`close`: serve everything admitted, then
        stop (the name the ops runbooks use)."""
        await self.close()

    # ----------------------------------------------------- admission

    def _validated(self, xr, xi, layout: str, precision: Optional[str],
                   inverse: bool, domain: str, priority: str,
                   op: str = "fft") -> tuple:
        """Shared request validation (single-device and mesh
        dispatchers): returns ``(xr, xi, group)`` float32 planes plus
        the coalescing key, or raises a structured
        :class:`ServeError`.

        Op-tagged requests (``op`` in "conv"/"corr"/"solve") are
        REAL-input operations on the half-spectrum
        path: the planes are the op's operands (signal + kernel for
        conv/corr, the field for solve), the group is keyed
        ``domain="r2c"``, and the served semantics are CIRCULAR at
        the group's n (linear semantics pad client-side or through
        apps.fftconv)."""
        from ..plans.core import DOMAINS

        if op not in OPS:
            raise ServeError(f"op={op!r} not in {OPS}")
        if domain not in DOMAINS:
            raise ServeError(f"domain={domain!r} not in {DOMAINS}")
        if priority not in PRIORITIES:
            raise ServeError(f"priority={priority!r} not in {PRIORITIES}")
        xr = np.asarray(xr, np.float32)
        if op != "fft":
            if inverse:
                raise ServeError(f"op={op!r} has no inverse form; the "
                                 f"op already pairs its transforms")
            if layout != "natural":
                raise ServeError(f"op={op!r} requires natural layout "
                                 f"(the half-spectrum has no pi order)")
            if domain not in ("c2c", "r2c"):
                raise ServeError(f"op={op!r} rides the half-spectrum "
                                 f"forward path; domain={domain!r} "
                                 f"does not apply")
            if op in ("conv", "corr"):
                if xi is None:
                    raise ServeError(f"op={op!r} needs the kernel "
                                     f"plane in xi (signal in xr)")
            elif xi is not None and np.any(np.asarray(xi)):
                raise ServeError("op='solve' takes one real field in "
                                 "xr — a nonzero xi would be silently "
                                 "dropped; send zeros or omit it")
            xi = np.zeros_like(xr) if xi is None \
                else np.asarray(xi, np.float32)
            if xr.ndim != 1 or xr.shape != xi.shape:
                raise ServeError(f"request planes must be matching 1-D "
                                 f"arrays, got {xr.shape} / {xi.shape}")
            n = xr.shape[0]
            if n < 2 or n > shapes_mod.MAX_SERVED_N:
                # ANY length in range is a plan: refusal is for
                # degenerate or memory-unbounded requests only
                raise ServeError(f"n={n} must be 2 <= n <= "
                                 f"{shapes_mod.MAX_SERVED_N}")
            group = GroupKey(n=n, layout=layout,
                             precision=precision or "split3",
                             inverse=False, domain="r2c", op=op)
            return xr, xi, group
        if xi is None:
            if domain != "r2c":
                raise ServeError(f"domain={domain!r} requests need both "
                                 f"planes; only r2c input is real by "
                                 f"declaration")
            xi = np.zeros_like(xr)
        xi = np.asarray(xi, np.float32)
        if xr.ndim != 1 or xr.shape != xi.shape:
            raise ServeError(f"request planes must be matching 1-D "
                             f"arrays, got {xr.shape} / {xi.shape}")
        if domain == "c2r":
            # the planes carry half-spectrum bins; the group is keyed
            # by the real-side length they decode to
            n = 2 * (xr.shape[0] - 1)
        else:
            n = xr.shape[0]
        if n < 2 or n > shapes_mod.MAX_SERVED_N:
            # any length in range is a plan; note a c2r request's n is
            # DECODED as 2*(bins-1), so
            # the wire expresses even real lengths only
            raise ServeError(f"n={n} must be 2 <= n <= "
                             f"{shapes_mod.MAX_SERVED_N}"
                             + (" (c2r planes carry n//2+1 bins)"
                                if domain == "c2r" else ""))
        if layout == "pi" and n & (n - 1):
            raise ServeError(f"layout='pi' requires a power-of-two n "
                             f"(bit-reversed order is undefined "
                             f"otherwise), got n={n}")
        if inverse and layout != "natural":
            raise ServeError("inverse requires natural layout (the "
                             "conj-trick contract, plans.core)")
        if domain != "c2c":
            if inverse:
                raise ServeError("inverse is the c2c conj trick; use "
                                 "domain='c2r' for the real inverse")
            if layout != "natural":
                raise ServeError(f"domain={domain!r} requires natural "
                                 f"layout (the half-spectrum has no pi "
                                 f"order)")
            if domain == "r2c" and np.any(xi):
                raise ServeError("r2c request carries a nonzero "
                                 "imaginary plane — the half-spectrum "
                                 "path would silently drop it; send "
                                 "zeros (or omit xi), or use c2c")
        group = GroupKey(n=n, layout=layout,
                         precision=precision or "split3",
                         inverse=inverse, domain=domain)
        return xr, xi, group

    def _check_served(self, group: GroupKey) -> None:
        """Strict-shape refusal (shared with the mesh dispatcher)."""
        if self.config.strict_shapes and \
                (group.n, group.layout, group.precision,
                 group.domain, group.op) not in self._served:
            raise ShapeNotServed(
                f"shape {group.label()} is not in the warmed set "
                f"({len(self.specs)} shape(s)); add it to the shape "
                f"file or serve without strict_shapes")

    def _admit(self, group: GroupKey, q, priority: str) -> None:
        """Class-aware bounded admission: each priority class may fill
        the group's queue only to its ceiling (PRIORITY_ADMIT_FILL ×
        ``queue_depth``), so low-priority load sheds first under
        pressure, with its ``retry_after_ms`` scaled to back off
        harder.  Raises :class:`QueueFull`; never waits."""
        cap = max(1, int(self.config.queue_depth
                         * PRIORITY_ADMIT_FILL[priority]))
        if q.qsize() < cap:
            return
        label = group.label()
        self.stats.record_rejected(label)
        metrics.inc("pifft_serve_rejected_total", shape=label)
        if cap < self.config.queue_depth:
            # shed below the hard bound: the class ceiling did it
            metrics.inc("pifft_serve_shed_total", priority=priority)
        retry_ms = self._retry_after_ms(group, q, priority)
        events.emit("serve_reject", cell={"n": group.n}, shape=label,
                    depth=q.qsize(), retry_after_ms=retry_ms,
                    priority=priority)
        raise QueueFull(
            f"queue for {label} is at the {priority}-class depth "
            f"{cap}/{self.config.queue_depth}; retry in ~{retry_ms} ms",
            retry_after_ms=retry_ms)

    async def submit(self, xr, xi=None, layout: str = "natural",
                     precision: Optional[str] = None,
                     inverse: bool = False,
                     domain: str = "c2c",
                     priority: str = "normal",
                     tenant: str = "default",
                     op: str = "fft",
                     trace=None,
                     t_recv: Optional[float] = None) -> Response:
        """Serve one n-point transform of float planes ``(n,)``.
        Raises a :class:`ServeError` subclass — never hangs — when the
        request cannot be admitted or no rung could serve it.

        `domain` picks the transform family: "c2c"
        (default — both planes required), "r2c" (real forward: `xr` is
        the length-n real signal, `xi` may be omitted and must
        otherwise be zeros — a nonzero imaginary plane on a
        declared-real request would be silently dropped, which is a
        wrong answer, so it is refused instead), or "c2r" (the
        inverse: the planes carry the n//2+1 half-spectrum bins and
        the response is the length-n real signal).

        `op` picks the served OPERATION: "fft" (the
        bare transform, default), or the fused spectral ops "conv" /
        "corr" (`xr` = the real signal, `xi` = the real kernel,
        CIRCULAR semantics at n) and "solve" (`xr` = the real field;
        the 1-D periodic Poisson solve).  Op requests coalesce per
        (op, shape, domain, precision) into one batched fused
        pipeline invocation.

        `priority` is the admission class (PRIORITIES): low-priority
        load sheds first under pressure with a harder retry backoff.
        `tenant` names the quota bucket; the mesh dispatcher enforces
        per-tenant quotas on it.

        `trace` continues a caller's trace (a wire ``trace`` field or
        an in-process :class:`~..obs.trace.TraceContext`); omitted, a
        fresh trace is MINTED here — obs/trace.py, the no-op
        singleton when observability is off.

        `t_recv` is the wire front's arrival stamp (the clock when the
        request's bytes finished arriving, BEFORE any decode): when
        given, it becomes the submit time, so frame decode cost lands
        in the request's queue phase and tail attribution sees the
        front door."""
        if self._closing:
            raise DispatcherClosed("dispatcher is shut down")
        xr, xi, group = self._validated(xr, xi, layout, precision,
                                        inverse, domain, priority, op)
        self._check_served(group)
        ctx = trace_mod.ensure(trace)
        t_submit = t_recv if t_recv is not None else clock()
        q = self._ensure_worker(group)
        try:
            self._admit(group, q, priority)
        except QueueFull:
            # shed requests are in the tracing tail-upgrade class:
            # the rejection leaves a (always-emitted) root span
            trace_mod.shed_record(ctx, label=group.label(),
                                  t_submit=t_submit,
                                  reason="queue_full",
                                  priority=priority)
            raise
        req = Request(rid=next(self._rid), group=group, xr=xr, xi=xi,
                      t_submit=t_submit,
                      future=asyncio.get_running_loop().create_future(),
                      priority=priority, tenant=tenant, trace=ctx)
        metrics.inc("pifft_serve_requests_total", shape=group.label())
        q.put_nowait(req)
        return await req.future

    def _ensure_worker(self, group: GroupKey) -> asyncio.Queue:
        q = self._queues.get(group)
        if q is None:
            # unbounded Queue; the depth bound is enforced at admission
            # so rejection is synchronous (and the shutdown sentinel
            # can always be delivered)
            q = self._queues[group] = asyncio.Queue()
            self._workers[group] = asyncio.get_running_loop() \
                .create_task(self._worker(group, q))
        return q

    def _retry_after_ms(self, group: GroupKey, q,
                        priority: str = "normal") -> float:
        ema = self._ema_ms.get(group, self.config.max_wait_ms)
        scale = PRIORITY_RETRY_SCALE.get(priority, 1.0)
        return round(max(1.0, ema * (q.qsize() + 1) * scale), 3)

    def buffer_stats(self) -> dict:
        """Staging-pool reuse stats (the wire ``stats`` op; the mesh
        dispatcher aggregates its per-device pools here)."""
        return self.runner.pool.stats()

    def _admission(self, group: GroupKey, q) -> tuple:
        """(window_s, forced_rung, level_tag) for the batch about to be
        drained — the admission-time degradation ladder.  Two signals
        feed it: queue FILL (the classic saturation ladder) and the
        burn-rate SLO monitor (obs/slomon.py) — a sustained
        error-budget burn forces the same rungs BEFORE the queues
        fill, tagged ``slo:*`` so the trigger is never ambiguous in
        the trail (queue fill wins the name when both fire).

        The cheap rung is the runner's :meth:`~.batcher.BatchRunner.
        overload_rung`: ``torch-fft`` on CPU planes (the reference serves
        ``jnp-fft`` there).  On the card no library rung serves, so the
        ladder stops at window collapse, tagged ``overload:window`` /
        ``slo:window`` (counted and evented as every level), and the
        queue bound sheds the rest with :class:`QueueFull`."""
        fill = q.qsize() / self.config.queue_depth
        slo = self.slomon.forced_level() if self.slomon is not None \
            else None
        cheap = self.runner.overload_rung()
        if fill >= self.config.overload_watermark:
            return 0.0, cheap, f"overload:{cheap or 'window'}"
        if slo == OVERLOAD_RUNG:
            return 0.0, cheap, f"slo:{cheap or 'window'}"
        if fill >= self.config.pressure_watermark:
            return 0.0, None, "pressure:window"
        if slo == "window":
            return 0.0, None, "slo:window"
        return self.config.max_wait_ms / 1e3, None, None

    # ------------------------------------------------------- workers

    async def _wait_for_request(self, q, timeout_s: float):
        """THE sanctioned serve-side wait (the reference's check rule
        PIF107): every
        hold in serve/ async code funnels through this one
        asyncio.wait_for — never ``time.sleep``, never sync I/O —
        returning None when the window closes empty."""
        try:
            return await asyncio.wait_for(q.get(), timeout=timeout_s)
        except asyncio.TimeoutError:
            return None

    async def _worker(self, group: GroupKey, q, device=None) -> None:
        closing = False
        while True:
            if closing:
                # past the shutdown sentinel: serve what is already
                # queued (admitted before close), then exit — a
                # request behind the sentinel must complete, never
                # orphan its future
                try:
                    req = q.get_nowait()
                except asyncio.QueueEmpty:
                    break
            else:
                req = await q.get()
            if req is _CLOSE:
                closing = True
                continue
            req.t_dequeue = clock()
            batch = [req]
            window_s, rung, level = self._admission(group, q)
            if closing:
                window_s = 0.0  # shutting down: ship what's here
            deadline = clock() + window_s
            while len(batch) < self.config.max_batch:
                try:
                    nxt = q.get_nowait()
                except asyncio.QueueEmpty:
                    remaining = deadline - clock()
                    if remaining <= 0 or closing:
                        break
                    nxt = await self._wait_for_request(q, remaining)
                    if nxt is None:
                        break
                if nxt is _CLOSE:
                    closing = True
                    continue  # keep collecting what is already queued
                nxt.t_dequeue = clock()
                batch.append(nxt)
            if level is not None:
                metrics.inc("pifft_serve_admission_degrade_total",
                            level=level)
                events.emit("serve_degrade", cell={"n": group.n},
                            shape=group.label(), level=level,
                            depth=q.qsize())
            await self._run_batch(group, batch, rung, level, device)
            # drop the served batch's refs BEFORE parking on the queue
            # again: request planes may be zero-copy views over a
            # client's shm slot ring (serve/shm.py), and a suspended
            # frame still binding them would pin a closed connection's
            # segment mapping open
            req = nxt = batch = None

    def _is_device_failure(self, exc: Exception) -> bool:
        """Hook: exceptions the batch path must NOT absorb into
        per-request failures because they indict the DEVICE, not the
        batch (the mesh dispatcher overrides: failover)."""
        return False

    @staticmethod
    def _batch_links(batch) -> Optional[list]:
        """The fan-in edge: the live request span ids this batch
        serves — recorded on the ONE serve_batch span so Perfetto can
        draw request→batch arrows (obs/trace.py)."""
        links = [r.trace.span_id for r in batch
                 if r.trace.live and r.trace.sampled]
        return links or None

    async def _invoke_batch(self, group: GroupKey, batch, rung,
                            device=None, level=None):
        """One coalesced kernel invocation in the executor (the event
        loop keeps admitting mid-kernel)."""
        return await asyncio.get_running_loop().run_in_executor(
            None,
            functools.partial(self.runner.run, group,
                              [(r.xr, r.xi) for r in batch], rung,
                              rung_tag=level,
                              links=self._batch_links(batch)))

    async def _run_batch(self, group: GroupKey, batch, rung, level,
                         device=None):
        label = group.label()
        t_start = clock()
        try:
            outcome = await self._invoke_batch(group, batch, rung,
                                               device, level)
        except Exception as e:
            if self._is_device_failure(e):
                raise  # the mesh's failover path owns these
            kind = classify(e).value
            events.emit("serve_error", cell={"n": group.n}, shape=label,
                        kind=kind, size=len(batch),
                        error=f"{type(e).__name__}: {str(e)[:200]}")
            metrics.inc("pifft_serve_errors_total", kind=kind)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(RequestFailed(
                        f"serve batch {label} failed beyond every rung "
                        f"({kind} {type(e).__name__}: {str(e)[:200]})",
                        kind=kind))
            return
        self._deliver(group, batch, outcome, t_start, rung, level,
                      device)

    def _deliver(self, group: GroupKey, batch, outcome, t_start, rung,
                 level, device=None):
        """Build and resolve the per-request responses for one served
        batch (shared by the single-device and mesh dispatchers)."""
        label = group.label()
        self.stats.record_batch(label)
        # EMA of per-request service time feeds QueueFull.retry_after
        batch_ms = (clock() - t_start) * 1e3 / len(batch)
        prev = self._ema_ms.get(group)
        self._ema_ms[group] = batch_ms if prev is None \
            else 0.7 * prev + 0.3 * batch_ms
        # a forced rung's tag is already in outcome.degrade
        # ("overload:<rung>", from the runner) — only the window-collapse
        # level needs adding here
        tags = ([level] if level and rung is None else []) \
            + list(outcome.degrade)
        device_id = getattr(device, "id", None)
        t_done = clock()
        for i, r in enumerate(batch):
            # the batch tags plus this request's OWN trail (failover
            # re-routes tag the request, not the batch it lands in)
            rtags = list(r.trail) + list(tags)
            degraded = outcome.degraded or bool(rtags)
            queue_s = t_start - r.t_submit
            resp = Response(
                rid=r.rid, yr=outcome.yr[i], yi=outcome.yi[i],
                queue_wait_ms=queue_s * 1e3,
                compute_ms=outcome.compute_s * 1e3,
                batch_size=outcome.size,
                plan_variant=outcome.plan_variant,
                degraded=degraded, degrade=rtags, device=device_id)
            if r.trace.live:
                # the request's span tree (obs/trace.py): queue/window/
                # compute children summing exactly to this row's
                # total, degrade tags and re-route hops as instants —
                # emitted when head-sampled, ALWAYS when degraded (the
                # tail upgrade), and returned on the response either
                # way so the caller keeps the correlation ids
                recs = trace_mod.request_span_records(
                    r.trace, label=label, rid=r.rid,
                    t_submit=r.t_submit, t_dequeue=r.t_dequeue,
                    t_exec=t_start, compute_s=outcome.compute_s,
                    t_done=t_done, tags=rtags, marks=r.marks,
                    device=device_id, cell={"n": group.n})
                emitted = trace_mod.emit_request_trace(
                    r.trace, recs, forced=degraded)
                resp.trace = trace_mod.wire_tree(r.trace, recs, emitted)
            self.stats.record(label, queue_s, outcome.compute_s,
                              degraded=degraded, device=device_id)
            metrics.observe("pifft_serve_queue_wait_seconds", queue_s,
                            shape=label)
            if degraded:
                metrics.inc("pifft_serve_degraded_total", shape=label)
            events.emit("serve_request", cell={"n": group.n},
                        rid=r.rid, shape=label,
                        queue_wait_ms=round(queue_s * 1e3, 4),
                        compute_ms=round(outcome.compute_s * 1e3, 4),
                        batch_size=outcome.size, degraded=degraded,
                        **({"degrade": rtags} if rtags else {}),
                        **({"device": device_id} if device_id else {}),
                        **({"trace": r.trace.trace_id}
                           if r.trace.live else {}))
            if self.slomon is not None:
                # the burn monitor judges the FULL server residence
                # time (submit -> delivery): staging, retries and
                # injected stalls all count — the latency the caller
                # actually experienced, not just the split the row
                # itemizes
                self.slomon.observe(
                    group.op, label, (t_done - r.t_submit) * 1e3,
                    t=t_done)
            if not r.future.done():
                r.future.set_result(resp)
        if self.slomon is not None:
            # one evaluation per delivered batch: the burn gauges stay
            # live and the forced level the NEXT admission reads is
            # current — recovery is as automatic as the alert
            self.slomon.evaluate(t=t_done)
        metrics.observe("pifft_serve_compute_seconds", outcome.compute_s,
                        shape=label)
