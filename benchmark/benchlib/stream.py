"""The closed-loop streaming caller that every cell's traffic drives.

It keeps `in_flight` calls outstanding, records one CUDA event after
each, and before each new call waits on the oldest.  Inputs cycle over
a ring of distinct inputs; each output is held only until its slot
comes round again, unless the call is one the comparison samples.  A
call's latency runs from just before the caller calls the entry to the
moment the caller sees its event complete.  The window closes with a
synchronise, and its wall time covers every call issued in it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

clock = time.perf_counter


class _HostEvent:
    """The CPU's stand-in for a CUDA event: CPU work is done on return."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _event(device):
    return torch.cuda.Event() if device.type == "cuda" else _HostEvent()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def no_span(_name):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Window:
    """What one window did: `transforms` calls issued and completed in
    `window_s` seconds, each call's latency, the host seconds spent
    inside the entry, and the sampled calls as (ring slot, outputs)."""

    transforms: int
    window_s: float
    latencies_s: list
    issue_s: float
    kept: list


def stream(call, ring, in_flight: int, device, *, seconds: float = None,
           calls: int = None, keep_at=(), span=no_span) -> Window:
    """Drive `call` over `ring` for `seconds` or for `calls` calls.  The
    output of the first call issued at or after each fraction of
    `keep_at` of the window (each of the first len(keep_at) calls in a
    counted stream) is kept.  `span(name)` wraps the window
    ("bench.window"), each call until it returns ("bench.issue") and
    each wait ("bench.wait")."""
    events = [_event(device) for _ in range(in_flight)]
    slots = [None] * in_flight
    pending = collections.deque()
    marks = collections.deque(sorted(keep_at))
    latencies, kept = [], []
    issue_s = 0.0
    k = 0
    sync(device)
    t0 = clock()
    deadline = t0 + seconds if seconds is not None else None
    with span("bench.window"):
        while (calls is None or k < calls) and \
                (deadline is None or clock() < deadline):
            if len(pending) == in_flight:
                ev, t = pending.popleft()
                with span("bench.wait"):
                    ev.synchronize()
                latencies.append(clock() - t)
            keep = bool(marks) and (
                calls is not None
                or clock() - t0 >= marks[0] * seconds)
            ev = events[k % in_flight]
            t = clock()
            with span("bench.issue"):
                out = call(ring[k % len(ring)])
                ev.record()
            issue_s += clock() - t
            pending.append((ev, t))
            slots[k % in_flight] = out
            if keep:
                marks.popleft()
                kept.append((k % len(ring), out))
            k += 1
        while pending:
            ev, t = pending.popleft()
            with span("bench.wait"):
                ev.synchronize()
            latencies.append(clock() - t)
        sync(device)
    return Window(transforms=k, window_s=clock() - t0,
                  latencies_s=latencies, issue_s=issue_s, kept=kept)
