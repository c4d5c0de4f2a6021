"""The traced run: ``torch.profiler`` over the window, reduced to device
intervals and the benchmark's own host spans.

The profiler records the card's activity only (CUPTI): recording every
host operation as well would triple the host's time per call and make
the traced window another workload.  The benchmark's spans are kept by
the harness itself on the profiler's clock (Unix time in nanoseconds).
Device activity is every kernel, copy and set the card ran inside the
``bench.window`` span.  Busy time is the union of those intervals; an
idle gap is tagged by the host span that covers its middle
(``bench.issue``: the caller inside the entry; ``bench.wait``: the
caller waiting on an event; ``bench.window``: between the two).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

import torch

SPANS = ("bench.window", "bench.issue", "bench.wait")


@dataclasses.dataclass
class Trace:
    """Nanosecond intervals of one traced window."""

    window: tuple
    device: list          # (name, start, end), clipped to the window
    spans: dict           # span name -> [(start, end)], sorted
    port_kernels: tuple   # the port's __global__ names

    def __post_init__(self):
        self._port = re.compile(
            r"\b(" + "|".join(map(re.escape, self.port_kernels)) + r")\b")
        self._port_names = {}

    def _is_port(self, name: str) -> bool:
        if name not in self._port_names:
            self._port_names[name] = bool(self._port.search(name))
        return self._port_names[name]

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        """The union of the device intervals, sorted."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy())

    @property
    def port_ns(self) -> int:
        return sum(e - s for n, s, e in self.device if self._is_port(n))

    @property
    def other_ns(self) -> int:
        return sum(e - s for n, s, e in self.device if not self._is_port(n))

    def span_ns(self, name: str) -> list:
        return [e - s for s, e in self.spans.get(name, [])]

    def device_ops(self, top: int = 10) -> list:
        """[short name, seconds] of the `top` device operations by time."""
        total = {}
        for name, s, e in self.device:
            short = short_name(name)
            total[short] = total.get(short, 0) + e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """[host span, seconds] of the `top` longest idle gaps."""
        edges = [self.window[0]]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((s + e) // 2), (e - s) / 1e9]
                for s, e in gaps[:top]]

    def _host_at(self, t: int) -> str:
        for name in ("bench.issue", "bench.wait"):
            spans = self.spans.get(name, [])
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                return name
        return "bench.window"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces in parentheses,
    template arguments or parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


class Spans:
    """The benchmark's host spans, as ``span(name)`` context managers
    that record (start, end) in Unix nanoseconds."""

    def __init__(self):
        self.spans = {name: [] for name in SPANS}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans[name].append((start, time.time_ns()))


def reduce(device_events, spans: dict, port_kernels) -> Trace:
    """The Trace of the profiler's `device_events` (kineto events) and
    the host `spans`, the device clipped to the ``bench.window`` span."""
    device = []
    for ev in device_events:
        if ev.device_type() == torch.autograd.DeviceType.CPU \
                or ev.is_user_annotation():
            continue
        start = ev.start_ns()
        device.append((ev.name(), start, start + ev.duration_ns()))
    spans = {name: sorted(v) for name, v in spans.items()}
    w0, w1 = spans["bench.window"][0]
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    return Trace(window=(w0, w1), device=device, spans=spans,
                 port_kernels=tuple(port_kernels))


def traced(fn, port_kernels):
    """(fn(span), Trace): `fn` runs under the profiler, recording the
    card's activity, and gets a :class:`Spans` as its span factory."""
    from torch.profiler import ProfilerActivity, profile

    spans = Spans()
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        result = fn(spans)
    return result, reduce(prof.profiler.kineto_results.events(),
                          spans.spans, port_kernels)
