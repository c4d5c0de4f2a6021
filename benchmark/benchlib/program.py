"""The port's own spans in a traced window, split by layer.

While ``torch.profiler`` runs, the port records its transform path's
spans (``obs.TRANSFORM_PATH``: ``fft.call`` at the root of each call,
``plan.lookup``, ``plan.execute``, ``kernel.launch`` and the steps
between) and gives them, through ``obs.spans.intervals()``, on the
profiler's Unix-nanosecond clock, the clock of the trace's device
intervals and of the benchmark's ``bench.*`` spans.  A port without that
reader gives None here, and so do the metrics that read it.

Each instant inside ``fft.call`` belongs to the innermost of the spans
in :data:`LAYERS` that covers it, so the four host times partition the
call: ``api`` (the split, the join, the entry's own Python), ``lookup``,
``execute`` (its checks, tables, fault site, the gather's and the real
passes' issue) and ``launch``.
"""

from __future__ import annotations

from . import inputs

#: the span that opens each part of a call's host time
LAYERS = {"fft.call": "api", "plan.lookup": "lookup",
          "plan.execute": "execute", "kernel.launch": "launch"}


def intervals(run):
    """The port's spans inside the traced window as (name, parent,
    depth, tid, start_ns, end_ns), or None where the run was not traced
    or the port recorded none."""
    if run.trace is None:
        return None
    read = getattr(inputs.port("obs.spans"), "intervals", None)
    if read is None:
        return None
    w0, w1 = run.trace.window
    found = [iv for iv in read() if w0 <= iv[4] and iv[5] <= w1]
    return found or None


def host_split(run):
    """{layer: mean us a call} over the calls (``fft.call`` spans) of
    the window, each of :data:`LAYERS`' layers 0.0 where no call had
    its span; None where there are no calls."""
    ivs = intervals(run)
    calls = sum(1 for iv in ivs or () if iv[0] == "fft.call")
    if not calls:
        return None
    total = dict.fromkeys(LAYERS.values(), 0)
    stack = []  # [tid, end_ns, layer, self_ns] of the open spans

    def close():
        tid, end, layer, self_ns = stack.pop()
        if layer is not None:
            total[layer] += self_ns

    for name, _, _, tid, start, end in sorted(
            ivs, key=lambda iv: (iv[3], iv[4], -iv[5])):
        while stack and (stack[-1][0] != tid or stack[-1][1] <= start):
            close()
        inherited = stack[-1][2] if stack else None
        if stack:
            stack[-1][3] -= end - start
        # a span outside any call counts nowhere, and neither do those
        # under it
        layer = LAYERS.get(name, inherited) if inherited or \
            name == "fft.call" else None
        stack.append([tid, end, layer, end - start])
    while stack:
        close()
    return {layer: ns / calls / 1e3 for layer, ns in total.items()}


def _overlap_ns(a: list, b: list) -> int:
    """Nanoseconds two sorted lists of disjoint [start, end] share."""
    i = j = shared = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        shared += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def _union(spans) -> list:
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_intervals(trace) -> list:
    """The window's [start, end] in which no device activity runs."""
    edges = [trace.window[0]]
    for s, e in trace.busy():
        edges += [s, e]
    edges.append(trace.window[1])
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def entry_idle_ns(trace, ivs) -> int:
    """Nanoseconds of the window in which the device is idle while the
    host is inside ``fft.call``."""
    calls = _union((iv[4], iv[5]) for iv in ivs if iv[0] == "fft.call")
    return _overlap_ns(idle_intervals(trace), calls)


def innermost(ivs, t: int):
    """The name of the deepest span of `ivs` that covers `t`, or None."""
    best = None
    for name, _, depth, _, start, end in ivs:
        if start <= t < end and (best is None or depth > best[1]):
            best = (name, depth)
    return best and best[0]


def idle_gaps(trace, ivs, top: int = 10) -> list:
    """[span, seconds] of the `top` longest idle gaps, each named by the
    innermost program span that covers its middle, else by the
    benchmark's own span there (``bench.issue``, ``bench.wait``,
    ``bench.window``)."""
    gaps = sorted(idle_intervals(trace), key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        out.append([innermost(ivs or (), mid) or trace._host_at(mid),
                    (e - s) / 1e9])
    return out
