"""One run of one cell: set-up, the measured window, the comparison and
the metrics, as the result line reports them.

Set-up loads the port's kernels (building them on the first run in a
checkout), draws the input ring on the device from the seed, resolves
the plan and warms up the cell's own shape with the very pattern of
calls and kept outputs the window makes.  The comparison runs after the
window has closed and the device's peak memory has been read.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from . import check, counts, inputs, stream, trace
from .spec import Cell


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    transforms: int
    window_s: float
    latencies_s: list
    flops_per_transform: float
    least_bytes_per_transform: int
    peak_bytes_per_s: Optional[float]
    launches: int
    trace: Optional[trace.Trace]


def _load_kernels(device) -> float:
    """Load the port's kernel library; the seconds spent building it
    where this checkout had none yet, else 0."""
    if device.type != "cuda":
        return 0.0
    buildlib = inputs.port("utils.buildlib")
    missing = not os.path.exists(buildlib.library_path())
    t = stream.clock()
    buildlib.load_kernels()
    return stream.clock() - t if missing else 0.0


def _launch_total() -> int:
    return sum(inputs.port("ops.cuda_fft").launch_counts().values())


def keep_fractions(seed: int, count: int, round_len: int) -> list:
    """Where in the window the sampled calls lie, drawn from the seed:
    one round of `round_len` consecutive calls from a point in [0, 0.8),
    which holds every ring slot and every in-flight position, and the
    rest of `count` at points in [0, 0.9).  The stream keeps the first
    call at or after each point, so a point given `round_len` times
    keeps that many calls in a row."""
    rng = np.random.default_rng(seed)
    start = float(rng.uniform(0.0, 0.8))
    rest = rng.uniform(0.0, 0.9, size=max(count - round_len, 0)).tolist()
    return sorted([start] * round_len + rest)


def _finite(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", precision: Optional[str] = None,
             shape: Optional[tuple] = None, wrap=None,
             t_start: Optional[float] = None):
    """(result, notes): the result line's object and the lines printed
    before it.  `precision` overrides the configuration's mode (the
    lower-precision control), `shape` its shape (tests on the CPU),
    `wrap(call)` the entry's call (tests that break the timed path)."""
    t_start = stream.clock() if t_start is None else t_start
    device = torch.device(device)
    seed = seed % (1 << 63)
    cfg, traffic, entry = cell.config, cell.traffic, cell.entry
    kwargs = traffic.get("kwargs") or {}
    shape = tuple(shape or cell.shape)
    precision = precision or cfg["precision"]
    marks = [("imports", stream.clock())]
    build_s = _load_kernels(device)
    marks.append(("kernels", stream.clock()))

    call = entry.bind(precision, **kwargs)
    if wrap is not None:
        call = wrap(call)
    ring = entry.make_inputs(shape, traffic["ring"], seed, device, cfg)
    plan = entry.plan(shape, precision, device, **kwargs) \
        if hasattr(entry, "plan") else "not stated by the entry"
    stream.sync(device)
    marks.append(("inputs and plan", stream.clock()))
    in_flight = traffic["in_flight"]
    round_len = math.lcm(len(ring), in_flight)
    samples = max(cfg["check_samples"], round_len)
    warm = stream.stream(call, ring, in_flight, device,
                         calls=2 * len(ring) + in_flight + samples,
                         keep_at=[0.0] * samples)
    one_out = warm.kept[0][1]
    least = counts.least_bytes(ring[0], one_out)
    del warm, one_out
    launches0 = _launch_total()
    setup_s = stream.clock() - t_start
    marks.append(("warm-up", t_start + setup_s))
    parts = ", ".join(f"{name} {t - (marks[i - 1][1] if i else t_start)}"
                      for i, (name, t) in enumerate(marks))

    def window(span=stream.no_span):
        return stream.stream(call, ring, in_flight, device, seconds=seconds,
                             keep_at=keep_fractions(seed, samples,
                                                    round_len),
                             span=span)

    tr = None
    if traced:
        win, tr = trace.traced(window, cell.port_kernels())
    else:
        win = window()
    launches = _launch_total() - launches0
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips,
           "memory_peak_bytes":
               torch.cuda.max_memory_allocated(device) if cuda else 0}
    if tr is not None:
        dev["busy_s"] = tr.busy_ns / 1e9
        dev["window_s"] = tr.window_ns / 1e9

    # the program's state goes before the reference runs
    pairs = [(check.to_numpy(ring[slot]), check.answer(out))
             for slot, out in win.kept]
    notes = [f"# plan {plan}",
             f"# build_s {build_s} (in setup_s {setup_s})",
             f"# setup_s by part: {parts}",
             f"# samples compared {len(pairs)} of {samples} planned, "
             f"ring slots {sorted({s for s, _ in win.kept})}, "
             f"of {win.transforms} calls",
             f"# host time in the entry, mean us "
             f"{win.issue_s / max(win.transforms, 1) * 1e6}"]
    lat_ms = [t * 1e3 for t in win.latencies_s]
    if lat_ms:
        notes.append(f"# latency_ms median {float(np.median(lat_ms))} "
                     f"p95 {float(np.percentile(lat_ms, 95))} "
                     f"max {max(lat_ms)} samples {len(lat_ms)}")
    run = Run(cell=cell, setup_s=setup_s, transforms=win.transforms,
              window_s=win.window_s, latencies_s=win.latencies_s,
              flops_per_transform=entry.flops(shape, **kwargs),
              least_bytes_per_transform=least,
              peak_bytes_per_s=counts.peak_bytes_per_s(kind),
              launches=launches, trace=tr)
    del ring, win, call
    if cuda:
        torch.cuda.empty_cache()

    verdict = check.compare(pairs, cell.reference(),
                            traffic.get("reference_args") or {},
                            cell.limits, planned=samples)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict["passed"], "attempted": run.transforms,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in verdict["checks"].items()}
    return result, notes
