"""Observability subsystem: structured events, phase spans, a metrics
registry, and trace exporters — ONE spine for every measurement-adjacent
signal (README, "Telemetry").

Every span, event and counter of the package lands in one stream with
one identity, in the same envelope, series names and span names as the
JAX package's ``obs`` (so the same tools read either package's stream):

* ``events``   — schema'd records ``{run, seq, t, kind, cell, payload}``
                 in a thread-safe bounded buffer, with an optional
                 atomic JSONL sink (the resilience journal's writer).
* ``spans``    — nested, thread-aware phase spans (context manager +
                 decorator) with ``torch.profiler.record_function``
                 and NVTX pass-through, exported as Chrome trace JSON
                 (Perfetto-loadable).  Owns the sanctioned non-timing
                 clock.
* ``metrics``  — labeled counters/gauges/histograms (plan-cache
                 hits/misses, autotune fates, retries per FaultKind,
                 demotions per rung, bytes moved).
* ``export``   — Chrome trace / Prometheus textfile / human summary,
                 fronted by ``obs {summary, export, validate, top}``.
* ``profiler`` — the ``torch.profiler`` deep-trace wrapper (a
                 deprecation shim remains at ``utils/tracing.py``).

The OFF state is the contract: everything is gated on one module-level
flag (``events._STATE``; the spans read ``spans._REC``, which enable
sets beside it), so a disabled process pays one attribute read per call
— no locks, no allocation, zero events (verified by test).  The
transform path's spans (:data:`TRANSFORM_PATH`) also record, into
``spans.intervals()`` only, while a ``torch.profiler`` session runs.
Enable explicitly (:func:`enable`, ``bench --events``) or by
environment: ``PIFFT_OBS_EVENTS=<path>`` arms the JSONL sink,
``PIFFT_OBS=1`` buffers in-process only.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager

from . import events, export, metrics, profiler, spans  # noqa: F401
from .events import (  # noqa: F401
    disable,
    emit,
    enable,
    enabled,
    flush,
    run_id,
    snapshot,
    validate_event,
)
from .spans import intervals, span, traced  # noqa: F401

#: the transform path's spans, root first, and its counters (README,
#: "Telemetry"): what the port records beyond the reference's stream.
#: ``fft.call`` is the root of ``models.fft.fft``, ``fft_planes_fast``
#: and ``models.real.rfft``; ``fft.split``/``fft.join`` their planes
#: split and complex pack; ``plan.lookup`` is ``plans.plan_for``,
#: ``plan.execute`` ``Plan.execute``, ``fft.gather`` ``ops.bits.to_natural``;
#: ``real.pack``/``real.merge`` the r2c executor's passes;
#: ``kernel.launch`` the library call of every counted kernel launch.
#: The counters count ``Plan``'s protective copies of a caller's plane
#: and the bit-reversal index tensors built.
TRANSFORM_PATH = ("fft.call", "fft.split", "fft.join", "plan.lookup",
                  "plan.execute", "fft.gather", "real.pack", "real.merge",
                  "kernel.launch", "pifft_plan_input_copies_total",
                  "pifft_gather_index_builds_total")

# NOTE: ``obs.trace`` is the TRACE-CONTEXT module (request tracing,
# the live plane); the deep profiler is ``obs.profiler.trace``
from .trace import NOOP_TRACE, TraceContext  # noqa: F401
from .trace import current as current_trace  # noqa: F401

# http (the live endpoints) and slomon (burn-rate alerting) are NOT
# imported here: both are leaf modules with heavier import footprints
# (http.server / config parsing) that the disabled-path contract has
# no business paying — import cs87project_msolano2_tpu_torch.obs.http /
# .slomon where the live plane is actually armed.


@contextmanager
def armed():
    """Arm observability for the block where it is disarmed, and disarm
    it after ("owned"); an armed run is left as it is.  How a caller
    that reads a count arms exactly the calls it counts, as the apps
    smokes do.  Yields this package."""
    owned = not enabled()
    if owned:
        enable()
    try:
        yield sys.modules[__name__]
    finally:
        if owned:
            disable()


def _env_autoenable() -> None:
    """Arm observability from the environment at import time, so any
    entry point (CLI, harness, a user script) can opt in without code:
    ``PIFFT_OBS_EVENTS=<path>`` writes the JSONL sink, ``PIFFT_OBS=1``
    keeps events in-process for a later in-process export."""
    if enabled():
        return
    path = os.environ.get("PIFFT_OBS_EVENTS", "").strip()
    if path:
        # append, not truncate: the env form outlives single processes
        # (multi-process jobs and repeated CLI runs share one path, and
        # atomic lines interleave safely) — the summary separates runs
        # by run id.  Explicit enable()/--events truncates instead: one
        # run owns that file.
        enable(events_path=path, append=True)
    elif os.environ.get("PIFFT_OBS", "").strip() == "1":
        enable()


_env_autoenable()
