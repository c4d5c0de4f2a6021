"""Timing on the card (the reference's ``utils/timing.py``).

Two timers:

* ``time_ms`` warms up, then times each rep between two
  ``torch.cuda.Event``s and reports the median.  With ``flush_l2`` it
  writes a 256 MB scratch buffer before each rep, outside the events, so
  the card's 50 MB L2 starts cold as it does for a caller that streams
  fresh data.  The events also hold whatever host work the call does
  before its launch while the card waits: the time a caller feels.
* ``loop_slope_ms`` is the reference's loop-slope method
  (``loop_slope_ms`` / ``_slope_from_make``): T(k) times k back-to-back
  calls, and the per-call time is the slope (T(k2) - T(k1)) / (k2 - k1),
  in which the fixed costs cancel.  On the card the k calls are captured
  once into a CUDA graph, the counterpart of the reference's compiled
  ``fori_loop``, and T(k) is one replay between two events: no host work
  runs between the calls, so the slope is device time.  Where the delta
  falls below ``SLOPE_MIN_DELTA_MS``, k2 quadruples, as in the
  reference.  The calls rotate over copies of their input planes, enough
  that the other calls between two uses of one copy touch more than the
  card's L2 (``rotation_copies``), and each call's outputs are dropped
  only as many calls later, so they rotate too: each call reads its
  input and writes its output cold, as under ``time_ms``'s flush.  The
  autotuner times every candidate this way
  (``plans.autotune.default_timer``, over ``race_window``: one window
  for every candidate of a key, from the input's size), ``slope_ms`` any
  call on given operands (the bench), and ``fitted_slope_ms`` one call
  over a window fitted to its length (the backends' phase timers).

On CPU tensors both use the host clock, which is honest there.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Optional, Sequence

import torch

FLUSH_BYTES = 256 << 20

#: the reference's slope windows (its plans/autotune.py:77-81): (k1, k2)
#: for inputs of SLOPE_BIG_ELEMENTS elements and up, and below
SLOPE_BIG_ELEMENTS = 1 << 22
SLOPE_WINDOW_BIG = (16, 256)
SLOPE_WINDOW_SMALL = (64, 1024)
#: the least T(k2) - T(k1) a slope is taken from; below it k2 quadruples
SLOPE_MIN_DELTA_MS = 2.0
#: the widest window k2 may reach
SLOPE_MAX_K = 1 << 16
#: replays of each graph, the best kept (the reference's reps)
SLOPE_REPS = 5
#: cycles the card spins before each timed replay, so the host has
#: enqueued the whole graph before the start event fires (about 10 ms)
SPIN_CYCLES = 20_000_000
#: the longest run ``fitted_window`` aims a window's k2 calls at, ms: a
#: run of 100 ms is still about 50 times the SLOPE_MIN_DELTA_MS floor
FITTED_RUN_MS = 100.0
#: ``race_window`` halves the big window for each doubling of the input
#: past this many elements
RACE_HALVING_ELEMENTS = 1 << 24


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def time_ms(fn: Callable, *args, reps: int = 20, warmup: int = 2,
            flush_l2: bool = False, before: Callable | None = None):
    """(median ms per call, last result) of ``fn(*args)`` over `reps`
    timed calls after `warmup` untimed ones, on the device of the first
    tensor argument.  `before`, when given, runs before every call,
    outside the timing (and before the flush): it restores the inputs
    of an `fn` that writes over them."""
    dev = _device_of(args)
    result = None
    before = before or (lambda: None)
    if dev.type != "cuda":
        for _ in range(warmup):
            before()
            result = fn(*args)
        times = []
        for _ in range(max(reps, 1)):
            before()
            t0 = time.perf_counter()
            result = fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), result

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if flush_l2 else None
    for _ in range(warmup):
        before()
        result = fn(*args)
    times = []
    for _ in range(max(reps, 1)):
        before()
        if scratch is not None:
            scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), result


class SlopeUnresolved(RuntimeError):
    """T(k2) - T(k1) stayed under the floor up to the widest window."""


def slope_window(elements: int) -> tuple[int, int]:
    """The reference's (k1, k2) for an input of `elements` elements."""
    return SLOPE_WINDOW_BIG if elements >= SLOPE_BIG_ELEMENTS \
        else SLOPE_WINDOW_SMALL


def race_window(elements: int) -> tuple[int, int]:
    """The race's (k1, k2) for an input of `elements` elements: the
    reference's window (``slope_window``) up to RACE_HALVING_ELEMENTS,
    halved (k1 at least 1) for each doubling past it, so that a run
    takes about as long at 2^27 as at 2^24 — (2, 32) at 2^27, where a
    candidate takes milliseconds a call.  One window for every
    candidate of a key: the race reads them all under one rule."""
    k1, k2 = slope_window(elements)
    shift = max(0, (elements - 1).bit_length()
                - RACE_HALVING_ELEMENTS.bit_length() + 1)
    return max(1, k1 >> shift), max(2, k2 >> shift)


def slope_from(measure: Callable[[int], float], k1: int, k2: int,
               min_delta_ms: float = SLOPE_MIN_DELTA_MS,
               max_k: int = SLOPE_MAX_K) -> float:
    """(T(k2) - T(k1)) / (k2 - k1), T = `measure`, once the delta clears
    `min_delta_ms`; until then k2 quadruples (up to `max_k`) and T(k1)
    is measured again beside it, so both ends come from the same
    conditions.  Raises SlopeUnresolved past `max_k`."""
    t1 = measure(k1)
    while True:
        t2 = measure(k2)
        if t2 - t1 >= min_delta_ms:
            return (t2 - t1) / (k2 - k1)
        if k2 >= max_k:
            raise SlopeUnresolved(
                f"slope below the floor: T({k1})={t1:.4f} ms, "
                f"T({k2})={t2:.4f} ms, delta < {min_delta_ms} ms at "
                f"{max_k} calls")
        k2 = min(4 * k2, max_k)
        t1 = measure(k1)


def rotation_copies(plane_bytes: int, l2_bytes: Optional[int]) -> int:
    """Copies of the input planes (`plane_bytes` each) that back-to-back
    calls rotate over so that each reads its input cold: between two
    uses of one copy the other calls read and write at least the L2's
    size.  One where a single call already moves twice the L2, or where
    the L2 is unknown (the CPU)."""
    if not l2_bytes or plane_bytes >= 2 * l2_bytes:
        return 1
    return 1 + -(-l2_bytes // plane_bytes)


def loop_slope_ms(fn: Callable, arg_sets: Sequence[tuple], k1: int,
                  k2: int, reps: int = SLOPE_REPS,
                  min_delta_ms: float = SLOPE_MIN_DELTA_MS,
                  max_k: int = SLOPE_MAX_K,
                  before: Callable | None = None) -> float:
    """Per-call ms of `fn` by the loop slope (``slope_from``): call i of
    a run of k takes ``arg_sets[i % len(arg_sets)]``, and its outputs
    are dropped len(arg_sets) calls later; T(k) is the best of `reps`
    runs.  On the card a run is the replay of a CUDA graph that
    captured the k calls (the outputs are dropped inside the capture,
    so the graph's memory pool holds len(arg_sets) calls' worth), timed
    between two events after the card has spun long enough for the host
    to enqueue it; every arg set is called once outside the capture
    first, so that lazy set-up never enters a graph.  On the CPU a run
    is k calls on the host clock.  `before`, when given, runs before
    each run, untimed: it restores the planes of an `fn` that writes
    over them (within one run a copy's later calls see transformed
    values, which does not change the work)."""
    dev = _device_of(arg_sets[0])
    before = before or (lambda: None)
    m = len(arg_sets)
    if dev.type != "cuda":
        def host_run(k):
            best = float("inf")
            for _ in range(max(reps, 1)):
                before()
                held = collections.deque(maxlen=m)
                t0 = time.perf_counter()
                for i in range(k):
                    held.append(fn(*arg_sets[i % m]))
                best = min(best, (time.perf_counter() - t0) * 1e3)
            return best

        return slope_from(host_run, k1, k2, min_delta_ms, max_k)

    for args in arg_sets:
        before()
        fn(*args)
    torch.cuda.synchronize(dev)
    pool = torch.cuda.graph_pool_handle()
    graphs = {}

    def graph_run(k):
        if k not in graphs:
            g = torch.cuda.CUDAGraph()
            held = collections.deque(maxlen=m)
            with torch.cuda.graph(g, pool=pool):
                for i in range(k):
                    held.append(fn(*arg_sets[i % m]))
                held.clear()
            graphs[k] = g
        best = float("inf")
        for _ in range(max(reps, 1)):
            before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            graphs[k].replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    try:
        return slope_from(graph_run, k1, k2, min_delta_ms, max_k)
    finally:
        torch.cuda.synchronize(dev)
        for g in graphs.values():
            g.reset()


def fitted_window(est_ms: float, elements: int) -> tuple[int, int]:
    """``slope_window(elements)`` narrowed for a call that takes about
    `est_ms`: k2 no more than FITTED_RUN_MS / est_ms calls (at least 2),
    k1 a sixteenth of k2 (at least 1).  A funnel of tens of
    milliseconds then costs a few calls a reading, not hundreds, and a
    call of microseconds keeps the reference's window."""
    k1, k2 = slope_window(elements)
    if est_ms > 0:
        k2 = max(2, min(k2, int(FITTED_RUN_MS / est_ms)))
        k1 = max(1, min(k1, k2 // 16))
    return k1, k2


def window_copies(plane_bytes: int, l2_bytes: Optional[int],
                  window: tuple) -> int:
    """``rotation_copies``, at most the window's k2: a run of k2 calls
    reads copies 0..k2-1 whichever the count past k2, so the copies
    beyond it would change no call's reads and only cost a warm-up call
    each."""
    return min(rotation_copies(plane_bytes, l2_bytes), window[1])


def slope_ms(fn: Callable, *args, consumes: bool = False,
             window: Optional[tuple] = None,
             reps: int = SLOPE_REPS) -> float:
    """Per-call ms of ``fn(*args)`` by the loop slope (``loop_slope_ms``)
    over `window` (default: the reference's window for the largest
    tensor argument, ``slope_window``), the calls rotating over copies
    of the tensor arguments, as many as keep the L2 from serving a call
    (``window_copies``).  `consumes`: fn writes over its tensor
    arguments, so every copy gets them back before each timed run."""
    from ..hw.inventory import l2_bytes

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    window = window or slope_window(max(t.numel() for t in tensors))
    copies = window_copies(nbytes, l2_bytes(tensors[0].device), window)

    def copy():
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    sets = [copy() for _ in range(copies)] if consumes \
        else [args] + [copy() for _ in range(copies - 1)]
    before = None
    if consumes:
        def before():
            for s in sets:
                for a, b in zip(s, args):
                    if isinstance(a, torch.Tensor):
                        a.copy_(b)
    return loop_slope_ms(fn, sets, *window, reps=reps, before=before)


def fitted_slope_ms(fn: Callable, *args, consumes: bool = False,
                    reps: int = SLOPE_REPS) -> float:
    """``slope_ms`` over the window fitted to one call's time
    (``fitted_window``): one warm-up and one timed call (where fn writes
    over its tensor arguments, `consumes`, on copies of them restored
    before each call), then the slope.  On the card the cached blocks
    of those calls go back first, as a graph's private pool cannot take
    them."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    probe = args
    restore = None
    if consumes:
        probe = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args)

        def restore():
            for a, b in zip(probe, args):
                if isinstance(a, torch.Tensor):
                    a.copy_(b)
    est = time_ms(fn, *probe, reps=1, warmup=1, before=restore)[0]
    del probe
    if tensors[0].device.type == "cuda":
        torch.cuda.empty_cache()
    window = fitted_window(est, max(t.numel() for t in tensors))
    return slope_ms(fn, *args, consumes=consumes, window=window, reps=reps)
