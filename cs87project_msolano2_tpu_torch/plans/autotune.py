"""The autotuner: race the candidate ladder for a key on the card, record
every candidate's fate, cache the winner (the reference's
``plans/autotune.py``).

Timing is the reference's loop slope (``utils.timing.loop_slope_ms``):
k back-to-back calls of a candidate captured once in a CUDA graph, the
replay timed between two events at two values of k, the slope taken,
so the wrappers' host work never enters a candidate's time.  A
candidate whose launch cannot be captured is a fault of its wrapper,
recorded as a rejection like any other.  A candidate refused before it
runs — a ValueError at the shared-memory budget, a cooperative launch
the card will not keep resident — is recorded as a rejection with its
fault kind and the race continues; only a race in which NOTHING ran is
an error.  A sticky CUDA
error (an illegal or misaligned address, a launch failure) aborts the
race and re-raises: it poisons the context, so every later candidate
would fail too and the "winner" would be whatever ran first.

The CPU never tunes: plain-version timings would poison the persistent
store with numbers that mean nothing on the card.  Tests may inject a
`timer` and pass ``allow_offline=True`` to exercise the race machinery
itself.
"""

from __future__ import annotations

import functools
import sys
from typing import Callable, Optional

from . import cache, ladder
from .core import (
    CandidateResult,
    Plan,
    PlanKey,
    device_is_tunable,
    offline_kind,
)

#: the seed of the race's input planes
TIMER_SEED = 0
#: host-clock calls a cpu-native candidate is timed over (the median)
HOST_REPS = 10


class TuningUnavailable(RuntimeError):
    """Tuning was requested where it cannot produce meaningful numbers
    (offline: no card) or where no candidate exists for the key."""


class TuningError(RuntimeError):
    """Every ladder candidate was rejected; `results` records why."""

    def __init__(self, message: str, results: list):
        super().__init__(message)
        self.results = results


def _log(verbose: bool, msg: str) -> None:
    if verbose:
        print(msg, file=sys.stderr)


def default_timer(fn: Callable, key: PlanKey, device="cuda") -> float:
    """Per-call ms of `fn` on planes shaped ``key.input_shape()``, drawn
    from a seeded ``torch.Generator`` on `device`, by the loop slope
    (``utils.timing.loop_slope_ms``) over the race's window for the
    input's size (``race_window``: the reference's windows up to 2^24
    elements, narrower past it, so a 2^27 candidate is read over 32
    calls, not 256).  The calls rotate over copies of the drawn planes,
    as many as the card's L2 asks (``window_copies``), so each reads its
    input cold; an executor that writes over its input gets the drawn
    planes back in every copy before each timed run, untimed.  Window
    and copies depend on the key alone, so every candidate of a race is
    read under one rule.  The layout's bit-reversal gather is wherever
    the plan puts it, as the race must time what the plan serves.  On a
    CPU device the host clock times the same runs.  A cpu-native key
    runs on the host whatever `device` is: its planes are drawn there
    and the host clock's median of HOST_REPS calls times them
    (``utils.timing.time_ms``), as the reference times its native
    rows."""
    import math

    import torch

    from ..hw.inventory import l2_bytes
    from ..utils.timing import (
        loop_slope_ms,
        race_window,
        time_ms,
        window_copies,
    )

    if key.backend == "cpu-native":
        device = "cpu"
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIMER_SEED)
    shape = key.input_shape()
    xr = torch.randn(shape, generator=gen, device=dev)
    xi = torch.randn(shape, generator=gen, device=dev)
    if key.backend == "cpu-native":
        return time_ms(fn, xr, xi, reps=HOST_REPS, warmup=1)[0]
    elements = math.prod(shape)
    window = race_window(elements)
    copies = window_copies(8 * elements, l2_bytes(dev), window)
    arg_sets = [(xr.clone(), xi.clone()) for _ in range(copies)]
    before = None
    if getattr(fn, "consumes_input", False):
        # fn writes over its planes: each run starts from the drawn
        # ones, untimed, as a Plan hands it fresh planes per call
        def before():
            for a, b in arg_sets:
                a.copy_(xr)
                b.copy_(xi)
    return loop_slope_ms(fn, arg_sets, *window, before=before)


def tune(key: PlanKey, *, force: bool = False,
         timer: Optional[Callable] = None, verbose: bool = True,
         allow_offline: bool = False, persist: bool = True,
         device="cuda") -> Plan:
    """The tuned plan for `key`: cache hit unless `force`, else race the
    ladder on `device`, record every candidate's fate, store the winner
    (two-level — a later process skips this entirely)."""
    from ..resilience import classify, sticky

    if not force:
        hit = cache.lookup(key)
        # a memoized static default is NOT a tuning result — get_plan
        # parks those in the same LRU, and returning one here would let
        # an earlier untuned call silently veto the race
        if hit is not None and hit.source == "static":
            hit = None
        if hit is not None:
            _log(verbose, f"# plan cache hit ({hit.source}): "
                          f"{key.token()} -> {hit.variant} {hit.params}")
            return hit
    if not allow_offline and (offline_kind(key.device_kind)
                              or not device_is_tunable(device)):
        # no card, or a key that names none: card timings stored under
        # a "cpu" key would be served to the CPU as if they meant
        # something there
        raise TuningUnavailable(
            f"refusing to autotune offline (device {device}, key kind "
            f"{key.device_kind!r}: the plain versions' timings are "
            f"meaningless); get_plan() serves the static defaults there")
    cands = ladder.candidates(key)
    if not cands:
        raise TuningUnavailable(f"no tunable candidates for {key.token()}")
    timer = timer or functools.partial(default_timer, device=device)

    from ..obs import metrics, spans

    results = []
    with spans.span("autotune", cell={"n": key.n, "layout": key.layout},
                    candidates=len(cands), precision=key.precision):
        for variant, params in cands:
            # precision is a raced axis: a pinned per-candidate mode
            # labels the fate counters so a race record shows which
            # STORAGE the winner actually beat
            mode = params.get("precision") or key.precision
            label = f"{variant} {params}"
            try:
                fn = ladder.build_executor(key, variant, params)
                ms = float(timer(fn, key))
            except Exception as e:
                if sticky(e):
                    # the context is poisoned: no later candidate can
                    # run, and recording this as a rejection would crown
                    # whichever ran first
                    raise
                # the FaultKind leads the reason so a race record
                # doubles as a fault-taxonomy record (capacity refusals
                # vs permanent infeasibility)
                fault = classify(e).value
                reason = f"{fault} {type(e).__name__}: {str(e)[:200]}"
                results.append(CandidateResult(variant, dict(params),
                                               "rejected", None, reason))
                metrics.inc("pifft_autotune_candidates_total",
                            status="rejected", kind=fault,
                            precision=mode)
                _log(verbose,
                     f"# plan candidate {label} rejected: {reason}")
                continue
            results.append(CandidateResult(variant, dict(params),
                                           "timed", ms))
            metrics.inc("pifft_autotune_candidates_total",
                        status="accepted", kind="timed", precision=mode)
            _log(verbose, f"# plan candidate {label}: {ms:.4f} ms")

    timed = [r for r in results if r.status == "timed"]
    if not timed:
        raise TuningError(
            f"no ladder candidate ran for {key.token()}", results)
    best = min(timed, key=lambda r: r.ms)
    for r in timed:
        if r is best:
            r.status, r.reason = "won", "fastest measured"
        else:
            r.status = "lost"
            r.reason = f"{r.ms:.4f} ms vs winner {best.ms:.4f} ms"

    plan = Plan(key=key, variant=best.variant, params=dict(best.params),
                source="tuned", ms=best.ms, tuning=results,
                device=str(device))
    cache.store(plan, persist=persist)
    from ..obs import events

    events.emit("plan_tuned",
                cell={"n": key.n, "variant": best.variant},
                ms=best.ms, params=dict(best.params),
                candidates=[r.to_record() for r in results])
    _log(verbose, f"# plan tuned: {key.token()} -> {best.variant} "
                  f"{best.params} ({best.ms:.4f} ms)")
    return plan


def fourstep_crossover(plans: list) -> Optional[int]:
    """The measured crossover n from a list of tuned plans: the smallest
    n whose winner is a fourstep variant, None when fourstep never won.
    The ladder's static expectation is ``ladder.FOURSTEP_MIN_N`` (the
    TPU's); this reports what THIS card measured."""
    wins = sorted(p.key.n for p in plans if p.variant == "fourstep")
    return wins[0] if wins else None


def sixstep_crossover(plans: list) -> Optional[int]:
    """The measured fourstep→sixstep boundary from a list of tuned
    plans: the smallest n whose winner is a sixstep variant, None when
    sixstep never won.  The ladder's static expectation is
    ``ladder.SIXSTEP_MIN_N`` (the TPU's)."""
    wins = sorted(p.key.n for p in plans if p.variant == "sixstep")
    return wins[0] if wins else None


def tune_sweep(ns, *, layout: str = "pi", precision: Optional[str] = None,
               force: bool = False, timer: Optional[Callable] = None,
               verbose: bool = True, allow_offline: bool = False,
               persist: bool = True, device="cuda", backend: str = "cuda"):
    """Per-n crossover selection: race the ladder at each n (each n gets
    the candidates :func:`ladder.candidates` enumerates for ITS key) and
    report the measured fourstep crossover.  Returns
    ``(plans, crossover_n)``; cached winners short-circuit exactly as in
    :func:`tune`.  A single n whose race fails outright (every candidate
    rejected) is skipped with a logged reason; :class:`TuningUnavailable`
    (offline — no n can tune) and sticky CUDA errors propagate.  Keys
    carry `backend`, so each backend's winners are raced and stored
    apart."""
    from . import make_key

    out = []
    for n in sorted(int(x) for x in ns):
        key = make_key(n, layout=layout, precision=precision,
                       backend=backend, device=device)
        try:
            out.append(tune(key, force=force, timer=timer, verbose=verbose,
                            allow_offline=allow_offline, persist=persist,
                            device=device))
        except TuningError as e:
            _log(verbose, f"# plan sweep: n={n} race failed ({e}); "
                          f"skipping this n")
    cross = fourstep_crossover(out)
    _log(verbose, f"# plan sweep: measured fourstep crossover = "
                  f"{cross if cross is not None else 'none (never won)'}")
    cross6 = sixstep_crossover(out)
    _log(verbose, f"# plan sweep: measured sixstep crossover = "
                  f"{cross6 if cross6 is not None else 'none (never won)'}")
    return out, cross
