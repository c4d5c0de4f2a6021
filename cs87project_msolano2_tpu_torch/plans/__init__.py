"""FFT plans: the variant and parameters for each key, chosen once per
key — tuned on the card, stored on disk, or the static default — and
reused (the reference's ``plans/`` package).

* ``core``     — :class:`PlanKey` / :class:`Plan`: the key, the chosen
                 variant + kernel parameters, and the executor.
* ``ladder``   — the race's candidate table and the static defaults.
* ``autotune`` — races the ladder on the card with CUDA events; entries
                 refused before they run are recorded rejections, a
                 sticky CUDA error aborts the race.
* ``cache``    — two-level store: in-process LRU plus a JSON file under
                 ``~/.cache/cs87project-msolano2-tpu-torch``
                 (``PIFFT_PLAN_CACHE`` overrides the directory; ``off``
                 disables disk), versioned by schema, library version
                 and device kind.

Consumer entry points:

    plan(n).execute(xr, xi)            # 1-D transform, any n >= 1
    plan_for(shape).execute(xr, xi)    # batched rows over the trailing axis
    plan_for(shape, domain="r2c")      # real input, half-spectrum out
    plan_for(shape, backend="gpu")     # the gpu backend (hw.lowering)
    plan_for(shape, backend="cpu-native")  # the C core, p raced
    tune(key)                          # explicit tuning race (card only)
    measured_ms(key)                   # (ms, plan): the bench's policy

``plan``/``plan_for``/``get_plan`` NEVER tune implicitly: they serve the
cache when it has an entry and the static default otherwise (set
``PIFFT_PLAN_AUTOTUNE=1`` to opt in to tune-on-miss on a card).  The
CPU never tunes.
"""

from __future__ import annotations

import os
import sys

from . import cache  # noqa: F401
from .autotune import (  # noqa: F401
    TuningError,
    TuningUnavailable,
    fourstep_crossover,
    sixstep_crossover,
    tune,
    tune_sweep,
)
from .core import (  # noqa: F401
    BACKENDS,
    CandidateResult,
    Plan,
    PlanKey,
    current_device_kind,
    device_is_tunable,
    offline_kind,
    warn,
)


def make_key(n: int, batch: tuple = (), layout: str = "natural",
             precision: str | None = None,
             device_kind: str | None = None,
             dtype: str = "float32",
             domain: str = "c2c",
             backend: str = "cuda",
             device="cuda") -> PlanKey:
    """PlanKey for an n-point transform over `batch` leading dims on
    `device` (its kind names the key unless `device_kind` is given)."""
    return PlanKey(
        device_kind=device_kind or current_device_kind(device),
        n=int(n),
        batch=tuple(int(b) for b in batch),
        layout=layout,
        dtype=dtype,
        precision=precision or "split3",
        domain=domain,
        backend=backend,
    )


def get_plan(key: PlanKey, device: str = "cuda") -> Plan:
    """The plan for `key`: in-process cache, then disk cache, then the
    static default (memoized).  Never tunes unless the user opted in
    with PIFFT_PLAN_AUTOTUNE=1 and `device` is a card; even then a
    failed race warns once and falls through to the static default,
    which then serves the key without another race."""
    hit = cache.lookup(key)
    if hit is not None and hit.source != "static":
        return hit
    opt_in = (os.environ.get("PIFFT_PLAN_AUTOTUNE") == "1"
              and device_is_tunable(device)
              and not offline_kind(key.device_kind)
              and not cache.race_failed(key))
    # a static plan memoized before the opt-in must not veto it
    if hit is not None and not opt_in:
        return hit
    if key.domain != "c2c" and key.n % 2 == 0:
        # an even-n real key rides the c2c plan at n/2: resolved through
        # this same path, so a tuned or stored c2c winner (or the
        # opted-in race, which then serves every c2c caller too) carries
        # over, the pack and Hermitian passes added by the ladder's
        # executor.  ms is not copied: the inner time is not the real
        # path's.  Odd n resolves below, on the any-length ladder
        from . import ladder

        inner = get_plan(ladder.c2c_subkey(key), device)
        plan = Plan(key=key, variant=inner.variant,
                    params=dict(inner.params), source=inner.source,
                    device=str(device))
        cache.memoize(plan)
        return plan
    if opt_in:
        try:
            return tune(key, device=device)
        except Exception as e:
            # fall through to the static default — but SAY so: a race
            # that dies silently looks identical to one that never ran
            cache.mark_race_failed(key)
            warn(f"opted-in autotune failed ({type(e).__name__}: "
                 f"{str(e)[:200]}); serving static default")
    from . import ladder

    variant, params = ladder.static_default(key)
    plan = Plan(key=key, variant=variant, params=params, source="static",
                device=str(device))
    cache.memoize(plan)
    return plan


def tune_or_static(key: PlanKey, *, force: bool = False,
                   verbose: bool = True, device="cuda") -> Plan:
    """``tune(key)``, degrading to the static default where tuning is
    refused (no card, or a key with no candidates): tune when the
    hardware can answer, never die for lack of it."""
    try:
        return tune(key, force=force, verbose=verbose, device=device)
    except TuningUnavailable as e:
        if verbose:
            print(f"# not tuning ({e}); using static plan",
                  file=sys.stderr)
        return get_plan(key, device)


def measured_ms(key: PlanKey, *, verbose: bool = True, device="cuda",
                timer=None):
    """(per-call ms, plan) for `key`: the bench's measurement policy (the
    reference's ``measured_ms``).  A fresh race already timed its winner
    by the loop slope and that time is taken; a stored or static plan is
    timed with the race's own timer (``autotune.default_timer``, or
    `timer(fn, key)`).  A plan that demoted while being timed gets one
    forced re-race, whose winner is taken if it ran healthy; a plan that
    failed outright is re-raced once.  TRANSIENT faults re-raise: the
    moment failed, not the plan."""
    import functools

    from .autotune import default_timer

    timer = timer or functools.partial(default_timer, device=device)
    plan = tune_or_static(key, verbose=verbose, device=device)
    if plan.source == "tuned" and plan.ms is not None:
        return plan.ms, plan
    try:
        ms = timer(plan.fn, plan.key)
    except Exception as e:
        from ..resilience import FaultKind, classify

        kind = classify(e)
        if kind is FaultKind.TRANSIENT:
            raise
        if verbose:
            print(f"# plan {plan.variant} {plan.params} failed "
                  f"({kind.value} {type(e).__name__}); re-tuning",
                  file=sys.stderr)
        plan = tune_or_static(key, force=True, verbose=verbose,
                              device=device)
        if plan.ms is None:  # the static plan: nothing was raced
            raise
        return plan.ms, plan
    if plan.degraded:
        # before a time of the chain is taken, one forced re-race may
        # find a kernel that still runs
        try:
            retuned = tune_or_static(key, force=True, verbose=verbose,
                                     device=device)
        except TuningError as e:
            if verbose:
                print(f"# re-race after demotion failed ({e}); keeping "
                      f"the degraded measurement", file=sys.stderr)
            retuned = None
        if retuned is not None and retuned.ms is not None \
                and not retuned.degraded:
            return retuned.ms, retuned
    return ms, plan


def plan(n: int, batch: tuple = (), layout: str = "natural",
         precision: str | None = None, domain: str = "c2c",
         device="cuda", backend: str = "cuda") -> Plan:
    """The single dispatch point: ``plan(n).execute(xr, xi)``.  Numpy
    input to ``execute`` goes to `device` — the card by default.
    `backend` picks the lowering family: "cuda" (the port's kernels),
    "gpu" or "cpu-native" (``hw.lowering``; cpu-native runs the C core
    on the host, the planes' device whatever it is)."""
    return get_plan(make_key(n, batch, layout, precision, domain=domain,
                             backend=backend, device=device), str(device))


def plan_for(shape, layout: str = "natural",
             precision: str | None = None, domain: str = "c2c",
             device="cuda", backend: str = "cuda") -> Plan:
    """Plan for float-plane arrays of `shape` (trailing axis = transform
    length, leading axes = batch).  For every domain the shape is the
    signal side's: a c2r plan's executor takes half-spectrum planes, but
    its key's n is the real length."""
    shape = tuple(shape)
    return plan(shape[-1], shape[:-1], layout, precision, domain=domain,
                device=device, backend=backend)
