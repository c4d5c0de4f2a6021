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

    plan(n).execute(xr, xi)            # 1-D transform
    plan_for(shape).execute(xr, xi)    # batched rows over the trailing axis
    plan_for(shape, backend="gpu")     # the gpu backend (hw.lowering)
    tune(key)                          # explicit tuning race (card only)

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


def plan(n: int, batch: tuple = (), layout: str = "natural",
         precision: str | None = None, domain: str = "c2c",
         device="cuda", backend: str = "cuda") -> Plan:
    """The single dispatch point: ``plan(n).execute(xr, xi)``.  Numpy
    input to ``execute`` goes to `device` — the card by default.
    `backend` picks the lowering family: "cuda" (the port's kernels)
    or "gpu" (``hw.lowering``)."""
    return get_plan(make_key(n, batch, layout, precision, domain=domain,
                             backend=backend, device=device), str(device))


def plan_for(shape, layout: str = "natural",
             precision: str | None = None, domain: str = "c2c",
             device="cuda", backend: str = "cuda") -> Plan:
    """Plan for float-plane arrays of `shape` (trailing axis = transform
    length, leading axes = batch)."""
    shape = tuple(shape)
    return plan(shape[-1], shape[:-1], layout, precision, domain=domain,
                device=device, backend=backend)
