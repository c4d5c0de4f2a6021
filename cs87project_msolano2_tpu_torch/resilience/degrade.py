"""The plan degradation chain (the reference's ``resilience/degrade.py``):
when a kernel plan dies of a CAPACITY or PERMANENT fault, demote it down
the constraint ladder instead of killing the call —

    sixstep  ->  fourstep  ->  rql  ->  torch-fft  ->  numpy-ref
    (fused / rows / mf enter at the fourstep -> rql edge: fourstep is a
    sibling single-pass design, not a weaker one, so they skip it)

Each rung asks less of the card than the one above (two carries, one
carry, two launches, a library call, the host) and computes the same
transform.  ``torch-fft`` and ``numpy-ref`` are the only library rungs:
``torch.fft`` with the pi-layout take, and a host round trip through
numpy in complex128.  They serve planes on the CPU only.  On the card
the walk ends at the last kernel rung (rql) and the fault re-raises
past it, so no library call or host round trip ever serves a card
transform; the any-length variants, whose only rungs are the library
ones, re-raise there at once.  A rung that cannot serve the key at all
(fourstep past its shared-memory bound, where sixstep exists because
fourstep cannot run) counts as failing and the walk goes on.  Every
demotion is recorded on the plan (``plan.degraded`` /
``plan.demotions``), memoized in the in-process plan cache only,
counted on ``pifft_demotions_total{to}`` with a ``demotion`` event while
observability is armed, and announced through ``plans.core.warn``, so a
degraded run is never taken for a healthy one; bench rows carry
``degraded: true`` and the rung that served.

What is never demoted:

* TRANSIENT faults: they re-raise for the retry layer
  (``resilience.retry``): demoting a good kernel because the device was
  busy for a moment would forfeit the measurement.
* A kernel that failed to build or load (:class:`KernelBuildError`):
  serving a library rung would hide a broken kernel behind a library
  call.
* A sticky CUDA error (``taxonomy.sticky``): the context is poisoned and
  no rung can run after it.

What is demoted is what the reference demotes: pre-launch ValueErrors
(shared memory, infeasible blocking), launch-resource and out-of-memory
refusals (CAPACITY) and injected faults.  The walk runs on the host at
call time; a call that is being captured into a CUDA graph must not be
one that can fault, so the race and the slope timer capture plans whose
first, uncaptured call has already run.
"""

from __future__ import annotations

from typing import Callable

from ..obs import events, metrics
from .taxonomy import FaultKind, KernelBuildError, classify, sticky

#: the demotion ladder, weakest demand last
DEGRADE_CHAIN = ("fourstep", "rql", "torch-fft", "numpy-ref")

#: the rungs that are a library call or the host: planes on the CPU only
LIBRARY_RUNGS = ("torch-fft", "numpy-ref")

#: the transport demotion rung: not a kernel of the chain above but the
#: sharded paths' escape — when a supervised collective is aborted (or a
#: device is reported unhealthy), the all_to_all 2-D FFT / Poisson
#: dataflow re-plans onto per-rank local work over the whole input
#: (``parallel/escape.py``), recorded by :func:`note_collective_escape`
#: with the record shape and plan tagging of a kernel demotion
COLLECTIVE_FREE_RUNG = "collective_free"

#: the quality-direction rungs: a plan whose sampled error exceeds its
#: mode's budget promotes up the mode chain (bf16 -> default -> split3 ->
#: fp32), recorded like a demotion with ``direction: "up"`` and the rung
#: name ``precision:<mode>``
PRECISION_RUNG_PREFIX = "precision:"

#: parameters of the rql rung: automatic tile and column block
_RQL_PARAMS = {"tile": None, "cb": None}

#: parameters of the fourstep rung (sixstep's first demotion): the
#: automatic blocking, so the rung either runs or raises its feasibility
#: ValueError and the walk goes on
_FOURSTEP_PARAMS = {"tile": None, "cb": None, "separable": True}

def _rungs_after(variant: str) -> tuple:
    """The chain below `variant`, a ladder variant or a chain rung a
    plan already landed on.  A plan never demotes sideways or up: only
    sixstep enters at the fourstep rung."""
    if variant in DEGRADE_CHAIN:
        return DEGRADE_CHAIN[DEGRADE_CHAIN.index(variant) + 1:]
    if variant == "sixstep":
        return DEGRADE_CHAIN
    if variant == "two-kernel":
        return DEGRADE_CHAIN[2:]
    if variant in ("bluestein", "rader", "mixedradix"):
        # the any-length variants skip the kernel rungs (power-of-two
        # paths) and land on the library rungs, which take any n
        return DEGRADE_CHAIN[2:]
    if variant == "stages":
        # the stage path is the port's counterpart of the reference's
        # "jnp" variant: only the host is below it
        return DEGRADE_CHAIN[3:]
    return DEGRADE_CHAIN[1:]


def rungs_for(variant: str, device) -> tuple:
    """The rungs the walk may try below `variant` for planes on
    `device`: the whole chain on the CPU, the kernel rungs alone on the
    card."""
    import torch

    rungs = _rungs_after(variant)
    if torch.device(device).type == "cpu":
        return rungs
    return tuple(r for r in rungs if r not in LIBRARY_RUNGS)


def build_rung(key, rung: str) -> Callable:
    """The executor of one chain rung at `key`'s shape, layout and
    domain.  Raises (before anything runs) where the rung cannot serve
    the key, which the walk treats as the rung failing.

    Real-domain keys degrade like the rest: the kernel rungs serve the
    half-length c2c transform inside the Hermitian passes, built by the
    ladder's own executor builder, and the library rungs call
    ``rfft``/``irfft`` directly."""
    real_domain = key.domain != "c2c"
    inner_n = key.n // 2 if real_domain else key.n
    pow2 = key.n >= 1 and not (key.n & (key.n - 1))

    if rung in ("fourstep", "rql"):
        from ..plans import ladder

        if not pow2:
            raise ValueError(f"{rung} rung requires power-of-two n, "
                             f"got n={key.n}")
        if key.batch != ():
            raise ValueError(f"{rung} rung is a 1-D whole-transform path")
        if rung == "rql":
            return ladder.build_executor(key, "rql", dict(_RQL_PARAMS))
        # past fourstep's shared-memory bound the automatic column block
        # raises here and the walk moves on to rql; a real domain probes
        # the packed length its kernel runs
        from ..ops.cuda_fft import MAX_SMEM_TILE, fourstep_auto_cb

        if inner_n > MAX_SMEM_TILE:
            fourstep_auto_cb(inner_n, MAX_SMEM_TILE)
        return ladder.build_executor(key, "fourstep",
                                     dict(_FOURSTEP_PARAMS))

    if rung == "torch-fft":
        return _torch_fft_rung(key)
    if rung == "numpy-ref":
        return _numpy_rung(key)
    raise ValueError(f"unknown degradation rung {rung!r}")


def _torch_fft_rung(key) -> Callable:
    """``torch.fft`` on the planes' device, pi layout by the same
    bit-reversal take as the port's gather."""
    import torch

    from ..ops.bits import to_natural

    n = key.n
    if key.domain == "r2c":
        def torch_rfft_run(xr, xi):
            del xi  # real by declaration (domain="r2c")
            y = torch.fft.rfft(xr.float(), dim=-1)
            return y.real.contiguous(), y.imag.contiguous()

        return torch_rfft_run
    if key.domain == "c2r":
        def torch_irfft_run(xr, xi):
            y = torch.fft.irfft(torch.complex(xr.float(), xi.float()),
                                n=n, dim=-1)
            return y, torch.zeros_like(y)

        return torch_irfft_run
    pi = key.layout == "pi"

    def torch_fft_run(xr, xi):
        y = torch.fft.fft(torch.complex(xr.float(), xi.float()), dim=-1)
        yr, yi = y.real.contiguous(), y.imag.contiguous()
        # pi[i] = natural[bitrev(i)]: the bit reversal is its own inverse
        return to_natural(yr, yi) if pi else (yr, yi)

    return torch_fft_run


def _numpy_rung(key) -> Callable:
    """A host round trip: numpy's FFT in complex128, the result back on
    the planes' device as float32 planes."""
    import numpy as np
    import torch

    from ..ops.bits import bit_reverse_indices

    n = key.n
    idx = bit_reverse_indices(n) if key.layout == "pi" else None

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def back(a, like):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            like.device)

    def numpy_run(xr, xi):
        if key.domain == "r2c":
            y = np.fft.rfft(host(xr), axis=-1)
        elif key.domain == "c2r":
            yr = np.fft.irfft(host(xr) + 1j * host(xi), n=n, axis=-1)
            out = back(yr, xr)
            return out, torch.zeros_like(out)
        else:
            y = np.fft.fft(host(xr) + 1j * host(xi), axis=-1)
            if idx is not None:
                y = y[..., idx]
        return back(y.real, xr), back(y.imag, xr)

    return numpy_run


def _never_demoted(exc: BaseException, kind: FaultKind) -> bool:
    """Faults the chain re-raises: transient ones (for the retry layer),
    a kernel that did not build or load, a poisoned CUDA context."""
    return (kind is FaultKind.TRANSIENT
            or isinstance(exc, KernelBuildError) or sticky(exc))


def _note_demotion(plan, from_variant: str, rung: str,
                   exc: BaseException, kind: FaultKind,
                   skipped: list) -> None:
    """Record one demotion: the rung that served, the fault that evicted
    `from_variant` as the reason, and the rungs that were tried and
    failed on the way in `skipped`: the trail never names a rung that
    did not run."""
    from ..plans import cache
    from ..plans.core import warn

    record = {
        "from": from_variant,
        "to": rung,
        "kind": kind.value,
        "reason": f"{type(exc).__name__}: {str(exc)[:200]}",
    }
    if skipped:
        record["skipped"] = list(skipped)
    plan.degraded = True
    plan.demotions.append(record)
    metrics.inc("pifft_demotions_total", to=rung)
    events.emit("demotion",
                cell={"n": plan.key.n, "variant": from_variant}, **record)
    warn(f"plan DEGRADED {from_variant} -> {rung} for "
         f"{plan.key.token()} ({kind.value}: {record['reason']})"
         + (f" [also failed: {'; '.join(skipped)}]" if skipped else "")
         + " — results stay correct; performance does not")
    # the in-process cache only: a demotion belongs to this session, and
    # storing it would taint every later (possibly healthy) session and
    # let an injected fault poison the user's plan store
    cache.memoize(plan)


def promote_precision(plan, observed_err: float,
                      budget: float) -> "str | None":
    """Move the plan one rung up the precision chain: its served mode
    (``params["precision"]``, else the key's) becomes the next tighter
    mode (bf16 -> default -> split3 -> fp32), the executor is dropped so
    the next ``plan.fn`` rebuilds at that mode, and the step is recorded
    as a demotion with ``direction: "up"``: a plan no longer serving
    what it was tuned as never reads as healthy.  Returns the new mode,
    or None at the top of the chain.  Memoized in the in-process cache
    only, as every demotion."""
    from ..ops import precision as prec_mod
    from ..plans import cache
    from ..plans.core import warn

    mode = plan.effective_precision()
    nxt = prec_mod.promote(mode)
    if nxt is None:
        warn(f"precision budget violated at the top of the chain "
             f"({mode}: rel err {observed_err:.3e} > budget "
             f"{budget:.1e}) — nothing tighter to promote to; serving "
             f"tagged degraded")
        return None
    rung = f"{PRECISION_RUNG_PREFIX}{nxt}"
    record = {
        "from": mode,
        "to": rung,
        "kind": "quality",
        "direction": "up",
        "reason": (f"rel err {observed_err:.3e} > budget {budget:.1e} "
                   f"for mode {mode!r}"),
    }
    plan.degraded = True
    plan.demotions.append(record)
    plan.params = dict(plan.params, precision=nxt)
    plan._fn = None  # rebuild the executor at the promoted mode
    metrics.inc("pifft_demotions_total", to=rung)
    events.emit("demotion",
                cell={"n": plan.key.n, "variant": plan.variant},
                **record)
    warn(f"plan PROMOTED {mode} -> {nxt} (precision, UP) for "
         f"{plan.key.token()} ({record['reason']}) — accuracy is "
         f"restored; the tuned bytes-halving is not")
    cache.memoize(plan)
    return nxt


def note_collective_escape(label: str, exc: BaseException,
                           kind: FaultKind, plans=()) -> dict:
    """Record one transport demotion: a supervised collective at `label`
    was abandoned (or its devices reported unhealthy) and the run
    escaped onto the collective-free path.  Returns the record
    (``{"from": "all_to_all", "to": "collective_free", ...}``) and tags
    it onto every plan in `plans` as a kernel demotion is, in the
    in-process cache only: an escape belongs to this session's mesh,
    not to the tuned kernel."""
    from ..plans import cache
    from ..plans.core import warn

    record = {
        "from": "all_to_all",
        "to": COLLECTIVE_FREE_RUNG,
        "kind": kind.value,
        "reason": f"{type(exc).__name__}: {str(exc)[:200]}",
        "site": label,
    }
    for plan in plans:
        plan.degraded = True
        plan.demotions.append(dict(record))
        cache.memoize(plan)
    metrics.inc("pifft_demotions_total", to=COLLECTIVE_FREE_RUNG)
    events.emit("demotion", cell={"site": label}, **record)
    warn(f"collective ESCAPED all_to_all -> {COLLECTIVE_FREE_RUNG} at "
         f"{label} ({kind.value}: {record['reason']}) — per-rank local "
         f"work over the whole input; results stay bit-identical, the "
         f"all_to_all does not run")
    return record


def resilient_executor(plan, raw: Callable) -> Callable:
    """`raw`, the plan's executor, wrapped in the degradation chain.

    A CAPACITY or PERMANENT fault of the current executor walks the
    chain down (each rung's own such faults continue the walk); what
    ``_never_demoted`` names re-raises untouched.  Planes on the card
    walk the kernel rungs only (``rungs_for``).  The walk is sticky:
    once a rung serves, later calls start there, the demotion is
    recorded once (with the failed rungs in ``skipped``), and the trail
    only moves down.  The last rung's failure propagates.  When nothing
    faults the wrapper adds one Python call and nothing else: no host
    sync, no allocation, so a plan's calls stay capturable."""
    state = {"fn": raw, "variant": plan.variant}

    def run(xr, xi):
        try:
            return state["fn"](xr, xi)
        except Exception as e:
            kind = classify(e)
            if _never_demoted(e, kind):
                raise
            exc, skipped = e, []
            for rung in rungs_for(state["variant"], xr.device):
                try:
                    fn = build_rung(plan.key, rung)
                    out = fn(xr, xi)
                except Exception as e2:
                    k2 = classify(e2)
                    if _never_demoted(e2, k2):
                        raise
                    skipped.append(f"{rung}: {k2.value} "
                                   f"{type(e2).__name__}: {str(e2)[:80]}")
                    exc = e2
                    continue
                _note_demotion(plan, state["variant"], rung, e, kind,
                               skipped)
                state["fn"], state["variant"] = fn, rung
                return out
            raise exc

    run.consumes_input = getattr(raw, "consumes_input", False)
    return run
