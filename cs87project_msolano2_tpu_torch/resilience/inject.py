"""Fault injection: every recovery policy testable on the CPU (the
reference's ``resilience/inject.py``).

Injection sites are one-line ``maybe_fault("<site>")`` probes at the
places real faults strike: the kernel-variant entry points of
``ops/cuda_fft.py`` (site ``tube``: a kernel is the tube transform),
plan dispatch (``plans/core.py``, ``plan``), tube-plan resolution
(``models.pi_fft.resolve_tube_plan``, ``resolve``), the any-length executors
(``ops/anylen.py``, ``anylen``), the sharded pi-FFT entries
(``parallel/pi_shard.py``, ``shard``), collective supervision
(``resilience/watchdog.py``, ``collective``), the bench's measurement
loops (``bench``) and the harness's sweep cells (``harness``).  The
sites of modules the port does not have yet (serving) keep their names
here and fire nowhere until those modules land.

Arming:

* environment — ``PIFFT_FAULT=<site>:<kind>[:<prob>[:<count>]]``,
  comma-separated for several specs; ``site`` is an fnmatch pattern,
  ``kind`` one of transient/capacity/permanent/timeout/stall, ``prob``
  defaults to 1.0, ``count`` caps the firings (unlimited when omitted).
  ``PIFFT_FAULT=tube:capacity:1.0`` is the chaos run of the bench.
  ``stall`` faults delay instead of raising; ``stall=<seconds>`` in the
  kind token sets the delay.
* in-process — the :func:`inject` context manager, which scopes a fault
  to one block.

An injected exception carries the signature text of the CUDA error it
imitates (``cudaErrorMemoryAllocation``, ``cudaErrorDevicesUnavailable``,
``cudaErrorInvalidValue``), so the taxonomy's pattern tables, not a
side channel, classify it.  Disarmed, a probe reads the environment
once and returns: the value is parsed once per value.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import time
from contextlib import contextmanager
from typing import Optional

from .taxonomy import CollectiveTimeout

#: site -> where it fires (the ``faults list`` table); the keys are the
#: reference's
KNOWN_SITES = {
    "tube": "kernel-variant entry points in ops/cuda_fft.py (rql / "
            "two-kernel / fused / fourstep / sixstep / mf / rows) — the "
            "segment transform every plan executes",
    "plan": "plans.core.Plan.execute dispatch",
    "resolve": "tube-plan resolution (models.pi_fft.resolve_tube_plan, "
               "behind tube_planned and the sharded paths)",
    "shard": "the sharded pi-FFT entries (parallel/pi_shard.py: "
             "pi_fft_sharded, pi_fft_sharded_batched)",
    "collective": "collective supervision (resilience/watchdog.py: "
                  "inside every supervised region before its dispatch, "
                  "and at collective_watchdog's arm point)",
    "bench": "bench.py measurement loops",
    "harness": "harness/run_experiments.py sweep cells",
    "serve": "the serving batcher's tuned-kernel batch (not ported yet: "
             "comes with serving)",
    "device": "per-device batch execution of a serving mesh, one site "
              "per device named device<K> (not ported yet: comes with "
              "serving)",
    "canary": "the fleet canary's shadow re-race (not ported yet: comes "
              "with serving)",
    "promote": "the fleet canary's promotion write (not ported yet: "
               "comes with serving)",
}

KINDS = ("transient", "capacity", "permanent", "timeout", "stall")

#: default injected stall, seconds
DEFAULT_STALL_S = 1.0


class InjectedFault(RuntimeError):
    """Base of injected faults (so logs tell chaos from reality); the
    message carries the imitated CUDA signature, which is what
    :func:`~.taxonomy.classify` keys on."""


# message templates with the CUDA runtime's own names and strings, the
# ones taxonomy.py's pattern tables match
_TEMPLATES = {
    "transient": "cudaErrorDevicesUnavailable: injected transient fault "
                 "at site {site!r} (CUDA-capable device(s) is/are busy "
                 "or unavailable)",
    "capacity": "cudaErrorMemoryAllocation: injected capacity fault at "
                "site {site!r} (out of memory)",
    "permanent": "cudaErrorInvalidValue: injected permanent fault at "
                 "site {site!r} (invalid argument)",
}


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fnmatch `site` pattern, `kind`, firing
    probability, optional cap on firings, and the firing counter.
    ``stall`` faults delay by ``stall_s`` instead of raising."""

    site: str
    kind: str
    prob: float = 1.0
    count: Optional[int] = None
    fired: int = 0
    stall_s: float = DEFAULT_STALL_S

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        parts = text.strip().split(":")
        if not 2 <= len(parts) <= 4 or not parts[0]:
            raise ValueError(
                f"bad fault spec {text!r} (want site:kind[:prob[:count]])")
        kind = parts[1].lower()
        stall_s = DEFAULT_STALL_S
        if kind.startswith("stall="):
            kind, _, secs = kind.partition("=")
            try:
                stall_s = float(secs)
            except ValueError:
                raise ValueError(f"bad stall duration {secs!r} in "
                                 f"{text!r} (want stall=<seconds>)")
            if not stall_s > 0:
                raise ValueError(f"stall duration must be > 0, got "
                                 f"{stall_s} in {text!r}")
        if kind not in KINDS:
            raise ValueError(f"bad fault kind {parts[1]!r} "
                             f"(want one of {KINDS}, stall takes an "
                             f"optional stall=<seconds>)")
        prob = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        count = int(parts[3]) if len(parts) > 3 and parts[3] else None
        return cls(site=parts[0], kind=kind, prob=prob, count=count,
                   stall_s=stall_s)

    def exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count


def parse_specs(text: str) -> list:
    """Every spec in a comma-separated PIFFT_FAULT value."""
    return [FaultSpec.parse(part)
            for part in text.split(",") if part.strip()]


# env-armed specs, cached on the raw value so firing counters survive
# across probes and a changed value re-parses
_ENV_CACHE: list = [None, []]  # [raw value, parsed specs]
# context-manager-armed specs (stacked; inner scopes fire first)
_SCOPED: list = []
# deterministic by default so chaos runs reproduce; PIFFT_FAULT_SEED
# overrides
_RNG = random.Random(int(os.environ.get("PIFFT_FAULT_SEED", "0") or 0))


def _env_specs() -> list:
    raw = os.environ.get("PIFFT_FAULT", "")
    if raw != _ENV_CACHE[0]:
        try:
            parsed = parse_specs(raw)
        except ValueError as e:
            # a mistyped spec must not silently disable chaos: every
            # probe under the bad value raises (the cache key changes
            # only on a successful parse)
            raise ValueError(f"PIFFT_FAULT: {e}") from e
        _ENV_CACHE[0] = raw
        _ENV_CACHE[1] = parsed
    return _ENV_CACHE[1]


def active_specs() -> list:
    """Scoped (innermost first) then env-armed specs."""
    return list(reversed(_SCOPED)) + _env_specs()


def _raise_for(spec: FaultSpec, site: str) -> None:
    spec.fired += 1
    if spec.kind == "timeout":
        raise CollectiveTimeout(
            f"injected collective timeout at site {site!r} (rendezvous "
            f"deadline exceeded)")
    raise InjectedFault(_TEMPLATES[spec.kind].format(site=site))


def maybe_fault(site: str) -> None:
    """The probe: raise (or, for ``stall`` specs, delay) the armed fault
    for `site`, if one fires.  It runs on the host before anything is
    launched, so an injected fault propagates as a pre-launch refusal
    would, to the retry and degradation layers under test; it never
    runs inside a replayed CUDA graph."""
    if not _SCOPED and not _env_specs():
        return
    for spec in active_specs():
        if spec.exhausted() or not fnmatch.fnmatch(site, spec.site):
            continue
        if spec.prob >= 1.0 or _RNG.random() < spec.prob:
            if spec.kind == "stall":
                spec.fired += 1
                time.sleep(spec.stall_s)
                continue  # a stall delays; it never raises
            _raise_for(spec, site)


@contextmanager
def inject(site: str, kind: str, prob: float = 1.0,
           count: Optional[int] = None,
           stall_s: float = DEFAULT_STALL_S):
    """Scope a fault to a with-block; yields the live :class:`FaultSpec`
    so callers can read ``spec.fired``.  ``stall_s`` applies to
    ``kind="stall"`` only."""
    if kind not in KINDS:
        raise ValueError(f"bad fault kind {kind!r} (want one of {KINDS})")
    if kind == "stall" and not stall_s > 0:
        raise ValueError(f"stall duration must be > 0, got {stall_s}")
    spec = FaultSpec(site=site, kind=kind, prob=prob, count=count,
                     stall_s=stall_s)
    _SCOPED.append(spec)
    try:
        yield spec
    finally:
        _SCOPED.remove(spec)
