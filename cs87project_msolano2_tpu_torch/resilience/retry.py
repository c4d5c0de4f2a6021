"""``with_retry``: bounded attempts with exponential backoff and jitter,
the policy keyed on the :class:`~.taxonomy.FaultKind` of each failure
(the reference's ``resilience/retry.py``).

TRANSIENT faults (a busy device, a dropped connection) get 4 attempts on
a 30/60/120 s ladder; CAPACITY and PERMANENT faults, and ValueError's
"this cell is infeasible" contract, get exactly 1: an out-of-memory
retried is an out-of-memory again, and the degradation chain
(``resilience.degrade``), not repetition, is the answer.  ``sleep`` and
``rng`` are injectable so tests hold the schedule to a mock clock.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import sys
import time
from typing import Callable, Optional

from ..obs import events, metrics
from .taxonomy import FaultKind, classify

#: attempts per kind where the policy does not override them
DEFAULT_ATTEMPTS = {
    FaultKind.TRANSIENT: 4,
    FaultKind.CAPACITY: 1,
    FaultKind.PERMANENT: 1,
}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How many attempts each FaultKind earns and how long to wait.

    The pause before retry ``i`` (1-based) is
    ``base_s * factor**(i-1) * (1 + jitter * u)`` with ``u`` uniform in
    [0, 1), capped at ``max_backoff_s``."""

    attempts: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ATTEMPTS))
    base_s: float = 30.0
    factor: float = 2.0
    jitter: float = 0.25
    max_backoff_s: float = 600.0

    def attempts_for(self, kind: FaultKind) -> int:
        return max(int(self.attempts.get(kind,
                                         DEFAULT_ATTEMPTS[kind])), 1)

    def backoff_s(self, retry_index: int, u: float) -> float:
        """Pause before the `retry_index`-th retry (1-based); `u` is the
        caller's uniform sample, so a schedule is testable."""
        raw = self.base_s * (self.factor ** (retry_index - 1))
        return min(raw * (1.0 + self.jitter * u), self.max_backoff_s)


#: for interactive and smoke runs, where sleeping 30 s on a blip costs
#: more than the retry saves
FAST_POLICY = RetryPolicy(base_s=0.05, max_backoff_s=1.0)


def call_with_retry(fn: Callable, *args,
                    policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable] = None,
                    label: str = "",
                    sleep: Callable = time.sleep,
                    rng: Callable = random.random,
                    **kwargs):
    """``fn(*args, **kwargs)`` under `policy`.

    Each failure is classified; a kind whose budget is 1 (CAPACITY and
    PERMANENT by default, ValueError among them) re-raises at once, a
    TRANSIENT fault is retried with backoff until its budget is spent,
    then re-raised.  ``on_retry(exc, attempt, pause_s)`` runs before
    each pause (else one line goes to stderr).  The budget is per kind
    within one call."""
    policy = policy or RetryPolicy()
    used: dict = {}
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            kind = classify(e)
            used[kind] = used.get(kind, 0) + 1
            if used[kind] >= policy.attempts_for(kind):
                events.emit("retry_exhausted", label=label,
                            kind=kind.value, attempts=used[kind],
                            error=f"{type(e).__name__}: {str(e)[:200]}")
                raise
            pause = policy.backoff_s(used[kind], rng())
            metrics.inc("pifft_retries_total", kind=kind.value)
            events.emit("retry", label=label, kind=kind.value,
                        attempt=used[kind], pause_s=round(pause, 3),
                        error=f"{type(e).__name__}: {str(e)[:200]}")
            if on_retry is not None:
                on_retry(e, used[kind], pause)
            else:
                print(f"# {kind.value} fault"
                      + (f" in {label}" if label else "")
                      + f" ({type(e).__name__}: {str(e)[:120]}); retry "
                        f"{used[kind]}/{policy.attempts_for(kind) - 1} "
                        f"in {pause:.1f}s", file=sys.stderr)
            sleep(pause)


def with_retry(fn: Optional[Callable] = None, *,
               policy: Optional[RetryPolicy] = None,
               on_retry: Optional[Callable] = None,
               label: str = "",
               sleep: Callable = time.sleep,
               rng: Callable = random.random):
    """Decorator form of :func:`call_with_retry`: ``@with_retry`` bare
    or ``@with_retry(policy=..., on_retry=...)``."""

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def run(*args, **kwargs):
            return call_with_retry(
                f, *args, policy=policy, on_retry=on_retry,
                label=label or getattr(f, "__name__", ""),
                sleep=sleep, rng=rng, **kwargs)

        return run

    return deco if fn is None else deco(fn)
