"""Typed failure taxonomy: every fault the port's CUDA stack can hit,
named, and :func:`classify` mapping any raised exception onto the three
recovery classes the policies key on (the reference's
``resilience/taxonomy.py``).

CUDA errors reach Python as text: a kernel wrapper raises RuntimeError
with the launch's ``cudaError_t`` name and message, PyTorch raises its
own errors with the runtime's message.  So classification is by
exception TYPE first (our own :class:`PifftError` subclasses carry their
kind; MemoryError, connection errors and ValueError/TypeError have
unambiguous meanings, as in the reference) and message PATTERN second.
The patterns are the CUDA runtime's own names and messages
(``cudaGetErrorName`` / ``cudaGetErrorString``).

:func:`sticky` names the errors that poison the CUDA context: after an
illegal or misaligned address or a launch failure every later call in
the process fails, so a caller that would try the next thing (a tuning
race, a degrade chain) must stop instead.
"""

from __future__ import annotations

import enum
import re


class FaultKind(enum.Enum):
    """What a fault means for the recovery policy.

    TRANSIENT — the operation is fine, the moment was not (a dropped
    connection, a busy device): retry with backoff.  CAPACITY — the
    configuration asks for more than the card has (device memory,
    registers or shared memory per launch, blocks a cooperative launch
    can keep resident): retrying is futile, demote to a leaner plan.
    PERMANENT — the program itself is wrong for this card (an invalid
    argument, an infeasible blocking, a faulting kernel): neither retry
    nor the same plan again.
    """

    TRANSIENT = "transient"
    CAPACITY = "capacity"
    PERMANENT = "permanent"


class PifftError(RuntimeError):
    """Base of the typed failure taxonomy; ``kind`` drives policy."""

    kind = FaultKind.PERMANENT


class TransientBackendError(PifftError):
    """Infrastructure blinked: a connection drop, a busy device — retry
    with backoff."""

    kind = FaultKind.TRANSIENT


class CapacityError(PifftError):
    """The configuration exceeds the card (device memory, launch
    resources, cooperative residency) — demote, don't retry."""

    kind = FaultKind.CAPACITY


class LoweringError(PifftError):
    """The kernel cannot build or run on this card (an nvcc/ptxas
    failure, no kernel image, a faulting launch) — permanent for this
    plan, demote."""

    kind = FaultKind.PERMANENT


class CollectiveTimeout(TransientBackendError):
    """A collective rendezvous exceeded its deadline.  Transient: the
    operation was fine, the rendezvous was not."""


class CollectiveAborted(CollectiveTimeout):
    """A supervised collective region was abandoned after overrunning
    its abort budget.  Still TRANSIENT for the classifier; callers that
    can re-plan catch it explicitly."""


class HostDesyncError(PifftError):
    """Processes disagree about the job topology (process count or
    device mismatch) — no local retry can fix it."""

    kind = FaultKind.PERMANENT


# message signatures, checked in order: CAPACITY before TRANSIENT, both
# before the PERMANENT default.  Sources: the CUDA runtime's error names
# and strings (cudaErrorMemoryAllocation "out of memory",
# cudaErrorLaunchOutOfResources "too many resources requested for
# launch", cudaErrorCooperativeLaunchTooLarge "too many blocks in
# cooperative launch") and PyTorch's allocator ("CUDA out of memory").
_CAPACITY_PAT = re.compile(
    r"out of memory|cudaErrorMemoryAllocation|\bOOM\b"
    r"|too many resources requested|cudaErrorLaunchOutOfResources"
    r"|cooperative launch too large|too many blocks in cooperative launch"
    r"|cudaErrorCooperativeLaunchTooLarge",
    re.IGNORECASE)
_TRANSIENT_PAT = re.compile(
    r"connection (reset|refused|closed|aborted)|broken pipe|socket"
    r"|busy or unavailable|cudaErrorDevicesUnavailable|timed out"
    r"|temporarily",
    re.IGNORECASE)
# the context-poisoning errors: cudaErrorIllegalAddress ("an illegal
# memory access was encountered"), cudaErrorMisalignedAddress
# ("misaligned address"), cudaErrorLaunchFailure ("unspecified launch
# failure"); PERMANENT, and sticky
_STICKY_PAT = re.compile(
    r"illegal (memory access|address)|cudaErrorIllegalAddress"
    r"|misaligned address|cudaErrorMisalignedAddress"
    r"|unspecified launch failure|cudaErrorLaunchFailure",
    re.IGNORECASE)
_LOWERING_PAT = re.compile(
    r"nvcc|ptxas|no kernel image|invalid device function|launch failed"
    r"|" + _STICKY_PAT.pattern,
    re.IGNORECASE)
_DESYNC_PAT = re.compile(
    r"desync|process (id|index|count).*mismatch"
    r"|different number of (processes|devices)|world size",
    re.IGNORECASE)


def _message(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


def classify(exc: BaseException) -> FaultKind:
    """Map any exception to the FaultKind the recovery policies key on.

    Our own :class:`PifftError` subclasses carry their kind; unambiguous
    builtin types short-circuit (MemoryError is CAPACITY, connection/
    timeout errors are TRANSIENT, ValueError/TypeError — the "this cell
    is infeasible" contract, which the port's pre-launch shared-memory
    checks raise — are PERMANENT); everything else is classified by its
    CUDA message signature, defaulting to PERMANENT (the safe default:
    an unknown fault must not be retried into a corrupted row)."""
    if isinstance(exc, PifftError):
        return exc.kind
    if isinstance(exc, MemoryError):
        return FaultKind.CAPACITY
    if isinstance(exc, (ConnectionError, TimeoutError, BrokenPipeError,
                        EOFError)):
        return FaultKind.TRANSIENT
    if isinstance(exc, (ValueError, TypeError, NotImplementedError,
                        AssertionError)):
        return FaultKind.PERMANENT
    msg = _message(exc)
    if _CAPACITY_PAT.search(msg):
        return FaultKind.CAPACITY
    if _TRANSIENT_PAT.search(msg):
        return FaultKind.TRANSIENT
    return FaultKind.PERMANENT


def sticky(exc: BaseException) -> bool:
    """True for a CUDA error that leaves the context unusable (illegal
    or misaligned address, launch failure): every later launch in the
    process fails too, so nothing may be tried after it."""
    return bool(_STICKY_PAT.search(_message(exc)))


_WRAPPERS = {
    FaultKind.TRANSIENT: TransientBackendError,
    FaultKind.CAPACITY: CapacityError,
    FaultKind.PERMANENT: LoweringError,
}


def wrap(exc: BaseException) -> PifftError:
    """The typed form of `exc`: PifftErrors pass through; anything else
    is wrapped in the subclass matching its classification (PERMANENT
    faults get :class:`LoweringError` when the message looks like a
    build or launch failure, :class:`HostDesyncError` on a desync
    signature, plain :class:`PifftError` otherwise), with ``__cause__``
    preserved so the original traceback survives."""
    if isinstance(exc, PifftError):
        return exc
    kind = classify(exc)
    cls = _WRAPPERS[kind]
    if kind is FaultKind.PERMANENT:
        msg = _message(exc)
        if _DESYNC_PAT.search(msg):
            cls = HostDesyncError
        elif not _LOWERING_PAT.search(msg):
            cls = PifftError
    wrapped = cls(_message(exc))
    wrapped.__cause__ = exc
    return wrapped
