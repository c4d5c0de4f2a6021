"""Resilience: classify the fault so a policy knows what to do with it
(the reference's ``resilience/`` package).

* ``taxonomy`` — :class:`PifftError` subclasses and :func:`classify`,
                 which tags any exception TRANSIENT / CAPACITY /
                 PERMANENT from its type and its CUDA error signature,
                 and :func:`sticky`, true for the CUDA errors that
                 poison the context.  The autotuner records a rejected
                 candidate's kind and aborts its race on a sticky error.

Retry, the degradation chain, fault injection, collective supervision
and the journal are not ported yet.
"""

from __future__ import annotations

from .taxonomy import (  # noqa: F401
    CapacityError,
    CollectiveAborted,
    CollectiveTimeout,
    FaultKind,
    HostDesyncError,
    LoweringError,
    PifftError,
    TransientBackendError,
    classify,
    sticky,
    wrap,
)
