"""Resilience: classify the fault, retry what is transient, degrade what
is not, and journal, so a kill loses one cell and not the run (the
reference's ``resilience/`` package).

* ``taxonomy`` — :class:`PifftError` subclasses and :func:`classify`,
                 which tags any exception TRANSIENT / CAPACITY /
                 PERMANENT from its type and its CUDA error signature;
                 :func:`sticky`, true for the CUDA errors that poison
                 the context; :class:`KernelBuildError` for a kernel
                 that did not build or load.
* ``retry``    — :func:`with_retry` / :func:`call_with_retry`: bounded
                 attempts, exponential backoff with jitter, a policy per
                 FaultKind.
* ``degrade``  — the plan degradation chain (fourstep -> rql ->
                 ``torch.fft`` -> numpy) wired into ``plans.core.Plan``;
                 every demotion is recorded on the plan and announced
                 through ``plans.core.warn``.
* ``inject``   — fault injection (``PIFFT_FAULT=<site>:<kind>:<prob>`` or
                 the :func:`inject` context manager), so every policy
                 above is testable on the CPU.
* ``watchdog`` — collective supervision: :func:`collective_watchdog`
                 (a warn-only deadline with ``collective_recovered``
                 accounting) and :func:`supervise_collective`
                 (heartbeats, straggler notes, and a supervised abort
                 through :class:`CancellationToken` /
                 :class:`CollectiveAborted` that the sharded paths catch
                 to escape onto the collective-free path, the
                 ``collective_free`` rung of ``degrade``).
* ``journal``  — atomic per-cell JSONL checkpointing behind the bench's
                 ``--resume`` and the harness sweeps.
"""

from __future__ import annotations

from .degrade import (  # noqa: F401
    COLLECTIVE_FREE_RUNG,
    DEGRADE_CHAIN,
    note_collective_escape,
    promote_precision,
    resilient_executor,
)
from .inject import (  # noqa: F401
    KINDS,
    KNOWN_SITES,
    FaultSpec,
    InjectedFault,
    active_specs,
    inject,
    maybe_fault,
)
from .journal import Journal  # noqa: F401
from .retry import (  # noqa: F401
    FAST_POLICY,
    RetryPolicy,
    call_with_retry,
    with_retry,
)
from .taxonomy import (  # noqa: F401
    CapacityError,
    CollectiveAborted,
    CollectiveTimeout,
    FaultKind,
    HostDesyncError,
    KernelBuildError,
    LoweringError,
    PifftError,
    TransientBackendError,
    classify,
    sticky,
    wrap,
)
from .watchdog import (  # noqa: F401
    CancellationToken,
    SupervisionReport,
    WatchdogReport,
    collective_watchdog,
    rendezvous_deadline_s,
    supervise_collective,
)
