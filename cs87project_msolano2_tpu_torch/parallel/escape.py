"""The collective-free escape path (the reference's
``parallel/escape.py``): when a supervised collective wedges, re-plan
the sharded 2-D FFT / Poisson dataflow onto the paper's trade —
every rank holds the whole input and does the work the transposes used
to share out — and complete the run instead of hanging it.

The escape reproduces the all_to_all paths' arithmetic EXACTLY and only
re-plans the data movement: every 1-D transform runs through the same
per-shard-shape plan on the same contiguous values (each rank's block
of the primary path becomes one iteration of a loop over the blocks of
the whole input), so results are BIT-IDENTICAL to the primary path and
no collective is dispatched (``collectives.COLLECTIVE_CALLS`` does not
move; on a mesh position without process groups any collective would
raise).  What is spent is redundant work on every rank: the escape
completes a run, it does not win a benchmark, and every escape is
recorded as a ``collective_free`` demotion
(``resilience.degrade.note_collective_escape``).

Recovery loop (the resilient entry points of ``fft2d.py`` and
``poisson3d.py``, :func:`run_with_escape`):

1. the primary all_to_all path runs under
   ``resilience.supervise_collective`` — heartbeats per deadline, abort
   past the wait budget;
2. on :class:`CollectiveAborted` / :class:`CollectiveTimeout` (or when a
   position of the mesh has been reported unhealthy, which skips the
   doomed attempt entirely) all ranks agree on the fallback epoch first
   (``multihost.agree_on_fallback``), then
3. the escape body runs, the demotion is recorded, and the caller gets
   the values the primary path would have produced.

The reports of unhealthy devices are per process: a report has to be
made on every rank (the consensus keeps ranks from acting on a report
alone).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..obs import events
from ..resilience import (
    CollectiveAborted,
    CollectiveTimeout,
    FaultKind,
    classify,
    inject,
    supervise_collective,
)
from ..resilience.degrade import note_collective_escape
from ..utils.device import as_plane, as_planes

# ------------------------------------------------------ device health

_UNHEALTHY: dict = {}


def report_unhealthy(device, reason: str) -> None:
    """Report a device unhealthy: later resilient sharded calls on a
    mesh with a position on it skip the doomed collective attempt and
    take the escape path directly."""
    from ..plans.core import warn

    _UNHEALTHY[str(device)] = str(reason)
    events.emit("device_unhealthy", device=str(device),
                reason=str(reason)[:200])
    warn(f"device {device} reported unhealthy ({reason}); resilient "
         f"sharded paths will escape to collective_free")


def clear_unhealthy() -> None:
    _UNHEALTHY.clear()


def unhealthy_in(mesh) -> dict:
    """The unhealthy-device reports that apply to `mesh`."""
    devs = set(mesh.devices)
    return {d: r for d, r in _UNHEALTHY.items() if d in devs}


# ------------------------------------------------------- escape bodies


def _fft2_escape_fn(mesh, axis: str, inverse: bool, R: int, C: int):
    """The escape body of an (R, C) transform: (R, C) planes -> this
    rank's (R/p, C) rows, with no collective: the primary path's two
    phases (``fft2d.fft2_phases``) over every block."""
    from .fft2d import fft2_phases

    p = mesh.shape[axis]
    i = mesh.axis_index(axis)
    rp, cp = R // p, C // p

    def body(xr, xi):
        rows, cols = fft2_phases(R, C, p, xr.device, inverse)
        # every rank's row block — the redundancy buys the transpose
        blocks = [rows(xr[j * rp:(j + 1) * rp], xi[j * rp:(j + 1) * rp])
                  for j in range(p)]
        yr = torch.cat([b[0] for b in blocks], dim=0)
        yi = torch.cat([b[1] for b in blocks], dim=0)
        del blocks
        # every column block (the primary path's rank j works block
        # j), keeping this rank's rows of each
        outr, outi = [], []
        for j in range(p):
            cr, ci = cols(yr[:, j * cp:(j + 1) * cp],
                          yi[:, j * cp:(j + 1) * cp])
            outr.append(cr[i * rp:(i + 1) * rp])
            outi.append(ci[i * rp:(i + 1) * rp])
        return torch.cat(outr, dim=1), torch.cat(outi, dim=1)

    return body


def fft2_collective_free_planes(xr, xi, mesh, axis: str = "p",
                                inverse: bool = False):
    """2-D FFT with ZERO collectives — the escape body for
    ``fft2_sharded_planes``: xr/xi the whole (R, C) planes on every
    rank; returns this rank's (R/p, C) rows, bit for bit the primary
    path's.  Each rank runs the row pass of every row block and the
    column pass of every column block through the primary path's
    per-shard plans and keeps its rows.  R and C must be divisible by
    the axis size."""
    xr, xi = as_planes(xr, xi, mesh.device)
    R, C = xr.shape
    return _fft2_escape_fn(mesh, axis, inverse, R, C)(xr, xi)


def fft2_collective_free(x, mesh, axis: str = "p", inverse: bool = False):
    """Complex API over :func:`fft2_collective_free_planes`."""
    x = torch.as_tensor(x)
    yr, yi = fft2_collective_free_planes(x.real, x.imag, mesh, axis,
                                         inverse)
    return torch.complex(yr, yi)


def _poisson_escape_fn(mesh, axis: str, n1: int, n2: int, n3: int,
                       multiplier: Optional[Callable] = None):
    """The Poisson escape body: the whole real (n1, n2, n3) field -> this
    rank's (n1/p, n2, n3) slab of u, with no collective: the primary
    path's three phases (``apps.pde.slab_forward``, ``column_solve``,
    ``slab_inverse``) over every block."""
    from ..apps.pde import (
        block_multiplier,
        column_solve,
        poisson_multiplier,
        slab_forward,
        slab_inverse,
    )

    multiplier = multiplier or poisson_multiplier
    p = mesh.shape[axis]
    i = mesh.axis_index(axis)
    s1, s2 = n1 // p, n2 // p

    def body(f):
        # phase 1 of every slab j, as rank j runs it
        blocks = [slab_forward(f[j * s1:(j + 1) * s1]) for j in range(p)]
        gr = torch.cat([b[0] for b in blocks], dim=0)
        gi = torch.cat([b[1] for b in blocks], dim=0)
        del blocks
        # phase 2 of every n2-block j, with block j's multiplier
        cols = [column_solve(gr[:, j * s2:(j + 1) * s2],
                             gi[:, j * s2:(j + 1) * s2],
                             block_multiplier(multiplier, n1, n2, n3, j, p,
                                              f.device))
                for j in range(p)]
        gr = torch.cat([c[0] for c in cols], dim=1)
        gi = torch.cat([c[1] for c in cols], dim=1)
        del cols
        # phase 3: this rank's slab only
        return slab_inverse(gr[i * s1:(i + 1) * s1], gi[i * s1:(i + 1) * s1])

    return body


def poisson_solve_collective_free(f, mesh, axis: str = "p"):
    """Slab Poisson solve with ZERO collectives — the escape body for
    ``poisson_solve_sharded``: `f` the whole real (n1, n2, n3) field on
    every rank; returns this rank's (n1/p, n2, n3) slab, bit for bit the
    primary path's.  Every phase of the primary pipeline is replayed as
    a loop over the blocks of the whole field (same plan keys, same
    block multipliers); the rank keeps only its slab for the last
    inverse passes."""
    f = as_plane(f, mesh.device)
    n1, n2, n3 = f.shape
    return _poisson_escape_fn(mesh, axis, n1, n2, n3)(f)


# --------------------------------------------------- the recovery loop


@dataclasses.dataclass
class ShardedRunReport:
    """What a resilient sharded entry point did: whether the run
    ``escaped`` to the collective-free path (``degraded`` mirrors it:
    the performance contract changed, the values did not), the
    supervisor's deadline-wait count, the consensus ``epoch`` (None
    when no escape happened) and the demotion ``trail``."""

    label: str
    escaped: bool = False
    degraded: bool = False
    waits: int = 0
    epoch: Optional[int] = None
    trail: list = dataclasses.field(default_factory=list)

    def to_record(self) -> dict:
        return {"label": self.label, "escaped": self.escaped,
                "degraded": self.degraded, "waits": self.waits,
                "epoch": self.epoch, "trail": list(self.trail)}


def run_with_escape(primary: Callable, escape: Callable, label: str,
                    mesh, tagged_plans=(),
                    deadline_s: float | None = None,
                    abort_waits: Optional[int] = None,
                    supervise: bool = True):
    """The recovery loop (module docstring): supervise `primary`; on a
    wedged or doomed collective, reach consensus, record the
    ``collective_free`` demotion (tagging `tagged_plans` as any
    demotion), and run `escape`.  Returns ``(value,
    ShardedRunReport)``.  Faults that are not collective stalls
    propagate unchanged: a capacity fault inside the primary body
    belongs to the plan degradation chain, not to the transport
    escape."""
    from .multihost import agree_on_fallback

    report = ShardedRunReport(label)
    unhealthy = unhealthy_in(mesh)
    if unhealthy:
        exc: BaseException = CollectiveTimeout(
            f"{label}: device(s) reported unhealthy before dispatch: "
            + "; ".join(f"{d} ({r})" for d, r in unhealthy.items()))
    else:
        if not supervise:
            return primary(), report
        try:
            value, sup = supervise_collective(
                primary, label, deadline_s=deadline_s,
                abort_waits=abort_waits)
            report.waits = sup.fired
            return value, report
        except (CollectiveAborted, CollectiveTimeout) as e:
            exc = e
            sup = getattr(e, "report", None)
            if sup is not None:
                report.waits = sup.fired
    # every rank agrees on the fallback epoch before any switches: one
    # rank escaping alone would strand the rest in the next transpose
    report.epoch = agree_on_fallback(label, reason=str(exc)[:200],
                                     deadline_s=deadline_s)
    kind = classify(exc)
    report.trail.append(
        note_collective_escape(label, exc, kind or FaultKind.TRANSIENT,
                               plans=tagged_plans))
    report.escaped = True
    report.degraded = True
    value = escape()
    events.emit("collective_escape_completed", label=label,
                epoch=report.epoch, waits=report.waits)
    return value, report


# ------------------------------------------------------------- the drill


def stall_drill(entry: str, x, mesh, axis: str = "p",
                deadline_s: float = 0.5, abort_waits: int = 2,
                stall_s: float = 2.0) -> dict:
    """The stall -> abort -> consensus -> escape chain on this rank:
    the resilient `entry` ("fft2": `x` the whole complex (R, C) input;
    "poisson": the whole real (n1, n2, n3) field) once healthy, then
    once with a ``collective`` stall of `stall_s` injected (every rank
    of the job must run the drill: the stall is injected on every
    one).  Returns this rank's ``{"healthy", "escaped"}`` outputs, both
    reports and the collective layer's event kinds during the stalled
    run (observability armed around it where it is off) — what the
    multichip smoke, the tests and ``chip_smoke.py`` check."""
    from .. import obs
    from ..resilience.watchdog import recorded_kinds
    from . import collectives
    from .fft2d import fft2_sharded_resilient
    from .poisson3d import poisson_solve_sharded_resilient

    run = {"fft2": fft2_sharded_resilient,
           "poisson": poisson_solve_sharded_resilient}[entry]
    healthy, rep_ok = run(x, mesh, axis)
    calls0 = collectives.COLLECTIVE_CALLS
    with obs.armed(), recorded_kinds() as kinds, \
            inject("collective", "stall", stall_s=stall_s):
        escaped, rep = run(x, mesh, axis, deadline_s=deadline_s,
                           abort_waits=abort_waits)
    return {"healthy": healthy, "escaped": escaped,
            "report_ok": rep_ok.to_record(), "report": rep.to_record(),
            "collectives": collectives.COLLECTIVE_CALLS - calls0,
            "events": kinds}


def drill_rank(entry: str, x, drill: dict) -> dict:
    """:func:`stall_drill` (`drill`: its keyword arguments) on a 1-D
    mesh over the job, its tensors moved to the host: the rank program
    of ``multihost.spawn_local`` for the ``multichip smoke`` CLI."""
    from .mesh import make_mesh
    from .multihost import to_host

    return to_host(stall_drill(entry, x, make_mesh(), **drill))
