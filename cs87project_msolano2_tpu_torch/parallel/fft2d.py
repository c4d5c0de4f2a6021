"""Distributed 2-D FFT (BASELINE config 4; the reference's
``parallel/fft2d.py``): row FFTs local, an ``all_to_all`` transpose,
column FFTs local, the transpose back.

The one place the port genuinely needs communication: the 2-D
transform's data dependencies span both axes.  The transposes go
through ``parallel.collectives`` (four a call: two transposes of two
planes), and :func:`fft2_sharded_resilient` wraps the path in the
recovery loop — collective supervision, fallback consensus and the
collective-free escape (``parallel/escape.py``).

Internals run on split re/im float32 planes; complex64 only at the API
edge.  Kernel dispatch: the row and column passes transform different
per-shard shapes — (R/p, C) rows before the transpose, (C/p, R) columns
after — so each takes the plan of its own key.
"""

from __future__ import annotations

import torch

from .. import plans
from ..utils.device import as_planes
from .collectives import all_to_all


def run_plan(plan, xr, xi, inverse: bool):
    """One pass of `plan`, forward or inverse."""
    if inverse:
        return plan.execute_inverse(xr, xi)
    return plan.execute(xr, xi)


def pass_plans(R: int, C: int, p: int, device):
    """(row plan, column plan) of an (R, C) transform over p ranks: the
    (R/p, C) rows before the transpose, the (C/p, R) columns after."""
    return (plans.plan_for((R // p, C), device=device),
            plans.plan_for((C // p, R), device=device))


def fft2_phases(R: int, C: int, p: int, device, inverse: bool):
    """The two phases of an (R, C) transform over p ranks, written once
    for the primary path and the escape: ``rows(xr, xi)`` takes a block
    of R/p rows through the row plan; ``cols(yr, yi)`` takes a block of
    C/p columns, (R, C/p), through the column plan (on its contiguous
    (C/p, R) transpose) and returns it as (R, C/p) views.  The primary
    path runs its own block of each with a transpose between; the
    escape runs every block of each, so the two run the same plans on
    the same contiguous values."""
    row_plan, col_plan = pass_plans(R, C, p, device)

    def rows(xr, xi):
        return run_plan(row_plan, xr, xi, inverse)

    def cols(yr, yi):
        cr, ci = run_plan(col_plan, yr.transpose(0, 1).contiguous(),
                          yi.transpose(0, 1).contiguous(), inverse)
        return cr.transpose(0, 1), ci.transpose(0, 1)

    return rows, cols


def fft2_sharded_planes(xr, xi, mesh, axis: str = "p",
                        inverse: bool = False):
    """2-D FFT of (R, C) re/im planes, rows split over the mesh axis:
    xr/xi this rank's (R/p, C) rows; returns its (R/p, C) rows of the
    transform.  R and C must be divisible by the axis size."""
    p = mesh.shape[axis]
    xr, xi = as_planes(xr, xi, mesh.device)
    rp, C = xr.shape
    rows, cols = fft2_phases(rp * p, C, p, xr.device, inverse)

    def a2a(v, split_axis, concat_axis):
        return all_to_all(v, axis, split_axis, concat_axis, mesh=mesh)

    yr, yi = rows(xr, xi)
    # the transpose: (R/p, C) -> (R, C/p)
    yr, yi = cols(a2a(yr, 1, 0), a2a(yi, 1, 0))
    # and back: (R, C/p) -> (R/p, C)
    return a2a(yr, 0, 1), a2a(yi, 0, 1)


def fft2_sharded(x, mesh, axis: str = "p", inverse: bool = False):
    """Complex API over fft2_sharded_planes: this rank's complex (R/p, C)
    rows in and out."""
    x = torch.as_tensor(x)
    yr, yi = fft2_sharded_planes(x.real, x.imag, mesh, axis, inverse)
    return torch.complex(yr, yi)


def block(value):
    """`value` after the card has finished it: a supervised region must
    contain its collectives' completion, not only their dispatch."""
    tensors = value if isinstance(value, (tuple, list)) else (value,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return value


def fft2_sharded_resilient(x, mesh, axis: str = "p",
                           inverse: bool = False,
                           deadline_s: float | None = None,
                           abort_waits: int | None = None):
    """Self-healing 2-D FFT: `x` the whole complex (R, C) input on every
    rank (the reference's host-staged view); the all_to_all path runs on
    the rank's rows under collective supervision and escapes to the
    collective-free path when a transpose wedges or a position of the
    mesh is reported unhealthy.  Returns ``(y, ShardedRunReport)``: `y`
    this rank's complex (R/p, C) rows, bit-identical either way; the
    report says whether the run escaped (``degraded`` / a
    ``collective_free`` rung in ``trail``)."""
    from .escape import fft2_collective_free_planes, run_with_escape

    x = torch.as_tensor(x)
    xr, xi = as_planes(x.real, x.imag, mesh.device)
    p = mesh.shape[axis]
    R, C = xr.shape
    # the plans the escape tags with the demotion (plan_for memoizes:
    # the objects both bodies run)
    tagged = pass_plans(R, C, p, xr.device)

    def primary():
        return block(fft2_sharded_planes(mesh.block(xr, axis),
                                         mesh.block(xi, axis), mesh,
                                         axis, inverse))

    def escape():
        return fft2_collective_free_planes(xr, xi, mesh, axis, inverse)

    (yr, yi), report = run_with_escape(
        primary, escape, f"fft2d all_to_all ({R}x{C}, p={p})", mesh,
        tagged_plans=tagged, deadline_s=deadline_s,
        abort_waits=abort_waits)
    return torch.complex(yr, yi), report
