"""The sharded pi-FFT: the paper's zero-communication claim across
ranks (the reference's ``parallel/pi_shard.py``).

Every rank holds the whole input (the reference broadcasts the input
into every processor's scratchpad), runs its own funnel chain
(``funnel_single`` with its mesh coordinate) and its local tube, and
returns its segment of the pi-layout output.  No collective is
dispatched: ``collectives.COLLECTIVE_CALLS`` does not move, which is the
port's form of the reference's check that the compiled program holds no
collective op.

Kernel dispatch: each rank's tube is a standalone (n/p)-point pi-layout
transform, resolved by ``models.pi_fft.resolve_tube_plan``: the plan
layer serves the segment's shape (rql, fourstep, sixstep, or rows for a
batch of short segments).  The plan engages by default above
``PLAN_SEGMENT_MIN``; pass ``plan=`` to force one, or ``plan=False`` to
pin the stage tube.
"""

from __future__ import annotations

from ..models.pi_fft import funnel_single, resolve_tube_plan, tube
from ..ops.twiddle import device_tables
from ..resilience.inject import maybe_fault
from ..utils.device import as_planes

#: segment length above which the plan path engages by default (the
#: reference's: its unrolled tube's compile time explodes past one
#: on-chip tile, which is also where the kernels start to matter)
PLAN_SEGMENT_MIN = 1 << 16


def rank_body(xr, xi, pi, p, plan, tables):
    """Processor `pi`'s funnel chain, then its tube: (..., n) planes ->
    (..., n/p) planes."""
    n = xr.shape[-1]
    fr, fi = funnel_single(xr, xi, pi, p, tables)
    if plan is not None:
        return plan.execute(fr, fi)
    return tube(fr, fi, n, p, tables)


def pi_fft_sharded(xr, xi, mesh, axis: str = "p", plan=None):
    """pi-FFT over the mesh axis `axis`: xr/xi the whole (n,) input
    (replicated on every rank); returns this rank's (n/p,) segment of
    the pi-layout output.  `plan` routes the tube through the plan
    layer (module docstring); the funnel is the replicated chain either
    way, so no collective is made."""
    maybe_fault("shard")
    p = mesh.shape[axis]
    xr, xi = as_planes(xr, xi, mesh.device)
    n = xr.shape[-1]
    seg_plan = resolve_tube_plan((n // p,), plan,
                                 min_segment=PLAN_SEGMENT_MIN,
                                 device=xr.device)
    return rank_body(xr, xi, mesh.axis_index(axis), p, seg_plan,
                      device_tables(n, xr.device))


def pi_fft_sharded_batched(xr, xi, mesh, data_axis: str = "data",
                           seq_axis: str = "p", plan=None):
    """Batched pi-FFT over a (data x p) mesh: batches split over
    `data_axis` (plain data parallelism), each signal decomposed over
    `seq_axis`.  xr/xi: this rank's (B/dp, n) rows (whole along the
    sequence); returns its (B/dp, n/p) block.  Still no collective; the
    tube's plan is keyed on the (B/dp, n/p) block the rank
    transforms."""
    maybe_fault("shard")
    p = mesh.shape[seq_axis]
    xr, xi = as_planes(xr, xi, mesh.device)
    b, n = xr.shape
    seg_plan = resolve_tube_plan((b, n // p), plan,
                                 min_segment=PLAN_SEGMENT_MIN,
                                 device=xr.device)
    tr, ti = rank_body(xr, xi, mesh.axis_index(seq_axis), p, seg_plan,
                        device_tables(n, xr.device))
    return tr.reshape(b, n // p), ti.reshape(b, n // p)

