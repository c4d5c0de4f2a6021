"""Batched FFT, plain data parallelism over the mesh: BASELINE config 3
(the reference's ``parallel/batched.py``).  Each rank transforms its own
rows: like the pi funnel this needs no collective.

Kernel dispatch: one plan for the per-shard shape (the rows a rank
transforms), so the rank runs the kernels tuned for that key.
"""

from __future__ import annotations

import torch

from .. import plans
from ..utils.device import as_plane, as_planes


def fft_batched_planes(xr, xi, mesh, axis: str = "data",
                       inverse: bool = False, natural: bool = True,
                       precision: str | None = None,
                       domain: str = "c2c"):
    """1-D FFT along the trailing axis of this rank's (B/p, n) rows of
    re/im planes, the batch split over `axis`; returns its (B/p, n)
    rows.  Natural order by default; ``natural=False`` returns pi layout
    (per-row bit-reversed, forward only).  `precision` picks the
    per-shard plan's mode.  `domain`: "c2c" (default), "r2c" (real
    (B/p, n) rows in, xi ignored, (B/p, n//2+1) half-spectrum rows out)
    or "c2r" (the reverse) — the per-shard plan rides the c2c kernel at
    n/2, with no collective."""
    if domain != "c2c":
        if inverse:
            raise ValueError("inverse is the c2c conj trick; use "
                             "domain='c2r' for the real inverse")
        if not natural:
            raise ValueError(f"domain={domain!r} requires natural "
                             f"layout (the half-spectrum has no pi "
                             f"order)")
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r} ({mesh.shape})")
    if domain == "r2c":
        xr = as_plane(xr, mesh.device)
        xi = torch.zeros_like(xr)
    else:
        xr, xi = as_planes(xr, xi, mesh.device)
    local = tuple(xr.shape)
    if domain == "c2r":
        # the plan is keyed by the signal-side length; the input rows
        # carry n//2+1 half-spectrum bins
        local = local[:-1] + (2 * (local[-1] - 1),)
    plan = plans.plan_for(
        local, layout="natural" if (natural or inverse) else "pi",
        precision=precision, domain=domain, device=xr.device)
    if inverse:
        return plan.execute_inverse(xr, xi)
    return plan.execute(xr, xi)


def fft_batched_sharded(x, mesh, axis: str = "data",
                        inverse: bool = False):
    """Complex API over fft_batched_planes: this rank's complex (B/p, n)
    rows in and out."""
    x = torch.as_tensor(x)
    yr, yi = fft_batched_planes(x.real, x.imag, mesh, axis, inverse)
    return torch.complex(yr, yi)


def rfft_batched_sharded(x, mesh, axis: str = "data"):
    """Real-input half-spectrum over fft_batched_planes: this rank's real
    (B/p, n) rows in, complex (B/p, n//2+1) rows out."""
    x = torch.as_tensor(x)
    yr, yi = fft_batched_planes(x.real if x.is_complex() else x, None,
                                mesh, axis, domain="r2c")
    return torch.complex(yr, yi)

