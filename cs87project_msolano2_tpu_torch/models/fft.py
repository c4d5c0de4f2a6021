"""Natural-order FFT APIs on top of the pi decomposition (complex64 in,
complex64 out, natural frequency order) — the reference's
``models/fft.py`` with a ``device=`` argument.

Dispatch goes through the plan layer: ``plans.plan_for(shape)`` picks
the kernel path for the shape and ``plan.execute`` runs it.  The
bit-reversal gather stays at the API boundary.  Numpy input goes to
``device`` (the card by default; ``device="cpu"`` runs the plain
versions); tensor input runs where it lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bits import to_natural
from ..utils.device import as_planes, resolve_device
from .pi_fft import pi_fft_pi_layout


def _complex_planes(x, device):
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve_device(device))
        if not x.is_complex():
            x = x.to(torch.complex64)
        return as_planes(x.real, x.imag)
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        x = x.astype(np.complex64)
    return as_planes(x.real, x.imag, device)


def fft(x, p: int = 1, tables=None, plan=None, precision: str | None = None,
        device=None):
    """1-D DFT over the trailing axis (complex in/out, natural order).

    At p=1 with no `tables` the transform dispatches through the plan
    layer (kernel paths on eligible shapes, the stage path elsewhere).
    An explicit `p` or `tables` (per-level (wr, wi) tensors, e.g. from
    ``ops.twiddle.tables_from_reference``) keeps the stage-by-stage pi
    decomposition.  The result is p-invariant."""
    xr, xi = _complex_planes(x, device)
    if p == 1 and tables is None:
        from .. import plans

        pl = plan if plan is not None else plans.plan_for(
            xr.shape, layout="natural", precision=precision,
            device=xr.device)
        yr, yi = pl.execute(xr, xi)
        return torch.complex(yr, yi)
    yr, yi = to_natural(*pi_fft_pi_layout(xr, xi, p, tables))
    return torch.complex(yr, yi)


def ifft(x, p: int = 1, tables=None, plan=None,
         precision: str | None = None, device=None):
    """Inverse DFT via conjugation: ifft(x) = conj(fft(conj(x))) / n."""
    xr, xi = _complex_planes(x, device)
    n = xr.shape[-1]
    y = fft(torch.complex(xr, -xi), p, tables, plan, precision)
    return torch.conj(y).resolve_conj() / n


def fft2(x, p: int = 1, precision: str | None = None, device=None):
    """2-D DFT over the trailing two axes via row then column 1-D
    passes, each with its own per-shape plan."""
    y = fft(x, p, precision=precision, device=device)
    y = fft(y.transpose(-1, -2).contiguous(), p, precision=precision)
    return y.transpose(-1, -2).contiguous()


def fftn(x, axes=None, p: int = 1, precision: str | None = None,
         device=None):
    """N-D DFT over `axes` (default: all) via successive 1-D passes."""
    xr, xi = _complex_planes(x, device)
    y = torch.complex(xr, xi)
    for ax in (range(y.dim()) if axes is None else axes):
        y = fft(y.movedim(ax, -1).contiguous(), p,
                precision=precision).movedim(-1, ax)
    return y.contiguous()


def fft_planes(xr, xi, p: int = 1, tables=None, device=None):
    """Natural-order DFT on split re/im float32 planes (trailing axis):
    the all-float32 stage path — the plan layer's "stages" variant."""
    xr, xi = as_planes(xr, xi, device)
    return to_natural(*pi_fft_pi_layout(xr, xi, p, tables))


def ifft_planes(xr, xi, p: int = 1, tables=None, device=None):
    """Inverse DFT on planes: conj trick, all-float."""
    xr, xi = as_planes(xr, xi, device)
    n = xr.shape[-1]
    yr, yi = fft_planes(xr, -xi, p, tables)
    return yr / n, -yi / n


def fft_planes_fast(xr, xi, natural: bool = True, plan=None,
                    precision: str | None = None, device=None):
    """Plane-level FFT through the plan layer — the hot path batched
    rows and large 1-D transforms take.  `natural=False` returns pi
    layout (per-row bit-reversed) and needs a kernel-eligible shape."""
    xr, xi = as_planes(xr, xi, device)
    if plan is None:
        from .. import plans

        plan = plans.plan_for(
            xr.shape, layout="natural" if natural else "pi",
            precision=precision, device=xr.device)
    return plan.execute(xr, xi)


def ifft_planes_fast(xr, xi, plan=None, precision: str | None = None,
                     device=None):
    """Inverse of fft_planes_fast (conj trick, same plan dispatch)."""
    xr, xi = as_planes(xr, xi, device)
    if plan is None:
        from .. import plans

        plan = plans.plan_for(xr.shape, layout="natural",
                              precision=precision, device=xr.device)
    return plan.execute_inverse(xr, xi)
