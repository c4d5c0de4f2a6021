"""Radix-2 decimation-in-frequency butterfly stages on split re/im
float32 tensors.

Complex values travel as separate re/im planes, as in the reference
(``ops/butterfly.py``), and the funnel's half choice is branchless: the
select folds into a sign and a twiddle factor.  Every stage is a
reshape + elementwise op over the trailing axis and broadcasts over any
leading axes (rows of virtual processors, batches, ...).
"""

from __future__ import annotations

import torch


def stage_full(xr, xi, wr, wi):
    """One full DIF stage over the trailing axis.

    Butterfly size L = 2 * wr.shape[-1]; for each size-L block with halves
    (a, b): top half -> a + b, bottom half -> (a - b) * w.
    xr/xi: (..., len) with len % L == 0.  Returns new tensors of the same
    shape.
    """
    half = wr.shape[-1]
    shape = xr.shape
    xr = xr.reshape(*shape[:-1], -1, 2, half)
    xi = xi.reshape(*shape[:-1], -1, 2, half)
    ar, br = xr[..., 0, :], xr[..., 1, :]
    ai, bi = xi[..., 0, :], xi[..., 1, :]
    tr, ti = ar + br, ai + bi
    dr, di = ar - br, ai - bi
    ur = dr * wr - di * wi
    ui = dr * wi + di * wr
    outr = torch.stack((tr, ur), dim=-2).reshape(shape)
    outi = torch.stack((ti, ui), dim=-2).reshape(shape)
    return outr, outi


def stage_half(xr, xi, wr, wi, bottom):
    """One funnel half-butterfly: keep only the half selected by `bottom`.

    xr/xi: (..., len) — exactly one size-len butterfly.  `bottom` is an
    integer tensor (or int) broadcastable against (..., half), e.g. shape
    (p, 1) over p virtual processors: 0 -> top half a + b, 1 -> bottom
    half (a - b) * w.  Branchless: out = (a + s*b) * f with
    s = 1 - 2*bottom, f = bottom ? w : 1.  Returns (..., len // 2).
    """
    half = xr.shape[-1] // 2
    if not isinstance(bottom, torch.Tensor):
        # a fill on the device, not a copy from the host: a funnel chain
        # of one processor (funnel_single) stays capturable in a graph
        bottom = torch.full((), int(bottom), dtype=torch.int64,
                            device=xr.device)
    ar, br = xr[..., :half], xr[..., half:]
    ai, bi = xi[..., :half], xi[..., half:]
    s = (1 - 2 * bottom).to(xr.dtype)
    dr = ar + s * br
    di = ai + s * bi
    sel = bottom != 0
    fr = torch.where(sel, wr, torch.ones_like(wr))
    fi = torch.where(sel, wi, torch.zeros_like(wi))
    outr = dr * fr - di * fi
    outi = dr * fi + di * fr
    return outr, outi
