"""The pi-FFT: the communication-free funnel/tube decomposition on
tensors.

For N = 2^m inputs and P = 2^k virtual processors (the reference's
``models/pi_fft.py``, same semantics as the native core):

* ``funnel``: log2(P) replicated half-butterfly stages.  Processor Pi
  keeps, at stage i, the half of its working set selected by bit
  (k-1-i) of Pi, halving it N -> N/2 -> ... -> N/P.  All P processors
  are rows of one tensor, so the funnel is a dense (P, len) computation
  — the paper's redundant-compute-instead-of-communication trade.
* ``tube``: log2(N/P) full DIF stages confined to each row's segment.

The concatenation of the P segments is the global DIF output, the DFT in
bit-reversed order ("pi layout").  Twiddle tables are per-level (wr, wi)
tensors (``ops.twiddle.device_tables`` / ``tables_from_reference``).
"""

from __future__ import annotations

import torch

from ..ops.bits import ilog2
from ..ops.butterfly import stage_full, stage_half
from ..ops.twiddle import device_tables


def _tables_for(n, tables, device):
    return device_tables(n, device) if tables is None else tables


#: elements of the (..., rows, len / 2) block one funnel stage computes
#: at once: above it the stage runs over blocks of processor rows, so its
#: temporaries (about six planes of the block) stay near 6 GB instead of
#: growing with p * n — 64 GB at n = 2^24, p = 256 in one piece
FUNNEL_BLOCK_ELEMENTS = 1 << 28


def _stage_half_blocked(cr, ci, wr, wi, bottom):
    """``stage_half`` of (..., p, len) planes, over blocks of the p rows
    where the whole stage would pass FUNNEL_BLOCK_ELEMENTS; the same
    arithmetic on every element, so the result is the same bits."""
    p, half = cr.shape[-2], cr.shape[-1] // 2
    lead = 1
    for d in cr.shape[:-2]:
        lead *= d
    rows = max(1, FUNNEL_BLOCK_ELEMENTS // (lead * half))
    if rows >= p:
        return stage_half(cr, ci, wr, wi, bottom)
    outr = torch.empty(cr.shape[:-1] + (half,), dtype=cr.dtype,
                       device=cr.device)
    outi = torch.empty_like(outr)
    for a in range(0, p, rows):
        br, bi = stage_half(cr[..., a:a + rows, :], ci[..., a:a + rows, :],
                            wr, wi, bottom[a:a + rows])
        outr[..., a:a + rows, :] = br
        outi[..., a:a + rows, :] = bi
    return outr, outi


def funnel(xr, xi, p, tables=None):
    """Replicated funnel phase.  xr/xi: (..., n) -> (..., p, n // p)."""
    n = xr.shape[-1]
    k = ilog2(p)
    tables = _tables_for(n, tables, xr.device)
    cr = xr.unsqueeze(-2).expand(*xr.shape[:-1], p, n)
    ci = xi.unsqueeze(-2).expand(*xi.shape[:-1], p, n)
    pis = torch.arange(p, dtype=torch.int32, device=xr.device)[:, None]
    for i in range(k):
        wr, wi = tables[i]
        bottom = (pis >> (k - 1 - i)) & 1
        cr, ci = _stage_half_blocked(cr, ci, wr, wi, bottom)
    return cr, ci


def funnel_single(xr, xi, pi, p, tables=None):
    """Funnel for ONE processor with id `pi`: (..., n) -> (..., n // p).
    Identical math to `funnel`; each processor touches only its own
    shrinking chain."""
    n = xr.shape[-1]
    k = ilog2(p)
    tables = _tables_for(n, tables, xr.device)
    cr, ci = xr, xi
    for i in range(k):
        wr, wi = tables[i]
        bottom = (int(pi) >> (k - 1 - i)) & 1
        cr, ci = stage_half(cr, ci, wr, wi, bottom)
    return cr, ci


def tube(sr, si, n, p, tables=None):
    """Segment-local tube phase: full DIF over the trailing axis of
    (..., s) planes, s = n // p.  Twiddle levels continue where the
    funnel stopped (level log2(p) of the n-point plan)."""
    k = ilog2(p)
    s = sr.shape[-1]
    tables = _tables_for(n, tables, sr.device)
    for i in range(ilog2(s)):
        wr, wi = tables[k + i]
        sr, si = stage_full(sr, si, wr, wi)
    return sr, si


def pi_fft_pi_layout(xr, xi, p, tables=None):
    """Full pi-FFT, output in pi layout.  xr/xi: (..., n) -> (..., n)."""
    n = xr.shape[-1]
    tables = _tables_for(n, tables, xr.device)
    fr, fi = funnel(xr, xi, p, tables)
    tr, ti = tube(fr, fi, n, p, tables)
    return tr.reshape(*xr.shape[:-1], n), ti.reshape(*xi.shape[:-1], n)
