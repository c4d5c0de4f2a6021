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

Three tubes compute the same segment transform: ``tube`` (the unrolled
stages), ``tube_scan`` (the constant-geometry stages, ``fft_stages_scan``)
and ``tube_planned`` (the segment as a standalone s-point pi-layout plan
from ``plans``, so on the kernels of the ladder).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.spans import span as _span
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
    """Replicated funnel phase.  xr/xi: (..., n) -> (..., p, n // p).

    The phase runs under an observability span (``annotate=True`` also
    names it in a ``torch.profiler`` trace and as an NVTX range); when
    the obs subsystem is disabled the span is a shared no-op.  The span
    covers the host's launch time, not device time (CUDA launches are
    asynchronous), and inside a captured CUDA graph it runs once per
    capture."""
    n = xr.shape[-1]
    with _span("funnel", cell={"n": n, "p": p}, annotate=True):
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
    with _span("tube", cell={"n": n, "p": p}, annotate=True):
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


def resolve_tube_plan(shape, plan=None, precision=None, min_segment=None,
                      device="cuda"):
    """The tube-plan resolution of ``tube_planned`` and the sharded
    paths, the reference's policy case for case: an explicit Plan passes
    through, ``False`` pins the stage tube (None), and otherwise the
    plan for `shape` on `device` — None (the stage tube) where the
    segment is at or below `min_segment`, where the plan layer has no
    kernel for the shape (``plans.plan_for`` raises ValueError: segments
    shorter than the row kernel's least tile), or where it would serve
    the ``stages`` variant.  A batch of segments longer than 2^16 takes
    ``rql``, where the reference's plan layer refuses it.

    A fault while resolving (the ``resolve`` injection site, or the plan
    layer failing): on the CPU a CAPACITY or PERMANENT one gives None
    with one ``plans.warn`` line, as in the reference, and a TRANSIENT
    one re-raises for the retry layer; on the card every one re-raises,
    as the degradation chain ends at the kernel rungs there, so that no
    fault sends card planes to the plain stage tube.  Faults while the
    plan executes are its degradation chain's."""
    if plan is False:
        return None
    if plan is not None:
        return plan
    if min_segment is not None and shape[-1] <= min_segment:
        return None
    from .. import plans
    from ..resilience import FaultKind, classify, maybe_fault

    try:
        maybe_fault("resolve")
        resolved = plans.plan_for(shape, layout="pi", precision=precision,
                                  device=device)
    except ValueError:
        return None
    except Exception as e:
        kind = classify(e)
        if kind is FaultKind.TRANSIENT or torch.device(device).type != "cpu":
            raise
        plans.warn(f"tube-plan resolution for shape {tuple(shape)} "
                   f"DEGRADED to the stage tube ({kind.value}: "
                   f"{type(e).__name__}: {str(e)[:200]})")
        return None
    return None if resolved.variant == "stages" else resolved


def tube_planned(sr, si, n, p, plan=None, precision=None):
    """Tube phase through the plan layer: a segment's tube is a
    standalone s-point pi-layout transform (the n-plan's levels k..
    are a fresh s-plan's levels 0..), so the plan for the segments'
    shape serves it — ``rql``, ``fourstep`` or ``sixstep`` for a 1-D
    segment above 2^16, ``rows`` for a batch of segments of at most
    2^16, ``rql`` for a batch of longer ones.  The stage ``tube`` serves
    whatever ``resolve_tube_plan`` gives no plan."""
    plan = resolve_tube_plan(sr.shape, plan, precision, device=sr.device)
    if plan is None:
        return tube(sr, si, n, p)
    with _span("tube", cell={"n": n, "p": p, "variant": plan.variant},
               annotate=True):
        return plan.execute(sr, si)


def fft_stages_scan(xr, xi):
    """All log2(m) DIF stages over the trailing axis in one constant
    geometry (the Pease FFT): every stage pairs the two halves (a, b) =
    (x[:m/2], x[m/2:]), computes (a + b, (a - b) * w_l) and writes the
    two results interleaved; with stage-l twiddles w_l[pos] =
    W_m^{(pos >> l) << l} the result is the standard DIF output (pi
    layout) with no permutation.  The twiddles are the reference's:
    k = (pos >> l) << l, the float32 angle k * (-2 pi / m), cos and sin
    on the device.  k * (-2 pi / m) is the reference's angle only while
    k is exact in float32, k < 2^24, so for m <= 2^25.  A plain loop over
    the stages: eager PyTorch has no compile ceiling to keep it under."""
    m = xr.shape[-1]
    levels = ilog2(m)
    if levels == 0:
        return xr, xi
    h = m // 2
    pos = torch.arange(h, dtype=torch.int32, device=xr.device)
    step = float(np.float32(-2.0 * np.pi / m))
    shape = xr.shape
    cr, ci = xr, xi
    for lvl in range(levels):
        ar, br = cr[..., :h], cr[..., h:]
        ai, bi = ci[..., :h], ci[..., h:]
        ang = ((pos >> lvl) << lvl).to(torch.float32) * step
        wr, wi = torch.cos(ang), torch.sin(ang)
        dr, di = ar - br, ai - bi
        ur = dr * wr - di * wi
        ui = dr * wi + di * wr
        cr = torch.stack((ar + br, ur), dim=-1).reshape(shape)
        ci = torch.stack((ai + bi, ui), dim=-1).reshape(shape)
    return cr, ci


def tube_scan(sr, si, n, p):
    """Tube phase on the constant-geometry stages: the segment-local
    s-point DIF of ``tube``, by ``fft_stages_scan``."""
    with _span("tube", cell={"n": n, "p": p}, annotate=True):
        return fft_stages_scan(sr, si)


def pi_fft_pi_layout_scan(xr, xi, p, tables=None):
    """pi-FFT with the funnel (log2 p stages) and the constant-geometry
    tube.  xr/xi: (..., n) -> (..., n), pi layout."""
    n = xr.shape[-1]
    fr, fi = funnel(xr, xi, p, _tables_for(n, tables, xr.device))
    tr, ti = tube_scan(fr, fi, n, p)
    return tr.reshape(*xr.shape[:-1], n), ti.reshape(*xi.shape[:-1], n)
