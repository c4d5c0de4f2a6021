"""The tensor backends: the funnel/tube pi-FFT on tensors.

``torch`` and ``torch-unrolled`` are the counterparts of the
reference's ``jax`` and ``jax-unrolled`` backends (the plain funnel and
the unrolled stage tube), ``torch-scan`` of ``jax-scan`` (the
constant-geometry tube, ``models.pi_fft.tube_scan``), ``einsum`` of
``einsum`` (the phased einsum model, ``models.direct_dft``), ``cuda``
of ``pallas`` (the funnel as tensor ops, then the tube on the CUDA
kernels, ``ops.cuda_fft.tube_cuda``).  ``torch`` takes the stage tube
at every n: the reference's ``jax`` switches to the scan tube from
``SCAN_MIN_N`` for XLA's compile time, which eager PyTorch does not
have, so ``torch`` and ``torch-unrolled`` are one path under two names.

Phase timers follow the reference's contract: funnel and tube are timed
apart and total_ms = funnel_ms + tube_ms.  On the card each phase is
timed by the loop slope (``utils.timing.slope_ms``: calls captured in a
CUDA graph, rotating over copies of their operands, the window fitted
to the call's length), the reference's timer for its accelerator rows;
p = 1 has no funnel and charges 0.  Where a slope cannot be resolved
both phases are timed by CUDA events instead and the result is marked
``degraded``.  On the CPU the host clock times them (``time_ms``).

The ``einsum`` tube is a dense s-point DFT per segment: Theta(s^2)
products and a Theta(s^2) twiddle gather.  Each of the s^2 gathered
entries costs about 48 bytes of device traffic (its int64 index written
and read twice, two float32 entries written, then read by four
products), so one application at s moves about 48 s^2 bytes.  On the
card it takes the reference's blocking (``einsum_tube_kblock``: past
EINSUM_TUBE_MAX_S the rows go in host-driven blocks of kblock) and
refuses s above EINSUM_TUBE_ABS_MAX_S = 2^17, where an application
moves about 0.8 TB; every doubling of s quadruples it.  Its golden test
has a tolerance (1e-4): a dense product does not land on the golden
integers bit for bit.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..models.pi_fft import funnel, tube, tube_scan
from ..ops.cuda_fft import tube_cuda
from ..ops.twiddle import device_tables
from ..utils.debug import check_finite
from ..utils.device import as_planes, resolve_device
from ..utils.timing import SlopeUnresolved, fitted_slope_ms, time_ms
from .base import RunResult, check_run_args

IMPLS = ("torch", "torch-scan", "torch-unrolled", "cuda", "einsum")

# the reference's einsum tube blocking (backends/jax_backend.py:216-239):
# up to EINSUM_TUBE_MAX_S one pass over the rows; above it host-driven
# blocks of kblock rows, each about EINSUM_TUBE_MAX_S^2 gathered entries,
# at most EINSUM_TUBE_MAX_PROGRAMS of them an application
EINSUM_TUBE_MAX_S = 1 << 14
EINSUM_TUBE_MAX_PROGRAMS = 64
EINSUM_TUBE_ABS_MAX_S = EINSUM_TUBE_MAX_S * 8  # sqrt(64) = 8


def einsum_tube_kblock(s: int) -> int | None:
    """Rows per block for segment length s; None: one pass suffices."""
    if s <= EINSUM_TUBE_MAX_S:
        return None
    # keep per-block gather work ~ EINSUM_TUBE_MAX_S^2 entries
    kblock = max((EINSUM_TUBE_MAX_S * EINSUM_TUBE_MAX_S) // s, 1)
    while s % kblock:
        kblock //= 2
    return kblock


def _phase_fns(impl: str, n: int, p: int, tables, on_card: bool):
    """(funnel_f, tube_f) of one impl at (n, p): (xr, xi) -> (p, s)
    planes, and (p, s) planes -> (p, s) planes."""
    s = n // p
    if impl == "einsum":
        from ..models.direct_dft import (
            funnel_einsum_planes,
            tube_einsum_planes,
            tube_einsum_planes_hostblocked,
        )

        if on_card and s > EINSUM_TUBE_ABS_MAX_S:
            raise ValueError(
                f"einsum tube segment s={s} exceeds the card's dense-tube "
                f"limit (max s={EINSUM_TUBE_ABS_MAX_S}: its twiddle gather "
                f"grows as s^2); use a larger p or another backend")
        kblock = einsum_tube_kblock(s) if on_card else None

        def funnel_f(ar, ai):
            return funnel_einsum_planes(ar, ai, p)

        def tube_f(fr, fi):
            if kblock is None:
                return tube_einsum_planes(fr, fi, n, p)
            return tube_einsum_planes_hostblocked(fr, fi, n, p, kblock)

        return funnel_f, tube_f

    def funnel_f(ar, ai):
        return funnel(ar, ai, p, tables)

    def tube_f(fr, fi):
        if impl == "cuda":
            return tube_cuda(fr, fi, n, p)
        if impl == "torch-scan":
            return tube_scan(fr, fi, n, p)
        return tube(fr, fi, n, p, tables)

    return funnel_f, tube_f


class TorchBackend:
    def __init__(self, impl: str = "torch", device=None):
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r} not in {IMPLS}")
        self.name = impl
        self.device = device
        # butterfly backends reproduce the 8-point golden DFT bit-exactly;
        # the einsum model's products do not
        self.golden_atol = 1e-4 if impl == "einsum" else 0.0

    def capacity(self) -> Optional[int]:
        return None  # virtual processors: any power of two <= n

    def run(self, x: np.ndarray, p: int, reps: int = 1,
            fetch: bool = True, timers: bool = True) -> RunResult:
        x = check_run_args(x, p)
        n = x.shape[-1]
        dev = resolve_device(self.device)
        xr, xi = as_planes(x.real, x.imag, dev)
        tables = device_tables(n, dev)
        funnel_f, tube_f = _phase_fns(self.name, n, p, tables,
                                      dev.type == "cuda")
        fr, fi = funnel_f(xr, xi)
        check_finite("funnel", fr, fi)
        yr, yi = tube_f(fr, fi)
        check_finite("tube", yr, yi)
        funnel_ms = tube_ms = 0.0
        degraded = False
        if timers and dev.type == "cuda":
            fr, fi = fr.contiguous(), fi.contiguous()
            try:
                if p > 1:
                    funnel_ms = fitted_slope_ms(funnel_f, xr, xi, reps=reps)
                tube_ms = fitted_slope_ms(tube_f, fr, fi, reps=reps)
            except SlopeUnresolved as e:
                print(f"# loop slope unresolved (n={n} p={p}): {e}; "
                      f"timing by CUDA events", file=sys.stderr)
                funnel_ms, _ = time_ms(funnel_f, xr, xi, reps=reps)
                tube_ms, _ = time_ms(tube_f, fr, fi, reps=reps)
                degraded = True
        elif timers:
            funnel_ms, _ = time_ms(funnel_f, xr, xi, reps=reps)
            tube_ms, _ = time_ms(tube_f, fr, fi, reps=reps)
        out = None
        if fetch:
            out = torch.complex(yr, yi).reshape(n).cpu().numpy()
        return RunResult(out=out, total_ms=funnel_ms + tube_ms,
                         funnel_ms=funnel_ms, tube_ms=tube_ms,
                         degraded=degraded)
