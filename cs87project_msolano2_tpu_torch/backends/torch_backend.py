"""The ``torch`` and ``cuda`` backends: the funnel/tube pi-FFT on tensors.

``torch`` is the counterpart of the reference's ``jax`` backend (the
plain funnel and stage tube); ``cuda`` of its ``pallas`` backend (the
funnel as tensor ops, then the tube on the CUDA kernels,
``ops.cuda_fft.tube_cuda``).  Phase timers follow the reference's
contract: funnel and tube are timed apart and total_ms = funnel_ms +
tube_ms.  On the card each phase is timed by the loop slope
(``utils.timing.slope_ms``: calls captured in a CUDA graph, rotating
over copies of their operands, the window fitted to the call's length),
the reference's timer for its accelerator rows; p = 1 has no funnel and
charges 0.  Where a slope cannot be resolved both phases are timed by
CUDA events instead and the result is marked ``degraded``.  On the CPU
the host clock times them (``time_ms``).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..models.pi_fft import funnel, tube
from ..ops.cuda_fft import tube_cuda
from ..ops.twiddle import device_tables
from ..utils.device import as_planes, resolve_device
from ..utils.timing import SlopeUnresolved, fitted_window, slope_ms, time_ms
from .base import RunResult, check_run_args

IMPLS = ("torch", "cuda")


def _phase_slope_ms(fn, args, reps: int) -> float:
    """Loop-slope ms of one phase, the window fitted to the time of one
    call on the CUDA events."""
    est, _ = time_ms(fn, *args, reps=1, warmup=1)
    window = fitted_window(est, max(a.numel() for a in args))
    # the graph's private pool cannot take blocks the eager calls left
    # cached: hand those back first (a 2^24 x 256 funnel peaks near 32 GB)
    torch.cuda.empty_cache()
    return slope_ms(fn, *args, window=window, reps=reps)


class TorchBackend:
    #: butterfly backends reproduce the 8-point golden DFT bit-exactly
    golden_atol = 0.0

    def __init__(self, impl: str = "torch", device=None):
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r} not in {IMPLS}")
        self.name = impl
        self.device = device

    def capacity(self) -> Optional[int]:
        return None  # virtual processors: any power of two <= n

    def run(self, x: np.ndarray, p: int, reps: int = 1,
            fetch: bool = True, timers: bool = True) -> RunResult:
        x = check_run_args(x, p)
        n = x.shape[-1]
        dev = resolve_device(self.device)
        xr, xi = as_planes(x.real, x.imag, dev)
        tables = device_tables(n, dev)

        def funnel_f(ar, ai):
            return funnel(ar, ai, p, tables)

        def tube_f(fr, fi):
            if self.name == "cuda":
                return tube_cuda(fr, fi, n, p)
            return tube(fr, fi, n, p, tables)

        fr, fi = funnel_f(xr, xi)
        yr, yi = tube_f(fr, fi)
        funnel_ms = tube_ms = 0.0
        degraded = False
        if timers and dev.type == "cuda":
            fr, fi = fr.contiguous(), fi.contiguous()
            try:
                if p > 1:
                    funnel_ms = _phase_slope_ms(funnel_f, (xr, xi), reps)
                tube_ms = _phase_slope_ms(tube_f, (fr, fi), reps)
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
