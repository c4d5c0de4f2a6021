"""The ``torch`` and ``cuda`` backends: the funnel/tube pi-FFT on tensors.

``torch`` is the counterpart of the reference's ``jax`` backend (the
plain funnel and stage tube); ``cuda`` of its ``pallas`` backend (the
funnel as tensor ops, then the tube on the CUDA kernels,
``ops.cuda_fft.tube_cuda``).  Phase timers follow the reference's
contract: funnel and tube are timed separately (CUDA events on the
card) and total_ms = funnel_ms + tube_ms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.pi_fft import funnel, tube
from ..ops.cuda_fft import tube_cuda
from ..ops.twiddle import device_tables
from ..utils.device import as_planes, resolve_device
from ..utils.timing import time_ms
from .base import RunResult, check_run_args

IMPLS = ("torch", "cuda")


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

        if timers:
            funnel_ms, (fr, fi) = time_ms(funnel_f, xr, xi, reps=reps)
            tube_ms, (yr, yi) = time_ms(tube_f, fr, fi, reps=reps)
        else:
            funnel_ms = tube_ms = 0.0
            yr, yi = tube_f(*funnel_f(xr, xi))
        out = None
        if fetch:
            out = torch.complex(yr, yi).reshape(n).cpu().numpy()
        return RunResult(out=out, total_ms=funnel_ms + tube_ms,
                         funnel_ms=funnel_ms, tube_ms=tube_ms)
