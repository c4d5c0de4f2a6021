"""The native C core as a backend (the reference's ``backends/cpu.py``).

Variants map to the core's dispatch table (``native/pifft_backends.c``):
``serial`` runs the P virtual processors one after another, ``pthreads``
runs one pinned OS thread each.  numpy complex64 is layout-identical to
the C ``pif_c32 {float re, im}``, so arrays cross the boundary with no
copy.  The core runs on the host: ``device`` does not apply.  Its
timers are its own: ``total_ms`` is the coordinator's wall clock around
the parallel region, ``funnel_ms`` and ``tube_ms`` are processor 0's
phase times, so total_ms >= max(funnel_ms, tube_ms) and, at small n,
total_ms need not equal their sum.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..utils.buildlib import load_native
from ..utils.debug import check_finite
from .base import RunResult, check_run_args

#: the core's variants
VARIANTS = ("serial", "pthreads")


class NativeBackend:
    #: the core reproduces the 8-point golden DFT bit-exactly
    golden_atol = 0.0

    def __init__(self, variant: str = "pthreads"):
        if variant not in VARIANTS:
            raise ValueError(f"native variant {variant!r} not in "
                             f"{VARIANTS}")
        self.name = variant
        self._variant = variant.encode()

    def capacity(self) -> Optional[int]:
        """The core's largest sensible p (the online cores for
        ``pthreads``), None where it sets none (``serial``)."""
        cap = load_native().pifft_capacity(self._variant)
        if cap < 0:
            raise ValueError(f"unknown native backend '{self.name}'")
        return cap if cap > 0 else None

    def run(self, x: np.ndarray, p: int, reps: int = 1,
            fetch: bool = True, timers: bool = True) -> RunResult:
        """One unmeasured warm-up run (first-touch page faults stay out
        of the times), then the best of `reps` by total_ms.  `fetch` and
        `timers` change nothing: the output is on the host already and
        the core's timers cost nothing."""
        del fetch, timers
        x = check_run_args(x, p)
        lib = load_native()
        n = x.shape[-1]
        out = np.empty(n, dtype=np.complex64)
        t3 = (ctypes.c_double * 3)()
        best = (float("inf"), 0.0, 0.0)
        for rep in range(max(reps, 1) + 1):
            rc = lib.pifft_run(self._variant, n, p, x.ctypes.data,
                               out.ctypes.data, t3)
            if rc != 0:
                raise RuntimeError(f"native run failed (backend="
                                   f"{self.name}, n={n}, p={p}, rc={rc})")
            if rep > 0 and t3[0] < best[0]:
                best = (t3[0], t3[1], t3[2])
        # the core's phases are inside one C call: its output is the
        # tube's
        check_finite("tube", out)
        return RunResult(out=out, total_ms=best[0], funnel_ms=best[1],
                         tube_ms=best[2])

    def golden_test(self, p: int = 8) -> bool:
        """The core's own 8-point golden test at `p` (exact equality)."""
        return load_native().pifft_golden_test(self._variant, p) == 0


def num_cores() -> int:
    """The core's ``pifft_num_cores``: the host's online cores as
    ``sysconf`` reports them (which may be more than this process's
    affinity mask allows)."""
    return load_native().pifft_num_cores()
