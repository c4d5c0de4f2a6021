"""The backend contract (the reference's ``backends/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import numpy as np


@dataclass
class RunResult:
    """One pi-FFT run: output in pi layout (global DIF bit-reversed order,
    processor Pi owning [Pi*n/p, (Pi+1)*n/p)) + phase timers in ms.
    `out` is None when the run was timing-only (fetch=False)."""

    out: Optional[np.ndarray]  # complex64, pi layout
    total_ms: float
    funnel_ms: float
    tube_ms: float
    # True where the timers are CUDA-event times, the host's pace in
    # them, because the loop slope could not be resolved; the harness
    # marks such rows DEGRADED
    degraded: bool = False


class Backend(Protocol):
    name: str

    def capacity(self) -> Optional[int]:
        """Max sensible p on this hardware, or None if unlimited."""
        ...

    def run(self, x: np.ndarray, p: int, reps: int = 1,
            fetch: bool = True, timers: bool = True) -> RunResult:
        """pi-DFT of complex64 `x` (power-of-two length) with p virtual
        processors; `reps` timed repetitions, output from the last."""
        ...


def check_run_args(x: np.ndarray, p: int) -> np.ndarray:
    n = x.shape[-1]
    if n & (n - 1) or n <= 0:
        raise ValueError(f"n={n} must be a power of two")
    if p & (p - 1) or p <= 0 or p > n:
        raise ValueError(f"p={p} must be a power of two <= n={n}")
    return np.ascontiguousarray(x, dtype=np.complex64)
