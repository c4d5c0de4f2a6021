"""Verification oracles: the exact 8-point golden test, a naive O(N^2)
DFT, the pi-layout unscramble and the error metrics (numpy, host side).
"""

from __future__ import annotations

import numpy as np

from ..ops.bits import bit_reverse_indices

GOLDEN_N = 8


def golden_input() -> np.ndarray:
    """The reference's fixed test vector: re = 0,1,0,1,...; im = 0."""
    x = np.zeros(GOLDEN_N, dtype=np.complex64)
    x.real = np.arange(GOLDEN_N) & 1
    return x


def golden_expected() -> np.ndarray:
    """Its analytically known DFT: (4,0,0,0,-4,0,0,0)."""
    y = np.zeros(GOLDEN_N, dtype=np.complex64)
    y[0] = 4.0
    y[4] = -4.0
    return y


def golden_check_exact(y_natural: np.ndarray) -> bool:
    """Exact float equality, like the reference's verify_results."""
    return bool(np.all(y_natural == golden_expected()))


def golden_check_tol(y_natural: np.ndarray, atol: float = 1e-4) -> bool:
    """Tolerance variant; with atol=0 it is exact equality."""
    return bool(np.max(np.abs(y_natural - golden_expected())) <= atol)


def naive_dft(x: np.ndarray) -> np.ndarray:
    """O(N^2) reference DFT in float64 (independent oracle)."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return x @ w.T


def pi_layout_to_natural(y_pi: np.ndarray) -> np.ndarray:
    """Unscramble DIF bit-reversed order to natural frequency order."""
    idx = bit_reverse_indices(y_pi.shape[-1])
    return np.take(y_pi, idx, axis=-1)


def max_abs_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def rel_err(a, b) -> float:
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    denom = max(float(np.max(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b))) / denom
