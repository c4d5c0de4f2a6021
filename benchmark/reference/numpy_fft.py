"""The plain reference: ``numpy.fft`` in complex128 over the same inputs
that the program was handed, with a bit-reversal of its own for pi
order.  It imports nothing of the program and takes nothing the program
made."""

from __future__ import annotations

import numpy as np


def bit_reversal(n: int) -> np.ndarray:
    """perm with perm[k] = k with its log2(n) low bits reversed."""
    bits = n.bit_length() - 1
    if n < 1 or 1 << bits != n:
        raise ValueError(f"bit reversal needs a power of two, got {n}")
    k = np.arange(n, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        perm |= ((k >> b) & 1) << (bits - 1 - b)
    return perm


def transform(x: np.ndarray, domain: str, order: str) -> np.ndarray:
    """The DFT of `x` over its trailing axis in complex128: the full
    spectrum for "c2c", the n/2+1 leading bins for "r2c"; in natural
    order, or with the trailing axis bit-reversed for "pi"."""
    if domain == "c2c":
        y = np.fft.fft(x.astype(np.complex128), axis=-1)
    elif domain == "r2c":
        y = np.fft.rfft(x.astype(np.float64), axis=-1)
    else:
        raise ValueError(f"unknown domain {domain!r}")
    if order == "pi":
        if domain != "c2c":
            raise ValueError("pi order exists only for c2c")
        y = y[..., bit_reversal(y.shape[-1])]
    elif order != "natural":
        raise ValueError(f"unknown order {order!r}")
    return y


def expected(inputs, domain: str, order: str) -> np.ndarray:
    """The transform of one call's inputs: one complex or real array, or
    float re and im planes (taken as re + 1j im)."""
    if len(inputs) == 2:
        x = inputs[0].astype(np.float64) + 1j * inputs[1]
    else:
        (x,) = inputs
    return transform(x, domain, order)
