"""Bit utilities: is_power_of_two / ilog2 / bit_reverse, the vectorized
bit-reversal gather indices, and the torch gather that unscrambles pi
layout to natural order at the API boundary."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..obs import metrics
from ..obs.spans import path_span


def is_power_of_two(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def ilog2(v: int) -> int:
    """log2 of a power of two."""
    if not is_power_of_two(v):
        raise ValueError(f"{v} is not a positive power of two")
    return v.bit_length() - 1


def bit_reverse(v: int, bits: int) -> int:
    """Reverse the low `bits` bits of v."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def bit_reverse_indices(n: int) -> np.ndarray:
    """idx such that x_natural = x_dif_order[idx]; idx[k] = bit_reverse(k).

    Vectorized O(n log n) construction (no per-element Python loop).
    """
    bits = ilog2(n)
    idx = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        idx = (idx << 1) | ((np.arange(n, dtype=np.int64) >> b) & 1)
    return idx


@lru_cache(maxsize=32)
def _index_tensor(n: int, device: torch.device) -> torch.Tensor:
    """``bit_reverse_indices(n)`` built on `device` itself: at n = 2^27
    the host loop would take tens of seconds, the card's a few
    milliseconds."""
    metrics.inc("pifft_gather_index_builds_total")
    bits = ilog2(n)
    k = torch.arange(n, dtype=torch.int64, device=device)
    idx = torch.zeros_like(k)
    for b in range(bits):
        idx = (idx << 1) | ((k >> b) & 1)
    return idx


def to_natural(yr: torch.Tensor, yi: torch.Tensor):
    """Gather pi-layout (bit-reversed) planes into natural frequency
    order over the trailing axis — one ``index_select`` per plane."""
    with path_span("fft.gather"):
        idx = _index_tensor(yr.shape[-1], yr.device)
        return yr.index_select(-1, idx), yi.index_select(-1, idx)
