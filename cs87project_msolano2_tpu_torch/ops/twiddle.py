"""Twiddle-factor tables — this system's "weights" — on the host and on
the device.

One table per butterfly level: level l of an n-point transform has
butterfly size L = n >> l and L/2 entries w[j] = exp(-2*pi*i*j/L),
computed in float64 and rounded once to float32.  The long-range
kernel takes separable factors instead (``long_range_factors``).

The host tables are bit-identical to the reference package's
(``ops/twiddle.py:twiddle_tables`` and
``ops/pallas_fft.py:_long_range_factors``); ``tables_from_reference``
and ``factors_from_reference`` carry tables built there over to device
tensors, so both packages can run on the same weights.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bits import ilog2


def twiddle_tables(n: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """((wr, wi), ...) per level as float32 numpy, level l sized
    (n >> l) / 2.  Trig runs in float64 first, so table error is one
    rounding, never accumulated."""
    return _twiddle_tables_cached(n)


@lru_cache(maxsize=64)
def _twiddle_tables_cached(n: int):
    levels = []
    for l in range(ilog2(n)):
        L = n >> l
        j = np.arange(L // 2, dtype=np.float64)
        ang = -2.0 * np.pi * j / L
        levels.append(
            (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
        )
    return tuple(levels)


@lru_cache(maxsize=16)
def long_range_factors(R: int, C: int):
    """Separable twiddle factors for the first log2(R) levels of an
    n = R*C transform viewed as (R, C).

    W_{n>>l}^{r~*C+c} = W_{R>>l}^{r~} * W_{n>>l}^{c}, so level l's
    twiddle is the outer product of A (R-1 stacked per-level row
    factors; level l occupies rows [R - (R>>l), R - (R>>(l+1)))) and B
    (levels, C) column factors.  Returns (ar, ai, br, bi) float32 numpy,
    A shaped (R-1, 1) and B (levels, C), as the reference does."""
    levels = ilog2(R)
    n = R * C
    a = np.concatenate([
        np.exp(-2j * np.pi * np.arange(R >> (l + 1)) / (R >> l))
        for l in range(levels)
    ])[:, None]
    c = np.arange(C)
    b = np.stack([np.exp(-2j * np.pi * c / (n >> l)) for l in range(levels)])
    return (
        a.real.astype(np.float32), a.imag.astype(np.float32),
        b.real.astype(np.float32), b.imag.astype(np.float32),
    )


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)) \
        .to(device)


def tables_from_reference(np_tables, device) -> tuple:
    """Per-level ((wr, wi), ...) numpy tables — as
    ``cs87project_msolano2_tpu.ops.twiddle.twiddle_tables(n)`` returns
    them — as float32 tensors on `device`, the form ``fft(...,
    tables=...)`` and ``pi_fft_pi_layout(..., tables)`` take."""
    return tuple((_f32(wr, device), _f32(wi, device))
                 for wr, wi in np_tables)


def factors_from_reference(ar, ai, br, bi, device) -> tuple:
    """The (ar, ai, br, bi) 4-tuple of the reference's
    ``_long_range_factors(R, C)`` as the long-range kernel's operands on
    `device`: A flattened to (R-1,), B kept (levels, C), all float32 and
    contiguous."""
    return (_f32(ar, device).reshape(-1), _f32(ai, device).reshape(-1),
            _f32(br, device), _f32(bi, device))


@lru_cache(maxsize=32)
def device_tables(n: int, device: torch.device) -> tuple:
    """``twiddle_tables(n)`` on `device`, cached per (n, device)."""
    return tables_from_reference(twiddle_tables(n), device)


@lru_cache(maxsize=32)
def flat_tables(n: int, device: torch.device):
    """All levels of ``twiddle_tables(n)`` concatenated into one (n-1,)
    re and one im tensor — the tile kernel's operand layout: level l
    starts at offset n - (n >> l)."""
    tabs = twiddle_tables(n)
    return (_f32(np.concatenate([t[0] for t in tabs]), device),
            _f32(np.concatenate([t[1] for t in tabs]), device))


@lru_cache(maxsize=32)
def device_factors(R: int, C: int, device: torch.device) -> tuple:
    """``long_range_factors(R, C)`` as kernel operands on `device`."""
    return factors_from_reference(*long_range_factors(R, C), device)
