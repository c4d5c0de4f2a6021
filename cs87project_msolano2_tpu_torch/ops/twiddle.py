"""Twiddle-factor tables — this system's "weights" — on the host and on
the device.

One table per butterfly level: level l of an n-point transform has
butterfly size L = n >> l and L/2 entries w[j] = exp(-2*pi*i*j/L),
computed in float64 and rounded once to float32.  The long-range
kernels take separable factors (``long_range_factors``) or the same
per-level tables reshaped to the (R, C) view
(``dense_long_range_tables``).

The matmul funnel (``mf``) takes the bit-reversed R-point DFT matrix
(``dft_funnel_b``) and the separable factors of its (R, n/R) twiddle
grid (``dft_funnel_factors``).

The host tables are bit-identical to the reference package's
(``ops/twiddle.py:twiddle_tables``,
``ops/pallas_fft.py:_long_range_factors``, ``dft_funnel_b`` and
``dft_funnel_factors``); ``tables_from_reference``,
``factors_from_reference`` and the ``funnel_*_from_reference`` helpers
carry tables built there over to device tensors, so both packages can
run on the same weights.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bits import bit_reverse_indices, ilog2

#: lane width of the funnel's (R, Q, LANE) column view
LANE = 128


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


@lru_cache(maxsize=8)
def dense_long_range_tables(R: int, C: int, device) -> tuple:
    """The dense twiddle tables of the first log2(R) levels of an
    n = R*C transform viewed as (R, C), as (wr, wi) float32 tensors of
    shape (R - 1, C) on `device`: level l is the n-point level-l table
    of ``twiddle_tables(n)`` reshaped to (R >> (l+1), C), as the
    reference's ``long_range_grid(separable=False)`` builds it
    (pallas_fft.py:651-657), bit for bit, stacked at rows
    [R - (R >> l), R - (R >> (l+1))).  The operand of the dense
    long-range kernel and of fourstep/sixstep with separable=False."""
    levels = twiddle_tables(R * C)[:ilog2(R)]
    return (_f32(np.concatenate([wr for wr, _ in levels]).reshape(R - 1, C),
                 device),
            _f32(np.concatenate([wi for _, wi in levels]).reshape(R - 1, C),
                 device))


@lru_cache(maxsize=8)
def dft_funnel_b(R: int) -> tuple[np.ndarray, np.ndarray]:
    """The (R, R) bit-reversed DFT matrix B[r, r'] = W_R^{bitrev(r) r'}
    of the matmul funnel, as (br, bi) float32 numpy: row r of B @ X is
    the output row that the first log2(R) DIF levels of an n = R * C
    transform viewed as (R, C) leave at r, before its twiddle."""
    rev = bit_reverse_indices(R).astype(np.float64)
    rp = np.arange(R, dtype=np.float64)
    b = np.exp(-2j * np.pi * np.outer(rev, rp) / R)
    return b.real.astype(np.float32), b.imag.astype(np.float32)


@lru_cache(maxsize=8)
def dft_funnel_factors(R: int, n: int):
    """Separable factors of the matmul funnel's (R, n/R) twiddle grid
    T[r, c] = W_n^{bitrev(r) c}.  With c = q * LANE + l,
    T[r, q*LANE + l] = A[r, q] * B2[r, l], A[r, q] = W_n^{bitrev(r) q
    LANE} and B2[r, l] = W_n^{bitrev(r) l} (angle indices reduced mod n
    in int64, so both factors are exact roots of unity).  Returns (ar,
    ai, b2r, b2i) float32 numpy: A (R, Q = n/R/LANE), B2 (R, LANE)."""
    Q = n // R // LANE
    rev = bit_reverse_indices(R).astype(np.int64)
    q = np.arange(Q, dtype=np.int64)
    l = np.arange(LANE, dtype=np.int64)
    a_idx = (rev[:, None] * q[None, :] * LANE) % n
    b_idx = (rev[:, None] * l[None, :]) % n
    a = np.exp(-2j * np.pi * a_idx / n)
    b2 = np.exp(-2j * np.pi * b_idx / n)
    return (
        a.real.astype(np.float32), a.imag.astype(np.float32),
        b2.real.astype(np.float32), b2.imag.astype(np.float32),
    )


def funnel_b_from_reference(br, bi, device) -> tuple:
    """The (br, bi) of the reference's ``dft_funnel_b(R)`` as the funnel
    kernel's (R, R) float32 operands on `device`."""
    return _f32(br, device), _f32(bi, device)


def funnel_factors_from_reference(ar, ai, b2r, b2i, device) -> tuple:
    """The (ar, ai, b2r, b2i) of the reference's
    ``dft_funnel_factors(R, n)`` as the funnel kernel's operands on
    `device`: A kept (R, Q) — the reference hands its kernel A
    transposed only for the TPU's lane rule — and B2 (R, LANE)."""
    return (_f32(ar, device), _f32(ai, device), _f32(b2r, device),
            _f32(b2i, device))


@lru_cache(maxsize=8)
def device_funnel_b(R: int, device) -> tuple:
    """``dft_funnel_b(R)`` as kernel operands on `device`."""
    return funnel_b_from_reference(*dft_funnel_b(R), device)


@lru_cache(maxsize=8)
def device_funnel_factors(R: int, n: int, device) -> tuple:
    """``dft_funnel_factors(R, n)`` as kernel operands on `device`."""
    return funnel_factors_from_reference(*dft_funnel_factors(R, n), device)
