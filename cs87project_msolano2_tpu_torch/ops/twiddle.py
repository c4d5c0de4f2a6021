"""Twiddle-factor tables — this system's "weights" — on the host and on
the device.

One table per butterfly level: level l of an n-point transform has
butterfly size L = n >> l and L/2 entries w[j] = exp(-2*pi*i*j/L),
computed in float64 and rounded once to float32.  The long-range
kernels take separable factors (``long_range_factors``) or the same
per-level tables reshaped to the (R, C) view
(``dense_long_range_tables``).

The matmul funnel (``mf``) takes the bit-reversed R-point DFT matrix
(``dft_funnel_b``), cut into the bf16 planes of a precision mode
(``device_funnel_b_planes``) and laid out as its kernel's step tiles
(``device_funnel_b_tiles``), and the separable factors of its (R, n/R)
twiddle grid (``dft_funnel_factors``).

The kernel operands (``flat_tables``, ``device_factors``,
``dense_long_range_tables``) come in the two storage dtypes of
``ops.precision``: float32, and bfloat16 for the bf16 storage mode —
the float32 tables rounded to nearest even, bit-identical to the
reference's ``jnp.asarray(t, jnp.bfloat16)`` of the same tables (and to
its ``twiddle_tables(n, dtype="bfloat16")``, which rounds through
float32 as well).

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
from .precision import as_storage, bf16_split

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


def _stored(tensors, storage: str, device) -> tuple:
    """Float32 CPU `tensors` in `storage` on `device`: rounded to
    bfloat16 (nearest even) on the host, then moved."""
    return tuple(as_storage(t, storage).to(device) for t in tensors)


def flat_tables(n: int, device: torch.device, storage: str | None = None):
    """All levels of ``twiddle_tables(n)`` concatenated into one (n-1,)
    re and one im tensor — the tile kernel's operand layout: level l
    starts at offset n - (n >> l) — stored as `storage` (None:
    float32; "bfloat16" for the bf16 storage mode), cached per (n,
    device, storage)."""
    return _flat_tables(n, device, storage or "float32")


@lru_cache(maxsize=32)
def _flat_tables(n: int, device, storage: str):
    tabs = twiddle_tables(n)
    return _stored((_f32(np.concatenate([t[0] for t in tabs]), "cpu"),
                    _f32(np.concatenate([t[1] for t in tabs]), "cpu")),
                   storage, device)


def device_factors(R: int, C: int, device: torch.device,
                   storage: str | None = None) -> tuple:
    """``long_range_factors(R, C)`` as kernel operands on `device`,
    stored as `storage` (None: float32), cached per (R, C, device,
    storage)."""
    return _device_factors(R, C, device, storage or "float32")


@lru_cache(maxsize=32)
def _device_factors(R: int, C: int, device, storage: str) -> tuple:
    return _stored(factors_from_reference(*long_range_factors(R, C), "cpu"),
                   storage, device)


def dense_long_range_tables(R: int, C: int, device,
                            storage: str | None = None) -> tuple:
    """The dense twiddle tables of the first log2(R) levels of an
    n = R*C transform viewed as (R, C), as (wr, wi) tensors of shape
    (R - 1, C) on `device`, stored as `storage` (None: float32): level l
    is the n-point level-l table of ``twiddle_tables(n)`` reshaped to
    (R >> (l+1), C), as the reference's ``long_range_grid(separable=
    False)`` builds it (pallas_fft.py:651-657), bit for bit, stacked at
    rows [R - (R >> l), R - (R >> (l+1))).  The operand of the dense
    long-range kernel and of fourstep/sixstep with separable=False."""
    return _dense_long_range_tables(R, C, device, storage or "float32")


@lru_cache(maxsize=8)
def _dense_long_range_tables(R: int, C: int, device, storage: str) -> tuple:
    levels = twiddle_tables(R * C)[:ilog2(R)]
    return _stored(
        (_f32(np.concatenate([wr for wr, _ in levels]).reshape(R - 1, C),
              "cpu"),
         _f32(np.concatenate([wi for _, wi in levels]).reshape(R - 1, C),
              "cpu")),
        storage, device)


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


@lru_cache(maxsize=16)
def device_funnel_b_planes(R: int, levels: int, device) -> tuple:
    """``dft_funnel_b(R)`` cut into `levels` bf16 planes on `device`
    (``precision.bf16_split``: round to nearest even), (bpr, bpi) each
    stacked (levels, R, R) bfloat16: the planes
    ``device_funnel_b_tiles`` lays out for the kernel."""
    return tuple(torch.stack(bf16_split(b, levels)).to(device)
                 for b in funnel_b_from_reference(*dft_funnel_b(R), "cpu"))


#: rows and columns of one step's slice of B in the funnel kernel (its
#: work unit's rows, one wgmma's K)
FUNNEL_TILE_ROWS = 64
FUNNEL_TILE_K = 16


def funnel_b_tiles(bpr, bpi):
    """The funnel's bf16 planes (bpr, bpi), each (L, R, R), as the
    kernel's step tiles: one bfloat16 tensor (row_units, R / 16, 2, L,
    2, 64, 8) whose [u, k] slice holds rows 64 u .. 64 u + 63 and columns
    16 k .. 16 k + 15 of every plane of Br, then of Bi, contiguous, each
    plane in wgmma's no-swizzle K-major layout (columns 16 k .. + 7 of
    the 64 rows, then the next 8), rows past R zero (R < 64)."""
    L, R, _ = bpr.shape
    rows = max(R, FUNNEL_TILE_ROWS)
    p = torch.zeros((2, L, rows, R), dtype=bpr.dtype, device=bpr.device)
    p[0, :, :R] = bpr
    p[1, :, :R] = bpi
    # m, s, u, row, k, half, e
    p = p.reshape(2, L, rows // FUNNEL_TILE_ROWS, FUNNEL_TILE_ROWS,
                  R // FUNNEL_TILE_K, 2, 8)
    return p.permute(2, 4, 0, 1, 5, 3, 6).contiguous()


def funnel_b_untile(bt) -> tuple:
    """The (bpr, bpi) planes, each (L, R, R), of the tiles `bt` of
    ``funnel_b_tiles``."""
    units, ks, _, L, _, tile_rows, _ = bt.shape
    R = ks * FUNNEL_TILE_K
    p = bt.permute(2, 3, 0, 5, 1, 4, 6)
    p = p.reshape(2, L, units * tile_rows, R)[:, :, :R]
    return p[0].contiguous(), p[1].contiguous()


@lru_cache(maxsize=16)
def device_funnel_b_tiles(R: int, levels: int, device):
    """``funnel_b_tiles`` of ``device_funnel_b_planes(R, levels)`` on
    `device`: the B operand the funnel kernel reads, made once per card,
    R and number of planes."""
    return funnel_b_tiles(*device_funnel_b_planes(R, levels, "cpu")) \
        .to(device)


def funnel_b2_tiles(b2r, b2i):
    """The funnel's column factor B2, (b2r, b2i) each (R, 128), as its
    kernel's epilogue reads it: one float32 tensor (row_units, 2, 4, 2,
    8, 8, 4, 2, 2) whose [u, l, w, h, j, g, t] entry holds row 64 u +
    16 w + 8 h + g, columns 64 l + 8 j + 2 t and the next, re then im
    (a warp's 32 lanes read 512 contiguous bytes), rows past R zero."""
    R = b2r.shape[0]
    rows = max(R, FUNNEL_TILE_ROWS)
    p = torch.zeros((2, rows, LANE), dtype=b2r.dtype, device=b2r.device)
    p[0, :R] = b2r
    p[1, :R] = b2i
    # p, u, w, h, g, l, j, t, e
    p = p.reshape(2, rows // FUNNEL_TILE_ROWS, 4, 2, 8, 2, 8, 4, 2)
    return p.permute(1, 5, 2, 3, 6, 4, 7, 0, 8).contiguous()


def funnel_b2_untile(wt, R: int) -> tuple:
    """The (b2r, b2i) factors, each (R, 128), of the tiles `wt` of
    ``funnel_b2_tiles``."""
    p = wt.permute(7, 0, 2, 3, 5, 1, 4, 6, 8)
    p = p.reshape(2, -1, LANE)[:, :R]
    return p[0].contiguous(), p[1].contiguous()


@lru_cache(maxsize=8)
def device_funnel_b2_tiles(R: int, n: int, device):
    """``funnel_b2_tiles`` of the B2 factor of ``dft_funnel_factors(R,
    n)`` on `device`, made once per card, R and n."""
    _, _, b2r, b2i = funnel_factors_from_reference(
        *dft_funnel_factors(R, n), "cpu")
    return funnel_b2_tiles(b2r, b2i).to(device)
