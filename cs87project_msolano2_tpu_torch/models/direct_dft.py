"""The direct DFT as dense products: the north star's second expression
of the no-communication property (the reference's
``models/direct_dft.py``).

Every output bin is an independent partial sum X[k] = sum_j x[j] W^(jk),
so processor Pi computes exactly its own pi-layout segment of bins
against its replicated input, with no communication.  Two tiers:

* the O(n^2)-memory oracles ``dft_direct`` / ``dft_direct_pi`` /
  ``dft_direct_pi_planes``, guarded by MAX_N; ``dft_direct(x,
  np.complex128)`` is BASELINE config 1 (N = 1024, float64, numpy on
  the host);
* the phased einsum model, the ``einsum`` backend: the funnel as one
  (p, p, s)-coefficient contraction against the blocked input (the
  polyphase identity funnel(pi, j) = sum_m x[m*s + j] *
  W_n^{rev(pi) * (m*s + j)}), and the tube as the segment-local DIF
  matrix B[k, j] = W_s^{rev_s(k) * j}, generated block by block of
  output rows from exact integer angle indices and a full-period table,
  so memory stays O(block * s) at any n.

The products are plain dense contractions (``torch.einsum``), the
reference's ``jnp.einsum`` at ``Precision.HIGHEST``: they run in full
float32 whatever the process's matmul setting (``full_float32``), never
in TF32.  The tables are cached on each device, so the phases take no
host-to-device copy after their first call and can be captured in a
CUDA graph.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from ..ops.bits import bit_reverse_indices
from ..utils.device import resolve_device

MAX_N = 1 << 13  # W is n^2 complex entries; 8192^2 * 8 B = 512 MB
# funnel coefficient planes hold p*n floats x2; 2^24 = 128 MB: beyond
# that the (n, p) combination is out of the einsum backend's capacity
COEF_MAX_ENTRIES = 1 << 24
# full-period twiddle tables are m floats x2 (host f64 trig, f32 stored)
FULL_TABLE_MAX = 1 << 20
#: entries of the (rows, s) twiddle gather one tube block materializes
TUBE_BLOCK_ENTRIES = 1 << 22


@contextmanager
def full_float32():
    """Run the enclosed products in full float32: TF32 (and any reduced
    float32 matmul mode) is switched off for the block and the caller's
    setting put back after it.  Raises RuntimeError where the setting
    does not take.  The setting is the process's, so the block is not
    safe against another thread changing it."""
    was_mode = torch.get_float32_matmul_precision()
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    try:
        if torch.backends.cuda.matmul.allow_tf32 or \
                torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("could not pin float32 matmul precision to "
                               "'highest' for the einsum products")
        yield
    finally:
        torch.set_float32_matmul_precision(was_mode)
        torch.backends.cuda.matmul.allow_tf32 = was_tf32


def _einsum_f32(spec: str, a, b):
    """``torch.einsum`` in full float32 (``full_float32``)."""
    with full_float32():
        return torch.einsum(spec, a, b)


@lru_cache(maxsize=16)
def dft_matrix(n: int, dtype=np.complex64) -> np.ndarray:
    """W[k, j] = exp(-2 pi i j k / n), float64 trig then cast."""
    if n > MAX_N:
        raise ValueError(f"direct DFT capped at n={MAX_N} (O(n^2) memory)")
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(dtype)


def _as_complex(x, device) -> torch.Tensor:
    """complex64 tensor of `x`: a tensor stays where it lies unless
    `device` names another, numpy goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.complex64)
    return torch.from_numpy(np.asarray(x, dtype=np.complex64)).to(
        resolve_device(device))


def dft_direct(x, dtype=np.complex64, device=None):
    """X = W @ x over the trailing axis (natural order).

    dtype=np.complex128 is BASELINE config 1 (the N=1024 float64 CPU
    reference run), computed with numpy on the host; complex64 is one
    full-float32 product on the device of `x` (numpy input: the card
    unless `device` is "cpu")."""
    if dtype == np.complex128:
        x = np.asarray(x, dtype=np.complex128)
        return np.einsum("kj,...j->...k", dft_matrix(x.shape[-1], dtype), x)
    x = _as_complex(x, device)
    w = torch.from_numpy(dft_matrix(x.shape[-1], np.complex64)).to(x.device)
    return _einsum_f32("kj,...j->...k", w, x)


def dft_direct_pi(x, p: int = 1, device=None):
    """The pi-decomposed direct DFT: processor Pi computes only the bins
    of its pi-layout segment, W's rows gathered into (p, n/p, n) blocks.
    Returns the pi-layout result (..., n), the butterfly models'
    layout."""
    x = _as_complex(x, device)
    n = x.shape[-1]
    w = dft_matrix(n, np.complex64)[bit_reverse_indices(n)]
    w_blocks = torch.from_numpy(w.reshape(p, n // p, n)).to(x.device)
    y = _einsum_f32("psj,...j->...ps", w_blocks, x)
    return y.reshape(*x.shape[:-1], n)


def dft_direct_pi_planes(xr, xi, p: int = 1):
    """``dft_direct_pi`` on float32 planes (tensors, on their device):
    four real contractions."""
    n = xr.shape[-1]
    w = dft_matrix(n, np.complex64)[bit_reverse_indices(n)].reshape(
        p, n // p, n)
    wr = torch.from_numpy(np.ascontiguousarray(w.real)).to(xr.device)
    wi = torch.from_numpy(np.ascontiguousarray(w.imag)).to(xr.device)
    spec = "psj,...j->...ps"
    yr = _einsum_f32(spec, wr, xr) - _einsum_f32(spec, wi, xi)
    yi = _einsum_f32(spec, wr, xi) + _einsum_f32(spec, wi, xr)
    return yr.reshape(*xr.shape[:-1], n), yi.reshape(*xi.shape[:-1], n)


@lru_cache(maxsize=8)
def full_twiddle(m: int) -> tuple[np.ndarray, np.ndarray]:
    """(wr, wi) full-period table W_m^j = exp(-2*pi*i*j/m), j in [0, m)."""
    if m > FULL_TABLE_MAX:
        raise ValueError(f"full twiddle table capped at m={FULL_TABLE_MAX}")
    j = np.arange(m, dtype=np.float64)
    ang = -2.0 * np.pi * j / m
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=8)
def funnel_coeff_planes(n: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """C[pi, m, j] = W_n^{rev(pi) * (m*s + j)} as (p, p, s) float32
    planes: the funnel's linear map in closed form, from exact integer
    angle indices and float64 host trig."""
    if p * n > COEF_MAX_ENTRIES:
        raise ValueError(
            f"einsum funnel coefficients need p*n <= {COEF_MAX_ENTRIES} "
            f"(got p={p}, n={n})"
        )
    rev = bit_reverse_indices(p).astype(np.int64)
    i = np.arange(n, dtype=np.int64)
    idx = (rev[:, None] * i[None, :]) % n  # (p, n), exact in int64
    wr, wi = full_twiddle(n)
    s = n // p
    return wr[idx].reshape(p, p, s), wi[idx].reshape(p, p, s)


@lru_cache(maxsize=8)
def _device_coeff_planes(n: int, p: int, device) -> tuple:
    return tuple(torch.from_numpy(t).to(device)
                 for t in funnel_coeff_planes(n, p))


@lru_cache(maxsize=8)
def _device_full_twiddle(m: int, device) -> tuple:
    return tuple(torch.from_numpy(t).to(device) for t in full_twiddle(m))


@lru_cache(maxsize=8)
def _device_rev(s: int, device) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_indices(s).astype(np.int64)).to(
        device)


def funnel_einsum_planes(xr, xi, p: int):
    """Funnel phase as one coefficient-tensor contraction: (..., n) ->
    (..., p, s) pi-layout funnel planes, the map of
    ``models.pi_fft.funnel``, as four real contractions against the
    replicated blocked input."""
    n = xr.shape[-1]
    cr, ci = _device_coeff_planes(n, p, xr.device)
    xbr = xr.reshape(*xr.shape[:-1], p, n // p)
    xbi = xi.reshape(*xi.shape[:-1], p, n // p)
    spec = "pmj,...mj->...pj"
    yr = _einsum_f32(spec, cr, xbr) - _einsum_f32(spec, ci, xbi)
    yi = _einsum_f32(spec, cr, xbi) + _einsum_f32(spec, ci, xbr)
    return yr, yi


def _tube_rows_apply(sr, si, kb, s: int):
    """The DIF-matrix rows for output indices `kb` (already
    bit-reversed), gathered from the full-period table by the angle
    index (kb * j) mod s, contracted against the (..., s) planes.
    Returns (..., len(kb)) planes.  The index is formed in int64, where
    kb * j < s^2 is exact."""
    wr_t, wi_t = _device_full_twiddle(s, sr.device)
    j = torch.arange(s, dtype=torch.int64, device=sr.device)
    idx = (kb[:, None] * j[None, :]) & (s - 1)
    wr, wi = wr_t[idx], wi_t[idx]
    spec = "...j,kj->...k"
    yr = _einsum_f32(spec, sr, wr) - _einsum_f32(spec, si, wi)
    yi = _einsum_f32(spec, sr, wi) + _einsum_f32(spec, si, wr)
    return yr, yi


def _tube_rows_scan(sr, si, kb, s: int, block: int | None = None):
    """``_tube_rows_apply`` over blocks of `block` consecutive rows of
    `kb` (default: the rows whose gather holds at most
    TUBE_BLOCK_ENTRIES), written into one output.  Returns (...,
    len(kb)) planes."""
    nrows = kb.shape[0]
    if block is None:
        block = max(min(nrows, TUBE_BLOCK_ENTRIES // s), 1)
    if block >= nrows:
        return _tube_rows_apply(sr, si, kb, s)
    if nrows % block:
        raise ValueError(
            f"tube block={block} must divide the {nrows} requested rows "
            "(auto-chosen blocks are powers of two and always do)"
        )
    yr = torch.empty(*sr.shape[:-1], nrows, dtype=sr.dtype,
                     device=sr.device)
    yi = torch.empty_like(yr)
    for a in range(0, nrows, block):
        yr[..., a:a + block], yi[..., a:a + block] = _tube_rows_apply(
            sr, si, kb[a:a + block], s)
    return yr, yi


def tube_einsum_planes(sr, si, n: int, p: int, block: int | None = None):
    """Tube phase as a blockwise dense product: each segment's s-point
    DIF matrix B[k, j] = W_s^{rev_s(k) * j} over the trailing axis,
    (..., s) -> (..., s), its rows generated block by block
    (``_tube_rows_scan``)."""
    s = sr.shape[-1]
    if s == 1:
        return sr, si
    return _tube_rows_scan(sr, si, _device_rev(s, sr.device), s, block)


def tube_einsum_block(sr, si, k0: int, n: int, p: int, kblock: int):
    """Output rows [k0, k0 + kblock) of every segment's s-point DIF:
    (..., s) planes -> (..., kblock) planes, in gather blocks of at most
    TUBE_BLOCK_ENTRIES."""
    s = sr.shape[-1]
    kb = _device_rev(s, sr.device)[k0:k0 + kblock]
    return _tube_rows_scan(sr, si, kb, s)


def tube_einsum_planes_hostblocked(sr, si, n: int, p: int, kblock: int,
                                   block_fn=None):
    """The dense tube as a loop over ``tube_einsum_block`` calls of
    `kblock` rows each, concatenated along the row axis (consecutive
    bit-reversed output rows, the scan tube's layout).  `block_fn(sr,
    si, k0)` replaces the block call."""
    s = sr.shape[-1]
    if s % kblock:
        raise ValueError(f"kblock={kblock} must divide s={s}")
    if block_fn is None:
        def block_fn(ar, ai, k0):
            return tube_einsum_block(ar, ai, k0, n, p, kblock)
    parts = [block_fn(sr, si, k0) for k0 in range(0, s, kblock)]
    yr = torch.cat([pr for pr, _ in parts], dim=-1)
    yi = torch.cat([pi_ for _, pi_ in parts], dim=-1)
    return yr, yi


def pi_dft_einsum_planes(xr, xi, p: int):
    """Full phased einsum pi-DFT: the funnel contraction, then the tube
    contraction, output (..., n) in pi layout."""
    n = xr.shape[-1]
    fr, fi = funnel_einsum_planes(xr, xi, p)
    tr, ti = tube_einsum_planes(fr, fi, n, p)
    return (tr.reshape(*xr.shape[:-1], n), ti.reshape(*xi.shape[:-1], n))
