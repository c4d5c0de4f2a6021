"""The CUDA kernels of the FFT hot path, each beside its plain PyTorch
version, and the whole-transform compositions built on them.

The counterpart of the reference's ``ops/pallas_fft.py``.  Two kernels
(``csrc/``, built by ``utils.buildlib``) carry the main path:

* ``tile_fft`` — the tile-point DIF of independent rows in shared
  memory (replaces ``_tile_fft_kernel`` / ``_tile_fft_compute``);
* ``long_range_sep`` — the first log2(R) DIF levels of (…, R, C) views,
  twiddles rebuilt from separable factors (replaces
  ``_long_range_kernel_sep``).

Each wrapper checks device, dtype, shape and contiguity, launches its
kernel for CUDA tensors (or raises) and counts the launch on its
``launches`` attribute; a CPU tensor goes to the plain version, which is
also the yardstick the kernel is held against on the card.

Blocking follows Hopper's budget, not the TPU's 16 MB scoped VMEM: a
block may opt into 227 KB (232,448 bytes) of shared memory, so a tile
of re+im float32 holds at most 2^14 points, and a long-range block
R x cb at most 29,056 points.  Shapes past that fail before any launch
with a ValueError naming the limiting pair.
"""

from __future__ import annotations

import torch

from .bits import ilog2, is_power_of_two, to_natural
from .butterfly import stage_full
from .twiddle import device_factors, device_tables, flat_tables

LANE = 128
#: largest row ``rows`` serves, as in the reference (pallas_fft.py:2067)
MAX_ROW_TILE = 1 << 16
#: dynamic shared memory one block may opt into on sm_90
SMEM_LIMIT_BYTES = 232448
#: largest tile whose re+im float32 planes fit one block's shared memory
MAX_SMEM_TILE = 1 << 14
#: long-range column block: one warp reads 32 neighbouring floats of a row
DEFAULT_CB = 32
_MAX_BLOCKS = (1 << 31) - 1


def tile_smem_bytes(tile: int) -> int:
    return 2 * tile * 4


def long_range_smem_bytes(R: int, cb: int) -> int:
    return 2 * R * cb * 4


def check_tile(tile: int) -> None:
    """Raise ValueError unless `tile` is a power of two >= 2 whose planes
    fit one block's shared memory."""
    if tile < 2 or not is_power_of_two(tile):
        raise ValueError(f"tile={tile} must be a power of two >= 2")
    if tile_smem_bytes(tile) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"tile={tile} needs {tile_smem_bytes(tile)} bytes of shared "
            f"memory per block (limit {SMEM_LIMIT_BYTES}); the largest "
            f"shared-memory tile is {MAX_SMEM_TILE}")


def check_long_range(R: int, cb: int) -> None:
    """Raise ValueError unless the R x cb long-range block is legal."""
    if cb < 1 or not is_power_of_two(cb):
        raise ValueError(f"cb={cb} must be a power of two")
    if long_range_smem_bytes(R, cb) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"long-range blocks R={R} x cb={cb} need "
            f"{long_range_smem_bytes(R, cb)} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); reduce cb or use a larger tile "
            f"so R shrinks")


def rql_blocking(n: int, tile: int | None = None, cb: int | None = None):
    """Validated (tile, R, cb) for an n-point rql transform.  tile
    defaults to min(n, MAX_SMEM_TILE); cb to DEFAULT_CB, halved until
    the R x cb block fits shared memory."""
    if tile is None:
        tile = min(n, MAX_SMEM_TILE)
    check_tile(tile)
    if n % tile:
        raise ValueError(f"tile={tile} must divide n={n}")
    R = n // tile
    if cb is None:
        cb = min(DEFAULT_CB, tile)
        while cb > 1 and long_range_smem_bytes(R, cb) > SMEM_LIMIT_BYTES:
            cb //= 2
    if tile % cb:
        raise ValueError(f"cb={cb} must divide tile={tile}")
    if R > 1:
        check_long_range(R, cb)
    return tile, R, cb


def rows_plan_feasible(nrows: int, n: int) -> bool:
    """Can ``fft_rows_cuda`` serve a (nrows, n)-row workload?  The same
    n range as the reference (power-of-two 128..2^16); the reference's
    Mosaic block-grouping rule has no Hopper counterpart, so any row
    count is feasible."""
    return nrows >= 1 and is_power_of_two(n) and LANE <= n <= MAX_ROW_TILE


# --- shared operand checks and launch -------------------------------------


def _check_planes(xr, xi, ndim: int, name: str) -> None:
    for t in (xr, xi):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: planes must be tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: planes must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    if xr.shape != xi.shape or xr.dim() != ndim:
        raise ValueError(f"{name}: re/im planes must share one {ndim}-D "
                         f"shape, got {tuple(xr.shape)} / "
                         f"{tuple(xi.shape)}")


def _check_operands(name, device, *tensors_and_shapes) -> None:
    for t, shape in tensors_and_shapes:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != device:
            raise ValueError(f"{name}: operand on {t.device}, planes on "
                             f"{device}")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    if device.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {device} — the kernel "
                           f"runs on CUDA tensors, the plain version on "
                           f"CPU tensors")
    from ..utils.buildlib import load_kernels

    lib = load_kernels()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    err = getattr(lib, fn)(*ptrs, index, stream)
    if err != 0:
        msg = lib.pifft_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg})")


# --- kernel 1: tile_fft -----------------------------------------------------


def tile_fft_plain(xr, xi, twr, twi):
    """Plain version of ``tile_fft``: log2(tile) ``stage_full`` levels
    over the same flat tables."""
    tile = xr.shape[-1]
    for l in range(ilog2(tile)):
        off = tile - (tile >> l)
        half = tile >> (l + 1)
        xr, xi = stage_full(xr, xi, twr[off:off + half], twi[off:off + half])
    return xr, xi


def tile_fft(xr, xi, twr, twi):
    """pi-layout DIF of each row of (rows, tile) float32 planes.

    twr/twi: the (tile - 1,) concatenated per-level tables of
    ``twiddle_tables(tile)`` (``twiddle.flat_tables``).  CUDA tensors
    launch the kernel (csrc/tile_fft.cu); CPU tensors take
    ``tile_fft_plain``.  Returns new (rows, tile) planes."""
    _check_planes(xr, xi, 2, "tile_fft")
    rows, tile = xr.shape
    check_tile(tile)
    _check_operands("tile_fft", xr.device,
                    (twr, (tile - 1,)), (twi, (tile - 1,)))
    if xr.device.type == "cpu":
        return tile_fft_plain(xr, xi, twr, twi)
    if rows > _MAX_BLOCKS:
        raise ValueError(f"tile_fft: {rows} rows exceed the grid limit")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if rows:
        _launch("tile_fft", "pifft_tile_fft", xr.device,
                xr, xi, yr, yi, twr, twi, rows, ilog2(tile))
        tile_fft.launches += 1
    return yr, yi


tile_fft.launches = 0


# --- kernel 2: long_range_sep ----------------------------------------------


def long_range_sep_plain(xr, xi, ar, ai, br, bi):
    """Plain version of ``long_range_sep``: the log2(R) levels as
    reshape/stack stages, twiddle = outer product A[o:o+half] x B[l]."""
    B_, R, C = xr.shape
    for l in range(ilog2(R)):
        half = R >> (l + 1)
        o = R - (R >> l)
        a_r = ar[o:o + half, None]
        a_i = ai[o:o + half, None]
        b_r, b_i = br[l], bi[l]
        wr = a_r * b_r - a_i * b_i  # (half, C)
        wi = a_r * b_i + a_i * b_r
        x4r = xr.reshape(B_, -1, 2, half, C)
        x4i = xi.reshape(B_, -1, 2, half, C)
        tr = x4r[:, :, 0] + x4r[:, :, 1]
        ti = x4i[:, :, 0] + x4i[:, :, 1]
        dr = x4r[:, :, 0] - x4r[:, :, 1]
        di = x4i[:, :, 0] - x4i[:, :, 1]
        ur = dr * wr - di * wi
        ui = dr * wi + di * wr
        xr = torch.stack((tr, ur), dim=2).reshape(B_, R, C)
        xi = torch.stack((ti, ui), dim=2).reshape(B_, R, C)
    return xr, xi


def long_range_sep(xr, xi, ar, ai, br, bi, cb: int = DEFAULT_CB):
    """First log2(R) DIF levels of each transform of (batch, R, C)
    float32 planes (n = R*C each), twiddles rebuilt from the separable
    factors of ``twiddle.long_range_factors(R, C)`` (A (R-1,), B
    (levels, C) — ``twiddle.device_factors``).  CUDA tensors launch the
    kernel (csrc/long_range.cu) in column blocks of `cb`; CPU tensors
    take ``long_range_sep_plain``.  Returns new planes."""
    _check_planes(xr, xi, 3, "long_range_sep")
    batch, R, C = xr.shape
    if R < 2 or not is_power_of_two(R):
        raise ValueError(f"long_range_sep: R={R} must be a power of two "
                         f">= 2")
    check_long_range(R, cb)
    if C % cb:
        raise ValueError(f"cb={cb} must divide C={C}")
    levels = ilog2(R)
    _check_operands("long_range_sep", xr.device,
                    (ar, (R - 1,)), (ai, (R - 1,)),
                    (br, (levels, C)), (bi, (levels, C)))
    if xr.device.type == "cpu":
        return long_range_sep_plain(xr, xi, ar, ai, br, bi)
    if batch * (C // cb) > _MAX_BLOCKS:
        raise ValueError("long_range_sep: batch x C/cb exceeds the grid "
                         "limit")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if batch:
        _launch("long_range_sep", "pifft_long_range_sep", xr.device,
                xr, xi, yr, yi, ar, ai, br, bi, batch, levels, C,
                ilog2(cb))
        long_range_sep.launches += 1
    return yr, yi


long_range_sep.launches = 0


def reset_launch_counts() -> None:
    tile_fft.launches = 0
    long_range_sep.launches = 0


# --- compositions -----------------------------------------------------------


def fft_pi_layout_cuda_rql(xr, xi, tile: int | None = None,
                           cb: int | None = None):
    """pi-layout n-point DIF of every length-n row of (..., n) planes:
    ``long_range_sep`` on the (rows, R, tile) view (skipped when R = 1),
    then ``tile_fft`` on the (rows * R, tile) view — two launches, no
    copy between them (the reference's rql, pallas_fft.py:742, batched
    over leading axes).  Validates tile/cb before any launch."""
    n = xr.shape[-1]
    tile, R, cb = rql_blocking(n, tile, cb)
    lead = xr.shape[:-1]
    dev = xr.device
    xr = xr.contiguous()
    xi = xi.contiguous()
    if R > 1:
        ar, ai, br, bi = device_factors(R, tile, dev)
        xr, xi = long_range_sep(xr.reshape(-1, R, tile),
                                xi.reshape(-1, R, tile),
                                ar, ai, br, bi, cb)
    twr, twi = flat_tables(tile, dev)
    yr, yi = tile_fft(xr.reshape(-1, tile), xi.reshape(-1, tile), twr, twi)
    return yr.reshape(*lead, n), yi.reshape(*lead, n)


def fft_rows_cuda(xr, xi, natural: bool = True):
    """FFT of every length-n row of (..., n) float planes, n a power of
    two in 128..2^16 (the reference's fft_rows_pallas, l.2070).  Rows up
    to MAX_SMEM_TILE are one ``tile_fft`` launch; rows of 2^15 and 2^16
    run as a per-row rql (``long_range_sep`` then ``tile_fft``).
    `natural=False` returns pi layout (per-row bit-reversed)."""
    n = xr.shape[-1]
    if n < LANE or n > MAX_ROW_TILE or not is_power_of_two(n):
        raise ValueError(
            f"fft_rows_cuda needs power-of-two {LANE} <= n <= "
            f"{MAX_ROW_TILE}, got {n}")
    yr, yi = fft_pi_layout_cuda_rql(xr, xi)
    return to_natural(yr, yi) if natural else (yr, yi)


def tube_cuda(sr, si, n: int, p: int):
    """Tube phase on the kernels: the segment-local s-point DIF of the
    trailing axis of (..., s) planes, s = n/p.  Levels log2(p).. of the
    n-point plan are a standalone s-point plan (W_{n>>(k+l)} =
    W_{s>>l}), so each segment is one rql transform.  Segments shorter
    than 128 take the stage tube, as the reference's tube_pallas does."""
    from ..models.pi_fft import tube

    if sr.shape[-1] < LANE:
        return tube(sr, si, n, p)
    return fft_pi_layout_cuda_rql(sr, si)


def pi_fft_pi_layout_cuda(xr, xi, p: int):
    """The pi-FFT (funnel + tube) with the tube on the kernels — the
    reference's pi_fft_pi_layout_pallas (l.2169).  Below a 128-point
    segment the whole transform takes the stage path, as there."""
    from ..models.pi_fft import funnel, pi_fft_pi_layout

    n = xr.shape[-1]
    if n // p < LANE:
        return pi_fft_pi_layout(xr, xi, p)
    fr, fi = funnel(xr, xi, p, device_tables(n, xr.device))
    tr, ti = tube_cuda(fr, fi, n, p)
    return tr.reshape(*xr.shape[:-1], n), ti.reshape(*xi.shape[:-1], n)
